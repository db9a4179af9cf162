"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line:
  1. the card (name and power limit from nvidia-smi) and the build of the
     CUDA kernels from ``src/repro_torch/kernels/csrc``, with its time;
  2. every kernel against its plain PyTorch version on the card, at the
     slice's shapes (4 peers x 4 partitions of full-width ALBERT-large) and
     a ragged small shape, tau in {1, inf}, with zero weights: within
     rtol = atol = 1e-5 per element and 1e-5 of each output's largest value,
     bitwise equal over two runs, timed with CUDA events;
  3. the main path: ``repro_torch.launch.train_byzantine`` on full-width
     ALBERT-large (bf16 storage, d = 78,223,360), 4 peers, one sign-flip
     attacker, 2 validators, 5 clip iterations, seq 128, batch 4, 6 steps;
  4. the other branches at full width, 3 steps each: the adaptive
     warm-started spec (kernels #3 and #2) and the aggregator attack
     (kernels #4 and #2);
  5. the launches of every kernel per path.

Before the last line it prints the card's name and power limit and a JSON
object with each kernel's numbers; the last line is the device record.
Any failed check raises, so the script exits non-zero; without a CUDA
device it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

RTOL = ATOL = 1e-5  # the JAX package's kernel tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
CLIP_ITERS = 5
SOURCE = "src/repro_torch/kernels/csrc/centered_clip.cu"
TPU_KERNELS = "src/repro/kernels/centered_clip.py"
KERNELS = {  # wrapper's launch-count name -> the TPU kernel it replaces
    "butterfly_clip_fused": f"{TPU_KERNELS}:446",
    "verify_tables_batched": f"{TPU_KERNELS}:1173",
    "adaptive_clip_step": f"{TPU_KERNELS}:641",
    "butterfly_clip": f"{TPU_KERNELS}:211",
}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=5):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def max_rel_err(a, b):
    """The largest error of each output over that output's largest
    reference value, maximised over the outputs."""
    return max(float((x.float() - y.float()).abs().max())
               / max(float(y.float().abs().max()), 1e-30)
               for x, y in zip(a, b))


def close(a, b):
    """Per element within rtol = atol = 1e-5, and each output's largest
    error within 1e-5 of its largest value: at full width the aggregate's
    elements are ~1e-4, where a fixed atol of 1e-5 alone would pass an
    error of several percent."""
    return (all(torch.allclose(x.float(), y.float(), rtol=RTOL, atol=ATOL)
                for x, y in zip(a, b))
            and max_rel_err(a, b) <= RTOL)


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_cases(grads, n_parts, tau, weights, gen):
    """(name, kernel call, plain call, bound bytes, operations, moved
    bytes) per kernel. Bound bytes read each input once and write each
    output once; moved bytes are what the kernels' passes read and write
    per call at CLIP_ITERS iterations: the stack once per pass, v (or agg)
    read in every pass and written in every update, z in the table pass,
    and the copy of v0 that each wrapper starts from (partial-sum buffers
    left out)."""
    from repro_torch.kernels import centered_clip as kc

    n, d = grads.shape
    part = kc.part_len(d, n_parts)
    dev = grads.device
    z = torch.randn((n_parts, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    scale = 0.1 / math.sqrt(part)  # aggregates of norm ~0.1
    agg = scale * torch.randn((n_parts, part), generator=gen, device=dev)
    v0 = scale * torch.randn((n_parts, part), generator=gen, device=dev)
    taus = [tau] * CLIP_ITERS
    nd, pd, it = n * d, n_parts * part, CLIP_ITERS
    tbl = 2 * n * n_parts * 4
    return [
        ("butterfly_clip_fused",
         lambda: kc.butterfly_clip_fused(grads, n_parts, taus, z, None,
                                         weights, v0),
         lambda: kc.butterfly_clip_fused_plain(grads, n_parts, taus, z, None,
                                               weights, v0),
         (nd + 3 * pd) * 4 + tbl, nd * (6 * it + 6),
         ((it + 2) * nd + (2 + 1 + 2 * it + 2) * pd) * 4 + tbl),
        ("verify_tables_batched",
         lambda: kc.verify_tables_batched(grads, n_parts, agg, z, tau),
         lambda: kc.verify_tables_batched_plain(grads, n_parts, agg, z, tau),
         (nd + 2 * pd) * 4 + tbl, nd * 6, (nd + 2 * pd) * 4 + tbl),
        ("adaptive_clip_step",
         lambda: kc.butterfly_clip_adaptive(grads, n_parts, tau, 1e-4,
                                            it, weights, v0),
         lambda: kc.butterfly_clip_adaptive_plain(grads, n_parts, tau, 1e-4,
                                                  it, weights, v0),
         (nd + 2 * pd) * 4, nd * (6 * it + 3),
         # + each partition's iterations: a frozen one skips its pass
         lambda out: ((nd + 3 * pd)
                      + int(out[1].sum()) * (n + 2) * part) * 4),
        ("butterfly_clip",
         lambda: kc.butterfly_clip(grads, n_parts, taus, weights, v0),
         lambda: kc.butterfly_clip_plain(grads, n_parts, taus, weights, v0),
         (nd + 2 * pd) * 4, nd * 7 * it,
         (2 * it * nd + (2 + 3 * it) * pd) * 4),
    ]


def stack(n, d, gen, dev):
    """Peer gradients with partition norms near 1 and one outlier peer."""
    part = -(-d // n)
    g = torch.randn((n, d), generator=gen, device=dev) / math.sqrt(part)
    g[-1] *= 10.0
    return g


def phase_kernels(dev):
    from repro_torch.kernels import centered_clip as kc

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d_full = 78_223_360
    shapes = [(4, d_full, 4), (5, 5 * 1001 - 3, 5), (4, 4 * 517 - 3, 4)]
    stats = {}
    for n, d, n_parts in shapes:
        grads = stack(n, d, gen, dev)
        for tau in (1.0, math.inf):
            for weights in (None, torch.tensor([1.0] * (n - 2) + [0.0, 1.0],
                                               device=dev)):
                full = d == d_full and tau == 1.0 and weights is None
                for name, kern, plain, nbytes, ops, moved in kernel_cases(
                        grads, n_parts, tau, weights, gen):
                    out1 = as_tuple(kern())
                    out2 = as_tuple(kern())
                    ref = as_tuple(plain())
                    torch.cuda.synchronize()
                    tag = (f"{name} n={n} d={d} tau={tau} "
                           f"zero_weights={weights is not None}")
                    check(bitwise(out1, out2), f"{tag}: not bitwise repeatable")
                    err, rel = max_err(out1, ref), max_rel_err(out1, ref)
                    check(close(out1, ref), f"{tag}: disagrees with plain, "
                          f"max abs err {err:.3e}, relative {rel:.3e}")
                    st = stats.setdefault(name, {"max_abs_err": 0.0,
                                                 "max_rel_err": 0.0})
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st["max_rel_err"] = max(st["max_rel_err"], rel)
                    if full:
                        st["ms"] = time_ms(kern)
                        st["plain_ms"] = time_ms(plain, reps=3)
                        st["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                                          >= ops / F32_FLOPS_PER_S
                                          else "operations")
                        st["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                                   ops / F32_FLOPS_PER_S)
                        st["bytes"] = nbytes
                        st["moved_bytes"] = (moved(out1) if callable(moved)
                                             else moved)
                        if name == "adaptive_clip_step":
                            st["iters"] = int(out1[1].max())
                        print(f"phase 2: {name} at n={n} part={-(-d // n)}: "
                              f"{st['ms']:.3f} ms (plain {st['plain_ms']:.3f}"
                              f" ms, bound {st['bound_ms']:.3f} ms by "
                              f"{st['bound_by']}; moves "
                              f"{st['moved_bytes']} bytes, "
                              f"{st['moved_bytes'] / st['ms'] / 1e9:.3f} TB/s)"
                              f", max abs err {err:.3e}, relative {rel:.3e}",
                              flush=True)
        del grads
        torch.cuda.empty_cache()
    print("phase 2: kernels #1-#4 agree with their plain versions within "
          f"rtol=atol={RTOL:g} (max relative error "
          f"{max(st['max_rel_err'] for st in stats.values()):.3e}) and "
          "repeat bitwise "
          f"({len(shapes)} shapes x tau {{1, inf}} x weights)", flush=True)
    kc.reset_launch_counts()
    return stats


# ---------------------------------------------------------------------------
# Phases 3-4: the training paths at full width
# ---------------------------------------------------------------------------
def step_breakdown(tr):
    """Seconds of the parts of one more training step (host clock around
    synchronized work): one peer's batch, the n peers' gradients, the
    protocol step, the unit directions z inside it, and the optimizer."""
    from repro_torch.core import butterfly as bf
    from repro_torch.core import engine as eng
    from repro_torch.core import prng

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ecfg, st = tr.engine_config, tr.state
    _, batch_s = timed(lambda: tr.batch_fn(0, st.step, False))
    flips = eng.flip_mask(ecfg, st, tr.byz_mask)
    (G, H), grads_s = timed(lambda: tr._grads_fn()(tr.params, st.step, flips))
    seed_key = prng.key(123, device=tr.device)  # on the card, as the step's
    _, z_s = timed(lambda: bf.get_random_directions(seed_key, ecfg.n_parts,
                                                    ecfg.part))
    (tr.state, out), proto_s = timed(
        lambda: eng.protocol_step(ecfg, st, tr.byz_mask, G, H))
    del G, H
    (upd, tr._opt_state), opt_s = timed(
        lambda: tr.opt.update(out.g_hat, tr._opt_state, tr.params, st.step))
    return {"batch_one_peer": batch_s, "grads_all_peers": grads_s,
            "protocol_step": proto_s, "z_draw_in_protocol": z_s,
            "optimizer": opt_s}


def run_path(label, argv, attack=None, expect=(), breakdown=False):
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import train_byzantine as tb

    args = tb.build_parser().parse_args(argv)
    if attack is not None:
        attack = AttackConfig(kind=args.attack, delay=5, **attack)
    kc.reset_launch_counts()
    tr, summary, seconds = tb.run_model(args, attack=attack)
    torch.cuda.synchronize()
    counts = dict(kc.LAUNCHES)
    byz = set(summary["byzantine"])
    check(summary["d"] == 78_223_360, f"{label}: d = {summary['d']}")
    check(all(math.isfinite(r["grad_norm"]) for r in tr.history),
          f"{label}: non-finite grad norm")
    check(not summary["honest_accused"],
          f"{label}: honest peers accused {summary['honest_accused']}")
    check(set(summary["banned"]) <= byz,
          f"{label}: banned {summary['banned']} not within {sorted(byz)}")
    for name in expect:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    print(f"{label}: median step {statistics.median(seconds):.3f} s over "
          f"{len(seconds)} steps {[round(s, 4) for s in seconds]}; "
          f"launches {counts}", flush=True)
    if breakdown:
        parts = step_breakdown(tr)
        print(f"{label}: one more step, seconds by part "
              + json.dumps({k: round(v, 4) for k, v in parts.items()}),
              flush=True)
    del tr
    torch.cuda.empty_cache()
    return summary, counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    lib = build.compile_library(verbose=True)
    build.load()
    print(f"phase 1: {card}; built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    stats = phase_kernels(dev)

    common = ["--model", "albert_large", "--full", "--peers", "4",
              "--byzantine", "1", "--attack", "sign_flip", "--validators",
              "2", "--clip-iters", str(CLIP_ITERS), "--seq", "128",
              "--batch", "4"]
    main_sum, main_counts = run_path(
        "phase 3 (main path)", common + ["--steps", "6"],
        expect=("butterfly_clip_fused",), breakdown=True)
    check(set(main_sum["banned"]) == set(main_sum["byzantine"]),
          f"phase 3: attacker not banned in 6 steps: {main_sum}")
    _, adaptive_counts = run_path(
        "phase 4 (adaptive warm start)",
        common + ["--steps", "3", "--aggregator",
                  "butterfly_clip:warm_start=true,adaptive_tol=1e-4"],
        expect=("adaptive_clip_step", "verify_tables_batched"))
    _, attack_counts = run_path(
        "phase 4 (aggregator attack)", common + ["--steps", "3"],
        attack={"aggregator_attack": True, "aggregator_scale": 5.0},
        expect=("butterfly_clip", "verify_tables_batched"))

    paths = {"main": main_counts, "adaptive": adaptive_counts,
             "aggregator_attack": attack_counts}
    print("phase 5: kernels launched per path: " + json.dumps(paths),
          flush=True)
    home = {"butterfly_clip_fused": "main", "verify_tables_batched":
            "adaptive", "adaptive_clip_step": "adaptive",
            "butterfly_clip": "aggregator_attack"}
    rows = []
    for name, replaces in KERNELS.items():
        st = stats[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "path": home[name],
            "launches": paths[home[name]][name],
            "max_abs_err": st["max_abs_err"],
            "max_rel_err": st["max_rel_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "moved_bytes": st["moved_bytes"],
        })
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
