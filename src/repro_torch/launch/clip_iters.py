"""Paper Fig. 9 / App. I.1 as an entry point of the port: the CenteredClip
iteration budget matters, and running to convergence recovers the fixed
point.

    PYTHONPATH=src python -m repro_torch.launch.clip_iters [--d D] \\
        [--device cuda|cpu] [--max-iters N]

The problem is the JAX package's (``benchmarks/bench_fig9_clip_iters.py``):
n = 16 peers, 3 of them attackers sending -10·mu, the 13 honest ones
mu + N(0, I) with ||mu|| = 50, drawn with the port's threefry from the
reference's keys, so the stack equals the JAX one to float32 rounding.
For tau 20 ("weaker") and 5 ("stronger") it prints the reference's lines,
``name,us,derived``:

* ``fig9/tau_*/to_convergence`` — ``centered_clip_to_tol`` to eps 1e-6;
* ``fig9/tau_*/iters=B`` — the fixed budgets B of ``centered_clip``;
* ``fig9/tau_*/warm_start`` — iterations to eps 1e-4 on a drifted stack
  (+0.05·N(0, I)), cold and warm-started from the converged aggregate;
* ``fig9/tau_*/warm_iters=B`` — the fixed budgets on the drifted stack,
  cold and warm;

then ``fig9/tau_*/cap`` (whether a run to tolerance stopped at
``--max-iters``, 3000 as in the reference) and the timing of 20 iterations
at tau 5: on the card, kernel #12 (``kernels.ops.centered_clip_op``) and
its plain version, with CUDA events; on the CPU, the plain version on the
host clock. Every fixed budget goes through ``core.centered_clip.
centered_clip``, so on the card each one launches kernel #12 once; the
runs to tolerance are plain torch on either device. ``--d`` sets the
width (1024 as in the reference; 78,223,360 is ALBERT-large's d).
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.core.centered_clip import centered_clip, centered_clip_to_tol
from repro_torch.core.norms import vector_norm
from repro_torch.kernels import centered_clip as kc
from repro_torch.kernels import ops

TAUS = ((20.0, "weaker"), (5.0, "stronger"))
BUDGETS = (1, 5, 20, 100)
WARM_BUDGETS = (1, 5, 20)
TIMING_ITERS, TIMING_REPS = 20, 5
# kernel #12 launches of one sweep on the card: every fixed budget, cold,
# then cold and warm on the drifted stack, for both taus; then the timed
# calls (one warm-up and TIMING_REPS)
KERNEL_CALLS = len(TAUS) * (len(BUDGETS) + 2 * len(WARM_BUDGETS)) \
    + 1 + TIMING_REPS


def _normal_rows(key, rows, d, device):
    """``normal(key, (rows, d))`` drawn a row at a time (the same bits,
    through the counter offset): at full width one draw of the whole stack
    would hold tens of GB of int64 intermediates."""
    out = torch.empty((rows, d), dtype=torch.float32, device=device)
    for r in range(rows):
        out[r] = prng.normal(key, (1, d), offset=r * d)[0]
    return out


def problem(d=1024, n=16, b=3, device="cpu"):
    """The reference's ``_problem``: (xs (n, d), honest mean (d,))."""
    mu = prng.normal(prng.key(1, device=device), (d,))
    mu = mu / vector_norm(mu) * 50.0
    honest = mu + _normal_rows(prng.key(2, device=device), n - b, d, device)
    attack = (-10.0 * mu).expand(b, d)
    return torch.cat([honest, attack]), honest.mean(0)


def drift(shape, device="cpu"):
    """The warm-start study's drift, 0.05 · normal(key(5), shape)."""
    return 0.05 * _normal_rows(prng.key(5, device=device), *shape, device)


def _err(v, hm):
    return float(vector_norm(v - hm))


def sweep(xs, hm, xs_drift, max_iters=3000, emit=None):
    """The Fig. 9 measurements on a stack, its honest mean and its drifted
    copy. Returns {label: {...}} with each line's numbers; ``emit(name,
    us, derived)`` receives the reference's lines."""
    emit = emit or (lambda *a: None)
    out = {}
    for tau, label in TAUS:
        name = f"fig9/tau_{label}"
        ref, iters = centered_clip_to_tol(xs, tau, eps=1e-6,
                                          max_iters=max_iters)
        err_conv = _err(ref, hm)
        emit(f"{name}/to_convergence", 0.0,
             f"iters={iters};err={err_conv:.3f}")
        res = {"iters": iters, "err": err_conv, "budgets": {}, "warm": {}}
        for budget in BUDGETS:
            err = _err(centered_clip(xs, tau, n_iters=budget), hm)
            res["budgets"][budget] = err
            emit(f"{name}/iters={budget}", 0.0,
                 f"err={err:.3f};excess_vs_converged={err - err_conv:.3f}")
        _, it_cold = centered_clip_to_tol(xs_drift, tau, eps=1e-4,
                                          max_iters=max_iters)
        _, it_warm = centered_clip_to_tol(xs_drift, tau, eps=1e-4,
                                          max_iters=max_iters, v0=ref)
        res["iters_cold"], res["iters_warm"] = it_cold, it_warm
        emit(f"{name}/warm_start", 0.0,
             f"iters_cold={it_cold};iters_warm={it_warm};"
             f"cut={1.0 - it_warm / max(it_cold, 1):.2f}")
        for budget in WARM_BUDGETS:
            err_c = _err(centered_clip(xs_drift, tau, n_iters=budget), hm)
            err_w = _err(centered_clip(xs_drift, tau, n_iters=budget, v0=ref),
                         hm)
            res["warm"][budget] = (err_c, err_w)
            emit(f"{name}/warm_iters={budget}", 0.0,
                 f"err_cold={err_c:.3f};err_warm={err_w:.3f}")
        res["capped"] = {k: res[k] >= max_iters
                         for k in ("iters", "iters_cold", "iters_warm")}
        emit(f"{name}/cap", 0.0, f"max_iters={max_iters};" + ";".join(
            f"{k}_capped={v}" for k, v in res["capped"].items()))
        out[label] = res
    return out


def _event_ms(fn, reps):
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call."""
    fn()
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


def timing(xs, emit):
    """20 iterations at tau 5: kernel #12 and its plain version with CUDA
    events on the card; the plain version on the host clock on the CPU.
    Returns {line name: microseconds}."""
    d = xs.shape[1]
    plain = lambda: kc.centered_clip_plain(  # noqa: E731
        xs, [5.0] * TIMING_ITERS)
    if xs.is_cuda:
        times = {
            "fig9/cuda_kernel_clip_20it": 1e3 * _event_ms(
                lambda: ops.centered_clip_op(xs, 5.0, n_iters=TIMING_ITERS),
                TIMING_REPS),
            "fig9/plain_torch_clip_20it": 1e3 * _event_ms(plain, 3),
        }
        derived = f"d={d};{torch.cuda.get_device_name(xs.device)}"
    else:
        plain()
        t0 = time.perf_counter()
        plain()
        times = {"fig9/plain_cpu_clip_20it":
                 1e6 * (time.perf_counter() - t0)}
        derived = f"d={d};cpu"
    for name, us in times.items():
        emit(name, us, derived)
    return times


def _print_line(name, us, derived=""):
    print(f"{name},{us:.1f},{derived}", flush=True)


def run(d=1024, device=None, max_iters=3000, emit=_print_line):
    """Build the problem on ``device`` (cuda unless told otherwise), run
    the sweep and the timing. Returns (sweep results, timing)."""
    device = resolve_device(device)
    xs, hm = problem(d, device=device)
    xs_drift = xs + drift(xs.shape, device)
    results = sweep(xs, hm, xs_drift, max_iters=max_iters, emit=emit)
    del xs_drift
    return results, timing(xs, emit)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=1024,
                    help="gradient width (1024 as in the reference)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=3000,
                    help="cap of the runs to tolerance (3000 as in the "
                         "reference)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.d, args.device, args.max_iters)


if __name__ == "__main__":
    main()
