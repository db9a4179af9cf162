"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --breakdown   # phases 1 and 2b only

Phases, each printing its own line:
  1. the card (name and power limit from nvidia-smi) and the build of the
     CUDA kernels from ``src/repro_torch/kernels/csrc``, with its time;
     the float32 passes' registers, local (spill) bytes and resident CTAs
     per SM with their dynamic shared memory (verified:mean's one pass
     among them, staged at n = 4 and 8, global at 16 and 32), those of the
     two-phase clip's passes (#4, #12) at n = 4, 8 and 16, each body, and
     those of the wire passes (#7, #8);
  2. every kernel against its plain PyTorch version on the card, at the
     slice's shapes (4 peers x 4 partitions of full-width ALBERT-large), two
     ragged small shapes and two past 32 peers (33 and 64 peers, d = 2^20
     + 3: the peer-tiled passes), tau in {1, inf}, with zero weights; the
     digest kernels and the int8/bf16 wire kernels also with an all-zero
     payload (scale 0), and the single-partition launch kernels #10 and
     #11 at the launch owner's (4, d/4) stack (#3, #5 and #7 there too, as
     launch paths (j)-(l) call them): within rtol = atol = 1e-5
     per element and 1e-5 of
     each output's largest value, bitwise equal over two runs, timed with
     CUDA events; the wire kernels give the bits of their float32 twins on
     the dequantized payloads; the sampled-digest kernel (#9, rows out of
     order, tau in {0, 1, inf}, an all-zero payload among the sampled
     partitions) gives the bits of #2 (tau > 0) or #6 (tau = 0) at the
     sampled rows; #12 over each whole (n, d) stack with a warm start,
     float32 (timed at the full-width (4, d)) and bfloat16; #4 at the
     (16, d) stack with 16 partitions (timed); and the streaming-read
     yardstick, torch.sum(0) over the (4, d) stack and the (4, d/4) owner
     stack;
     2b. with ``--breakdown`` only, in place of every other phase: the
     fused clip's passes one by one, #1 at the (4, d) stack and #10 at
     the (4, d/4) owner stack, each pass and each finish timed on its own
     with CUDA events, then the two-phase clip's, #4 at the (4, d) stack
     and #12 at the (16, d) stack, and verified:mean's pass and finish,
     #5 and #8 (int8, bf16) at the (4, d) stack, each on both bodies, and
     the yardstick;
  3. the main path: ``repro_torch.launch.train_byzantine`` on full-width
     ALBERT-large (bf16 storage, d = 78,223,360), 4 peers, one sign-flip
     attacker, 2 validators, 5 clip iterations, seq 128, batch 4, 6 steps;
  4. the other branches at full width, 3 steps each: the adaptive
     warm-started spec (kernels #3 and #2) and the aggregator attack
     (kernels #4 and #2); then the verified:* and compressed:* paths,
     3 steps each with the same peers and attacker: verified:mean (#5),
     verified:trimmed_mean (#6), verified:mean under the aggregator attack
     (#6), compressed:butterfly_clip with int8 payloads (#7) and
     compressed:verified:mean with bf16 payloads (#8); then the flat-cost
     verification paths, driven through ``engine.scan_protocol`` with
     ``EngineConfig(audit_k=1, groups=...)`` for ``staleness_bound`` steps:
     (f) sampled butterfly_clip, 4 peers (#4 and #9 once a step), (g)
     sampled verified:mean under the aggregator attack, 4 peers (#9 once a
     step), (h) hierarchical butterfly with 2 groups of 4 and sampling, 8
     peers (#1 once per group, #6 once for level 2, each step);
  5. the distributed launch path, ``repro_torch.launch.train`` through
     its normal entry point: full-width ALBERT-large over 4 peer ranks as
     threads on the card (``--mesh 4x1``, global batch 8 x 64 tokens),
     sign-flip attacker 3, tau 1, 4 steps, on (i) butterfly_clip (#10 once
     per rank and step), (j) butterfly_clip warm-started with the adaptive
     budget (#3 once per iteration, #11 once per rank and step), (k)
     verified:mean (#5), (l) compressed:butterfly_clip with int8 payloads
     (#7) and (m) butterfly_clip with 2 groups and audit_k 1 (#10 over
     the (2, d/2) group stacks); each with its exact launch counts, a
     finite loss at every step, the attacker banned within the 4 steps, no
     honest ban, and the seconds by part of one more step;
  6. the §4.1 full-vector baselines at full width through
     ``train_byzantine --defense centered_clip|krum|geometric_median``, 3
     steps each: finite gradient norms, no ban, no kernel launched (a
     non-verifiable spec draws no z and builds no tables), and the seconds
     by part of one more step;
  7. the Fig. 9 sweep, ``repro_torch.launch.clip_iters`` at d =
     78,223,360 (16 peers, 3 attackers at -10 mu): its lines, every fixed
     budget through #12 (``clip_iters.KERNEL_CALLS`` launches), the runs to
     tolerance capped at FIG9_CAP, the 20-iteration timing; then #12 held
     against its plain version at that (16, d) stack and timed, with its
     bound;
  8. the §4.1 toy, ``train_byzantine`` without ``--model`` (the host
     loop), sign flip from step 10, 60 steps: btard with 16 peers (exactly
     peers 9-15 banned, #1 60 launches), with 40 peers (33-39, #1 through
     the peer-tiled passes) and the trusted-server centered_clip (no ban,
     no kernel);
  9. (n) elastic membership through ``engine.scan_protocol`` at full
     width: 6 slots, an honest peer joining vacant slot 0 at step 3, the
     sign-flipping slot 5 banned, leaving at step 6 and rejoining under a
     new key at step 8, 12 steps (#1 once a step): the rejoin banned from
     probation (BAN_SYBIL), both identities on the ban ledger, slot 0
     promoted after 3 clean checks, no honest accusation, and every
     aggregate bit for bit that of a second run, in lockstep on the same
     gradients, where slot 5 never comes back; (o) the paper's §4.2 setup, ``repro_torch.launch.albert_pretrain
     --full --steps 12 --attack-start 4`` (ALBERT-large, vocabulary 512,
     16 peers, 9-15 sign-flipping, lamb(2e-3), tau 2, clip_lambda 20, 40
     iterations, the host loop; #1 once a step), then #1 at its (16, d')
     stack with 40 iterations held against its plain version and timed;
     (p) the crash drill, ``repro_torch.launch.train`` on launch path
     (j)'s spec over 8 steps in chunks of 2 (``--scan-steps 2``), the
     attacker's slot leaving at step 4 and a fresh identity joining it at
     6: A uninterrupted with ``--checkpoint``, B ``--checkpoint-dir D
     --halt-at 4``, C ``--checkpoint-dir D --resume --checkpoint``; B's
     files hold B's state at the halt bit for bit, C's losses, clip
     iterations, bans, SUMMARY, final params, momentum, carry and
     checkpoint file equal A's bit for bit, and #11 launches on B and C
     what A launched over the same steps; the file sizes, save and load
     seconds; (q) the dense-decoder family at full width,
     ``train_byzantine --model qwen3-1.7b --full`` (d = 1,720,574,976,
     the first stack past 2^32 elements), 4 peers, one sign-flip attacker,
     6 steps: #1 exactly once a step, the attacker banned, no honest
     accusation, finite norms, the peak memory, then #1 at that (4, d)
     stack held against its plain version one partition at a time and
     timed (``at_qwen3`` in #1's row); (r) the MoE/MLA family at full
     width: DeepSeek-V2-Lite at its published widths with its depth cut
     to 3 of 27 layers (the dense MLA layer 0 and 2 of the 26 MLA + MoE
     repeats; d = 1,670,135,296) through the same trainer and lines as
     (q), 4 peers, one sign-flip attacker, 6 steps: #1 exactly once a step
     and no other kernel, the attacker banned, no honest accusation,
     finite norms and aux_loss, the peak memory, the step's parts and the
     share of routed tokens capacity dropped at step 0 per MoE layer;
     (s) the RG-LRU family at its published widths: RecurrentGemma-9B
     (RG-LRU width 4096, local attention with window 2048, MQA at head
     dim 256, vocab 256,000) cut to one (RG, RG, LSA) repeat without its
     2-block prefix (d = 1,705,062,400), seq 4096 (4 query blocks of the
     windowed attention, a 12-level scan), batch 1, 6 steps; (t) the
     local-attention family at its published widths: Gemma3-27B (window
     1024, 32 heads with kv 16, QK-norm, vocab 262,144, soft-cap 30) cut
     to one LSA layer (d = 1,822,179,328), seq 2048, batch 1, 3 steps;
     both as (r) through ``run_model``, 4 peers, one sign-flip attacker:
     #1 exactly once a step and no other kernel, the attacker banned at
     the step the reduced model bans at on the CPU, no honest accusation,
     finite losses and norms, the final |g|, the step median, the step's
     parts (the z draw, the gradients), the peak memory beside the card's
     name and power limit; (s) also the memory one RG-LRU mixer's forward
     keeps for its backward at seq 4096; (u) the encoder-decoder family
     whole: Whisper-small (12 encoder and 12 decoder layers, d =
     264,426,240) through ``repro_torch.launch.train``'s normal entry
     point, 4 peer ranks as threads, sign flip on rank 3, tau 1, 4 steps
     at seq 448 (its decoder context), global batch 8, each row's memory
     1500 frames x 768 from the pipeline's extras: #10 exactly once per
     rank and step (16) and no other kernel, a finite loss at every step,
     peer 3 banned, no honest ban, one more step by part, the peak memory;
     then #10 at its owner stack (4, 66,106,560) held against its plain
     version and timed (``at_whisper`` in #10's row);
     (v) gated cross attention at its published widths: Llama-3.2-Vision
     (d_model 4096, 32 heads with kv 8, vocab 128,256, a 7680 -> 4096
     projector, 1600 patches) cut to one (SA, XA) pair (d =
     1,518,358,529), as (s) through ``run_model``, seq 128, batch 4, 6
     steps, ``memory_raw`` from the pipeline's extras: #1 exactly 6 and no
     other kernel, the attacker banned at the step the reduced model bans
     at on the CPU, no honest accusation, finite; then #1 at that (4, d)
     stack (odd: no peer row after the first starts on 16 bytes, so the
     passes take the global body, which it prints) held against its plain
     version one partition at a time and timed (``at_llama_vision`` in
     #1's row);
  10. the launches of every kernel per path (#1's on (q), (r), (s), (t)
     and (v) beside its row: ``launches_qwen3``, ``launches_deepseek``,
     ``launches_recurrentgemma``, ``launches_gemma3``,
     ``launches_llama_vision``; #10's on (u): ``launches_whisper``).

Before the last line it prints the script's wall time, the card's name
and power limit and a JSON object with each kernel's numbers; the last
line is the device record.
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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

RTOL = ATOL = 1e-5  # the JAX package's kernel tolerance
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
CLIP_ITERS = 5
CSRC = "src/repro_torch/kernels/csrc"
TPU_KERNELS = "src/repro/kernels/centered_clip.py"
KERNELS = {  # wrapper's launch-count name -> (TPU kernel it replaces, source)
    "butterfly_clip_fused": (f"{TPU_KERNELS}:446",
                             f"{CSRC}/centered_clip.cu"),
    "verify_tables_batched": (f"{TPU_KERNELS}:1173",
                              f"{CSRC}/centered_clip.cu"),
    "adaptive_clip_step": (f"{TPU_KERNELS}:641", f"{CSRC}/centered_clip.cu"),
    "butterfly_clip": (f"{TPU_KERNELS}:211", f"{CSRC}/centered_clip.cu"),
    "mean_digest_fused": (f"{TPU_KERNELS}:1063",
                          f"{CSRC}/centered_clip.cu"),
    "digest_tables_batched": (f"{TPU_KERNELS}:877",
                              f"{CSRC}/centered_clip.cu"),
    "butterfly_clip_fused_dequant": (f"{TPU_KERNELS}:512", f"{CSRC}/wire.cu"),
    "mean_digest_fused_dequant": (f"{TPU_KERNELS}:1120", f"{CSRC}/wire.cu"),
    "digest_tables_rows": (f"{TPU_KERNELS}:953", f"{CSRC}/centered_clip.cu"),
    "centered_clip_fused": (f"{TPU_KERNELS}:381", f"{CSRC}/centered_clip.cu"),
    "verify_tables": (f"{TPU_KERNELS}:776", f"{CSRC}/centered_clip.cu"),
    "centered_clip": (f"{TPU_KERNELS}:117", f"{CSRC}/centered_clip.cu"),
}
D_FULL = 78_223_360  # ALBERT-large's d
D_QWEN3 = 1_720_574_976  # Qwen3-1.7B's d (the JAX package's param_count)
# DeepSeek-V2-Lite at its published widths with 2 of its 26 MLA + MoE
# repeats beside the dense MLA layer 0 (the JAX package's param_count)
D_DEEPSEEK = 1_670_135_296
DEEPSEEK_REPEATS = 2
D_DEEPSEEK_FULL = 15_706_484_224  # all 26 repeats
# RecurrentGemma-9B at its published widths cut to one (RG, RG, LSA)
# repeat without its (RG, RG) prefix, and Gemma3-27B cut to one LSA layer
# (the JAX package's param_count), beside the whole models'
D_RGEMMA, D_RGEMMA_FULL = 1_705_062_400, 9_396_195_328
D_GEMMA3, D_GEMMA3_FULL = 1_822_179_328, 27_008_335_616
# the step at which the reduced models ban the attacker on the CPU
# (train_byzantine --model gemma3-27b / recurrentgemma-9b --device cpu)
LOCAL_BAN_STEP = 1
# Whisper-small whole (the JAX package's param_count), and Llama-3.2-Vision
# at its published widths cut to one (SA, XA) pair, beside the whole model
D_WHISPER = 264_426_240
D_VISION, D_VISION_FULL = 1_518_358_529, 9_806_614_536
# the step at which the reduced Llama-3.2-Vision bans the attacker on the
# CPU (the engine, 4 peers, seq 128, batch 4, memory_raw from the extras)
VISION_BAN_STEP = 1
# (u): the distributed launcher on Whisper-small uncut, 4 peer ranks, 4
# steps at its decoder context, 2 rows of (448 tokens, 1500 frames) a rank
WHISPER = ["--arch", "whisper-small", "--mesh", "4x1", "--steps", "4",
           "--attack", "sign_flip", "--byzantine", "3", "--tau", "1",
           "--clip-iters", str(CLIP_ITERS), "--seq", "448", "--batch", "8"]
# the Fig. 9 sweep's runs to tolerance at full width are plain torch, ~12
# ms an iteration over the 5 GB stack: capped at the trusted-server
# default instead of the reference's 3000
FIG9_CAP = 200
# the wire codec each dequantizing kernel's path runs (its timed case)
PATH_CODEC = {"butterfly_clip_fused_dequant": "int8",
              "mean_digest_fused_dequant": "bf16"}


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


def timed(fn):
    """(fn(), seconds) on the host clock around synchronized work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


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
    bytes) per kernel; operations and moved bytes may be functions of the
    kernel's output (#3's depend on the iterations each partition took).
    Bound bytes read each input once and write each output once; moved
    bytes are what the kernels' passes read and write
    per call at CLIP_ITERS iterations: the stack once per pass, v (or agg)
    read in every pass and written in every update, z in the table pass,
    and the copy of v0 that the adaptive loop starts from (the fixed
    budgets read v0 in place; partial-sum buffers left out)."""
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
         ((it + 2) * nd + (1 + 2 * it + 2) * pd) * 4 + tbl),
        ("verify_tables_batched",
         lambda: kc.verify_tables_batched(grads, n_parts, agg, z, tau),
         lambda: kc.verify_tables_batched_plain(grads, n_parts, agg, z, tau),
         (nd + 2 * pd) * 4 + tbl, nd * 6, (nd + 2 * pd) * 4 + tbl),
        ("adaptive_clip_step",
         lambda: kc.butterfly_clip_adaptive(grads, n_parts, tau, 1e-4,
                                            it, weights, v0),
         lambda: kc.butterfly_clip_adaptive_plain(grads, n_parts, tau, 1e-4,
                                                  it, weights, v0),
         (nd + 2 * pd) * 4, lambda out: adaptive_ops(nd, n, part, out[1]),
         lambda out: adaptive_moved(nd, pd, n, part, out[1])),
        ("butterfly_clip",
         lambda: kc.butterfly_clip(grads, n_parts, taus, weights, v0),
         lambda: kc.butterfly_clip_plain(grads, n_parts, taus, weights, v0),
         (nd + 2 * pd) * 4, two_phase_ops(nd, it),
         two_phase_moved(n, nd * 4, pd * 4, it, warm=True)),
    ]


def adaptive_ops(nd, n, part, iters):
    """Float32 operations of #3 with these per-partition iterations: 3 an
    element for the prologue's norms, 6 an element of a partition for each
    step it took (the update and the carried norms); a frozen partition's
    step does none."""
    return 3 * nd + 6 * n * part * int(iters.sum())


def adaptive_moved(nd, pd, n, part, iters):
    """Bytes #3 moves per call: the prologue reads the stack and v0 (in
    place), and each partition's step reads its stack and reads and writes
    its v, once per iteration it stepped (a frozen partition's no-op step
    reads neither)."""
    return (nd + pd + int(iters.sum()) * (n + 2) * part) * 4


def two_phase_ops(nd, it):
    """Float32 operations of the two-phase clip (#4, #12) over nd stack
    elements at ``it`` iterations: 3 an element (a subtract and a fused
    multiply-add) for each iteration's norms and 3 for its update, 6 it."""
    return 6 * nd * it


def two_phase_moved(n, stack_bytes, v_bytes, it, warm):
    """Bytes the two-phase clip (#4, #12) moves per call at ``it``
    iterations. Up to 32 peers one read of the stack a pass: the norms'
    prologue and ``it`` updates, v0 read by the prologue and the first
    update when warm, v read and written by the others, (it + 1) S + (2 it
    + 1) V warm, (2 it - 1) V cold. Above 32 peers a norm pass and an
    update an iteration: 2 it S + 3 it V warm, less 2V cold."""
    if n <= 32:
        return (it + 1) * stack_bytes + (2 * it + (1 if warm else -1)) * v_bytes
    return 2 * it * stack_bytes + (3 * it - (0 if warm else 2)) * v_bytes


def digest_and_wire_cases(grads, n_parts, tau, weights, gen):
    """The same tuples for kernels #5-#8 over a stack with an all-zero
    payload, the wire kernels once per codec: (name, codec, kernel call,
    plain call, bound bytes, operations, moved bytes, float32 twin call).
    Bound bytes read each input once (the stack in its wire dtype) and
    write each output once; moved bytes count the passes as in
    ``kernel_cases``; the twin is the float32 kernel on the dequantized
    payloads, which must give the same bits."""
    from repro_torch.core import compression
    from repro_torch.kernels import centered_clip as kc

    n, d = grads.shape
    part = kc.part_len(d, n_parts)
    dev = grads.device
    z = torch.randn((n_parts, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    scale = 0.1 / math.sqrt(part)
    agg = scale * torch.randn((n_parts, part), generator=gen, device=dev)
    v0 = scale * torch.randn((n_parts, part), generator=gen, device=dev)
    taus = [tau] * CLIP_ITERS
    nd, pd, it = n * d, n_parts * part, CLIP_ITERS
    tbl = 2 * n * n_parts * 4
    cases = [
        ("mean_digest_fused", None,
         lambda: kc.mean_digest_fused(grads, n_parts, z, weights),
         lambda: kc.mean_digest_fused_plain(grads, n_parts, z, weights),
         (nd + 2 * pd) * 4 + tbl, nd * 7, (nd + 2 * pd) * 4 + tbl, None),
        ("digest_tables_batched", None,
         lambda: kc.digest_tables_batched(grads, n_parts, agg, z),
         lambda: kc.digest_tables_batched_plain(grads, n_parts, agg, z),
         (nd + 2 * pd) * 4 + tbl, nd * 5, (nd + 2 * pd) * 4 + tbl, None),
    ]
    for codec in ("int8", "bf16"):
        q, sc = compression.quantize_grads(grads, codec, n_parts)
        xd = compression.wire_grads(grads, codec, n_parts)
        b = compression.CODEC_BYTES[codec]
        wire = nd * b + n_parts * n * 4
        cases += [
            ("butterfly_clip_fused_dequant", codec,
             lambda q=q, sc=sc: kc.butterfly_clip_fused_dequant(
                 q, sc, n_parts, taus, z, None, weights, v0),
             lambda q=q, sc=sc: kc.butterfly_clip_fused_dequant_plain(
                 q, sc, n_parts, taus, z, None, weights, v0),
             wire + 3 * pd * 4 + tbl, nd * (7 * it + 8),
             (it + 2) * wire + (2 * it + 3) * pd * 4 + tbl,
             lambda xd=xd: kc.butterfly_clip_fused(xd, n_parts, taus, z,
                                                   None, weights, v0)),
            ("mean_digest_fused_dequant", codec,
             lambda q=q, sc=sc: kc.mean_digest_fused_dequant(
                 q, sc, n_parts, z, weights),
             lambda q=q, sc=sc: kc.mean_digest_fused_dequant_plain(
                 q, sc, n_parts, z, weights),
             wire + 2 * pd * 4 + tbl, nd * 9, wire + 2 * pd * 4 + tbl,
             lambda xd=xd: kc.mean_digest_fused(xd, n_parts, z, weights)),
        ]
    return cases


def rows_cases(grads, n_parts, rows, gen):
    """Kernel #9's cases, one per tau in {0, 1, inf}: (tau, kernel call,
    plain call, bound bytes, operations, moved bytes, twin call), as in
    ``digest_and_wire_cases``. Bound and moved bytes are one pass of the k
    sampled partitions: their n payloads, their rows of agg and z, the
    row ids, and the (k, n) outputs. The twin is the full all-partition
    kernel at the sampled rows (#2 for tau > 0, #6 for tau = 0), whose
    bits #9 must give."""
    from repro_torch.kernels import centered_clip as kc

    n, d = grads.shape
    part = kc.part_len(d, n_parts)
    dev = grads.device
    z = torch.randn((n_parts, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    agg = (0.1 / math.sqrt(part)) * torch.randn((n_parts, part),
                                                generator=gen, device=dev)
    k = len(rows)
    nbytes = (k * n * part + 2 * k * part + k + 2 * k * n) * 4

    def twin(tau):
        if tau > 0:
            full = kc.verify_tables_batched(grads, n_parts, agg, z, tau)
        else:
            full = kc.digest_tables_batched(grads, n_parts, agg, z)
        return tuple(x[rows] for x in full)

    return [(tau,
             lambda tau=tau: kc.digest_tables_rows(grads, n_parts, agg, z,
                                                   rows, tau),
             lambda tau=tau: kc.digest_tables_rows_plain(grads, n_parts, agg,
                                                         z, rows, tau),
             nbytes, k * n * part * 5, nbytes, lambda tau=tau: twin(tau))
            for tau in (0.0, 1.0, math.inf)]


def launch_cases(grads, n_parts, tau, weights, gen):
    """Kernels #10 and #11 at one launch owner's stack: the (n, part)
    contiguous receive buffer of partition 0, as the all_to_all leaves it.
    The same tuples as ``kernel_cases``; the bytes are those of #1 and #2
    at one partition."""
    from repro_torch.kernels import centered_clip as kc

    n, d = grads.shape
    part = kc.part_len(d, n_parts)
    xs = grads[:, :part].contiguous()
    dev = grads.device
    z = torch.randn((part,), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z)
    scale = 0.1 / math.sqrt(part)
    agg = scale * torch.randn((part,), generator=gen, device=dev)
    v0 = scale * torch.randn((part,), generator=gen, device=dev)
    taus = [tau] * CLIP_ITERS
    nd, it = n * part, CLIP_ITERS
    tbl = 2 * n * 4
    return [
        ("centered_clip_fused",
         lambda: kc.centered_clip_fused(xs, taus, z, None, weights, v0),
         lambda: kc.centered_clip_fused_plain(xs, taus, z, None, weights,
                                              v0),
         (nd + 3 * part) * 4 + tbl, nd * (6 * it + 6),
         ((it + 2) * nd + (1 + 2 * it + 2) * part) * 4 + tbl),
        ("verify_tables",
         lambda: kc.verify_tables(xs, agg, z, tau),
         lambda: kc.verify_tables_plain(xs, agg, z, tau),
         (nd + 2 * part) * 4 + tbl, nd * 6, (nd + 2 * part) * 4 + tbl),
    ]


def clip_cases(grads, tau, weights, gen):
    """Kernel #12 over the whole (n, d) stack with a warm start, float32
    and (untimed) bfloat16: (name, tag, kernel call, plain call, bound
    bytes, operations, moved bytes), as in ``kernel_cases``; the passes
    are #4's at one partition, so the bytes are #4's with V = d (S in the
    stack's own dtype)."""
    from repro_torch.kernels import centered_clip as kc

    n, d = grads.shape
    v0 = (0.1 / math.sqrt(d)) * torch.randn((d,), generator=gen,
                                            device=grads.device)
    taus = [tau] * CLIP_ITERS
    nd, it = n * d, CLIP_ITERS
    xb = grads.to(torch.bfloat16)
    return [
        ("centered_clip", "f32",
         lambda: kc.centered_clip(grads, taus, weights, v0),
         lambda: kc.centered_clip_plain(grads, taus, weights, v0),
         (nd + 2 * d) * 4, two_phase_ops(nd, it),
         two_phase_moved(n, nd * 4, d * 4, it, warm=True)),
        ("centered_clip", "bf16",
         lambda: kc.centered_clip(xb, taus, weights, v0),
         lambda: kc.centered_clip_plain(xb, taus, weights, v0),
         nd * 2 + 2 * d * 4, two_phase_ops(nd, it),
         two_phase_moved(n, nd * 2, d * 4, it, warm=True)),
    ]


def stack(n, d, gen, dev):
    """Peer gradients with partition norms near 1 and one outlier peer
    (scaled in place: no second stack)."""
    part = -(-d // n)
    g = torch.randn((n, d), generator=gen, device=dev).div_(math.sqrt(part))
    g[-1] *= 10.0
    return g


def hold(stats, name, tag, kern, plain, nbytes, ops, moved, timed,
         twin=None, phase="phase 2"):
    """Run one kernel case: bitwise repeatable, within tolerance of its
    plain version, bitwise equal to its float32 twin where it has one;
    timed (median of 5 calls) and its bound computed when ``timed``."""
    out1 = as_tuple(kern())
    out2 = as_tuple(kern())
    ref = as_tuple(plain())
    torch.cuda.synchronize()
    check(bitwise(out1, out2), f"{tag}: not bitwise repeatable")
    if name.startswith("adaptive_clip_step"):
        check(torch.equal(out1[1], ref[1]), f"{tag}: iterations "
              f"{out1[1].tolist()}, plain {ref[1].tolist()}")
    err, rel = max_err(out1, ref), max_rel_err(out1, ref)
    check(close(out1, ref), f"{tag}: disagrees with plain, "
          f"max abs err {err:.3e}, relative {rel:.3e}")
    if twin is not None:
        check(bitwise(out1, as_tuple(twin())),
              f"{tag}: not the bits of its twin (the float32 kernel on the "
              "dequantized payloads, or the full-table kernel at the "
              "sampled rows)")
    st = stats.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["max_rel_err"] = max(st["max_rel_err"], rel)
    if not timed:
        return
    ops = ops(out1) if callable(ops) else ops
    st["ms"] = time_ms(kern)
    st["plain_ms"] = time_ms(plain, reps=3)
    st["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= ops / F32_FLOPS_PER_S else "operations")
    st["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                               ops / F32_FLOPS_PER_S)
    st["bytes"] = nbytes
    st["moved_bytes"] = moved(out1) if callable(moved) else moved
    if name.startswith("adaptive_clip_step"):
        st["iters"] = int(out1[1].max())
    print(f"{phase}: {tag}: {st['ms']:.3f} ms (plain {st['plain_ms']:.3f}"
          f" ms, bound {st['bound_ms']:.3f} ms by {st['bound_by']}; moves "
          f"{st['moved_bytes']} bytes, "
          f"{st['moved_bytes'] / st['ms'] / 1e9:.3f} TB/s), max abs err "
          f"{err:.3e}, relative {rel:.3e}", flush=True)


# the side cases a kernel's row carries: stats key suffix -> row key
SIDE_ROWS = {"@16": "at_16_peers", "@owner": "at_owner_stack",
             "@s42": "at_section_4_2", "@q3": "at_qwen3",
             "@lv": "at_llama_vision", "@wh": "at_whisper"}


def fold_side(stats, name, suffix):
    """Fold a timed side case of ``name`` (kept in its own stats row,
    ``name`` + ``suffix``) into ``name``'s row: its errors into the row's
    maxima, its numbers under ``SIDE_ROWS[suffix]``."""
    side, main = stats.pop(name + suffix), stats[name]
    for k in ("max_abs_err", "max_rel_err"):
        main[k] = max(main[k], side[k])
    main[SIDE_ROWS[suffix]] = {k: side[k] for k in (
        "ms", "plain_ms", "bound_ms", "moved_bytes", "body") if k in side}


def owner_cases(stats, gen, dev):
    """#3, #5 and #7 at a launch owner's (4, d/4) stack, as launch paths
    (j), (k) and (l) call them: #3 with a warm start, tau 1, tol 1e-4 and
    the cap of 20 iterations; #5 at one partition, unit weights; #7 over
    the int8 payloads at one partition, cold, 5 iterations. Held against
    plain (#7 also bit for bit against #1 on the dequantized payloads) and
    timed, under ``at_owner_stack``."""
    from repro_torch.core import compression
    from repro_torch.kernels import centered_clip as kc

    n, part = 4, D_FULL // 4
    xs = stack(n, D_FULL, gen, dev)[:, :part].contiguous()
    scale = 0.1 / math.sqrt(part)
    v0 = scale * torch.randn((1, part), generator=gen, device=dev)
    z = torch.randn((1, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z)
    nd, pd, cap = n * part, part, 20
    hold(stats, "adaptive_clip_step@owner",
         f"adaptive_clip_step owner stack n={n} part={part} cap={cap}",
         lambda: kc.butterfly_clip_adaptive(xs, 1, 1.0, 1e-4, cap, None, v0),
         lambda: kc.butterfly_clip_adaptive_plain(xs, 1, 1.0, 1e-4, cap,
                                                  None, v0),
         (nd + 2 * pd) * 4, lambda out: adaptive_ops(nd, n, part, out[1]),
         lambda out: adaptive_moved(nd, pd, n, part, out[1]), True)
    fold_side(stats, "adaptive_clip_step", "@owner")
    tbl = 2 * n * 4
    hold(stats, "mean_digest_fused@owner",
         f"mean_digest_fused owner stack n={n} part={part}",
         lambda: kc.mean_digest_fused(xs, 1, z),
         lambda: kc.mean_digest_fused_plain(xs, 1, z),
         (nd + 2 * pd) * 4 + tbl, nd * 7, (nd + 2 * pd) * 4 + tbl, True)
    fold_side(stats, "mean_digest_fused", "@owner")
    q, sc = compression.quantize_grads(xs, "int8", 1)
    xd = compression.wire_grads(xs, "int8", 1)
    taus = [1.0] * CLIP_ITERS
    wire, it = nd + n * 4, CLIP_ITERS
    hold(stats, "butterfly_clip_fused_dequant@owner",
         f"butterfly_clip_fused_dequant int8 owner stack n={n} part={part}",
         lambda: kc.butterfly_clip_fused_dequant(q, sc, 1, taus, z),
         lambda: kc.butterfly_clip_fused_dequant_plain(q, sc, 1, taus, z),
         wire + 2 * pd * 4 + 2 * n * 4, nd * (7 * it + 8),
         (it + 2) * wire + (2 * it + 1) * pd * 4 + 2 * n * 4, True,
         lambda: kc.butterfly_clip_fused(xd, 1, taus, z))
    fold_side(stats, "butterfly_clip_fused_dequant", "@owner")
    del xs, q, xd
    torch.cuda.empty_cache()


def phase_kernels(dev):
    from repro_torch.kernels import centered_clip as kc

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the slice's stack, two small ragged ones, and two past 32 peers (the
    # peer-tiled passes of every kernel)
    shapes = [(4, D_FULL, 4), (5, 5 * 1001 - 3, 5), (4, 4 * 517 - 3, 4),
              (33, 2**20 + 3, 33), (64, 2**20 + 3, 64)]
    stats, other = {}, {}  # other[codec]: the codec a path does not run
    for n, d, n_parts in shapes:
        grads = stack(n, d, gen, dev)
        zero_payload = grads.clone()
        zero_payload[1, :kc.part_len(d, n_parts)] = 0.0  # int8 scale 0
        for tau in (1.0, math.inf):
            for weights in (None, torch.tensor([1.0] * (n - 2) + [0.0, 1.0],
                                               device=dev)):
                full = d == D_FULL and tau == 1.0 and weights is None
                label = (f"n={n} d={d} tau={tau} "
                         f"zero_weights={weights is not None}")
                for name, kern, plain, nbytes, ops, moved in (
                        kernel_cases(grads, n_parts, tau, weights, gen)
                        + launch_cases(grads, n_parts, tau, weights, gen)):
                    hold(stats, name, f"{name} {label}", kern, plain,
                         nbytes, ops, moved, full)
                for name, tag, kern, plain, nbytes, ops, moved in clip_cases(
                        grads, tau, weights, gen):
                    hold(stats, name, f"{name} {tag} {label}", kern, plain,
                         nbytes, ops, moved, full and tag == "f32")
                for (name, codec, kern, plain, nbytes, ops, moved,
                     twin) in digest_and_wire_cases(zero_payload, n_parts,
                                                    tau, weights, gen):
                    own = (stats if codec in (None, PATH_CODEC.get(name))
                           else other.setdefault(codec, {}))
                    hold(own, name, f"{name} {codec or 'f32'} {label}", kern,
                         plain, nbytes, ops, moved, full, twin)
        # #9 over the sampled partitions (out of order), one of them with
        # an all-zero payload; timed at the sampled flagship's tau = 1
        rows = [n_parts - 1, 1] if d == D_FULL else [n_parts - 1, 0, 2]
        part = kc.part_len(d, n_parts)
        if d == D_FULL:
            yardstick((("(4, d)", grads),
                       ("(4, d/4) owner", grads[:, :part].contiguous())))
        zero_payload[1, rows[-1] * part:(rows[-1] + 1) * part] = 0.0
        for tau, kern, plain, nbytes, ops, moved, twin in rows_cases(
                zero_payload, n_parts, rows, gen):
            hold(stats, "digest_tables_rows",
                 f"digest_tables_rows n={n} d={d} rows={rows} tau={tau}",
                 kern, plain, nbytes, ops, moved,
                 d == D_FULL and tau == 1.0, twin)
        del grads, zero_payload
        torch.cuda.empty_cache()
    # #4 at the (16, d) stack read as 16 partitions (the paper's 16 peers:
    # the two-phase clip's staged body), timed
    n = n_parts = 16
    grads = stack(n, D_FULL, gen, dev)
    part = kc.part_len(D_FULL, n_parts)
    v0 = (0.1 / math.sqrt(part)) * torch.randn((n_parts, part), generator=gen,
                                               device=dev)
    taus = [1.0] * CLIP_ITERS
    nd, pd = n * D_FULL, n_parts * part
    hold(stats, "butterfly_clip@16",
         f"butterfly_clip n={n} d={D_FULL} P={n_parts} tau=1.0",
         lambda: kc.butterfly_clip(grads, n_parts, taus, None, v0),
         lambda: kc.butterfly_clip_plain(grads, n_parts, taus, None, v0),
         (nd + 2 * pd) * 4, two_phase_ops(nd, CLIP_ITERS),
         two_phase_moved(n, nd * 4, pd * 4, CLIP_ITERS, warm=True), True)
    fold_side(stats, "butterfly_clip", "@16")
    del grads, v0
    torch.cuda.empty_cache()
    owner_cases(stats, gen, dev)
    keep = ("ms", "plain_ms", "bound_ms", "moved_bytes")
    for name, codec in PATH_CODEC.items():
        stats[name]["by_codec"] = {codec: {k: stats[name][k] for k in keep}}
    for codec, side in other.items():
        for name, st in side.items():
            main = stats[name]
            for k in ("max_abs_err", "max_rel_err"):
                main[k] = max(main[k], st[k])
            main["by_codec"][codec] = {k: st[k] for k in keep}
    print("phase 2: kernels #1-#12 agree with their plain versions within "
          f"rtol=atol={RTOL:g} (max relative error "
          f"{max(st['max_rel_err'] for st in stats.values()):.3e}), repeat "
          "bitwise, the wire kernels equal their float32 twins on the "
          "dequantized payloads bit for bit, the sampled-digest kernel "
          "equals #2/#6 at the sampled rows bit for bit, and #3's "
          "iterations equal plain's exactly "
          f"({len(shapes)} shapes {[s[:2] for s in shapes]} x tau {{1, inf}} "
          "(#9 also 0) x weights x codecs {int8, bf16}; #12 over f32 and "
          "bf16 stacks; #4 also at (16, d) with 16 partitions; #3, #5 and "
          "#7 also at a launch owner's (4, d/4) stack)", flush=True)
    kc.reset_launch_counts()
    return stats


# ---------------------------------------------------------------------------
# Diagnostics of the fused clip (#1, #10): the passes' resources and times
# ---------------------------------------------------------------------------
# cc_pass_info's codes (csrc/centered_clip.cu)
PASS_INFO = ((0, "sq pass"), (1, "update with norms"), (2, "dot pass"),
             (3, "dot pass with norms"), (4, "verified:mean pass"),
             (5, "finish weights"), (6, "finish tables"),
             (8, "update with norms and dv"))
# (n, vec) of the float32 passes' report: the staged body (vec 2) at 4 and
# 8 peers, the 16-byte loads' body (vec 1) and the column-by-column body
# at 4, groups of one column at 16 and 32
FLOAT32_BODIES = ((4, 2), (4, 1), (4, 0), (8, 2), (16, 0), (32, 0))
# the two-phase clip's passes (#4, #12)
TWO_PHASE_INFO = ((9, "prologue"), (7, "update with next norms"),
                  (10, "last update"))
# (n, vec) of the two-phase passes' report: the staged body (vec) and the
# global body at 4 and 16 peers, the staged body at 8
TWO_PHASE_BODIES = ((4, 1), (4, 0), (8, 1), (16, 1), (16, 0))
# wire_pass_info's codes (csrc/wire.cu): the passes of #7 and #8's pass
WIRE_PASS_INFO = ((0, "sq pass"), (1, "update with norms"), (2, "dot pass"),
                  (3, "dot pass with norms"), (4, "verified:mean pass"))
# (n, vec) of the wire passes' report: the staged body (vec 2) at 4 and 8
# peers, the 16-byte loads' global body (vec 1) at 4, groups of one column
# at 16 and 32
WIRE_BODIES = ((4, 2), (4, 1), (8, 2), (16, 0), (32, 0))


def print_pass_info():
    """Registers, local (spill) bytes, resident CTAs per SM and dynamic
    shared memory of the float32 passes, as the build made them, at each
    (n, vec) of ``FLOAT32_BODIES`` (the main path's instantiations are the
    staged ones at n = 4; #3's step is the update with norms and dv, #5's
    the verified:mean pass); then the two-phase clip's passes at each (n,
    body) of ``TWO_PHASE_BODIES``; then the wire passes (#7, #8) at int8
    and bf16 at each (n, vec) of ``WIRE_BODIES``."""
    import ctypes

    from repro_torch.kernels import build

    lib = build.load("centered_clip")
    out = (ctypes.c_int * 4)()
    for n, vec in FLOAT32_BODIES:
        parts = []
        for code, what in PASS_INFO:
            if code in (5, 6) and (n, vec) != (4, 2):
                continue  # the finishes depend on neither n nor the body
            check(lib.cc_pass_info(code, n, vec, out) == 0,
                  f"pass info of {what} at n={n} vec={vec}")
            parts.append(f"{what} {out[0]} regs, {out[1]} local bytes, "
                         f"{out[2]} CTAs/SM, {out[3]} B dynamic shared")
        body = {2: "staged", 1: "16-byte loads", 0: "column by column"}[vec]
        print(f"phase 1: float32 passes at n={n} vec={vec} ({body}): "
              + "; ".join(parts), flush=True)
    for n, vec in TWO_PHASE_BODIES:
        parts = []
        for code, what in TWO_PHASE_INFO:
            check(lib.cc_pass_info(code, n, vec, out) == 0,
                  f"pass info of the two-phase {what} at n={n} vec={vec}")
            parts.append(f"{what} {out[0]} regs, {out[1]} local bytes, "
                         f"{out[2]} CTAs/SM, {out[3]} B dynamic shared")
        body = "staged" if out[3] else "global"
        print(f"phase 1: two-phase clip passes at n={n} vec={vec} "
              f"({body}): " + "; ".join(parts), flush=True)
    wire = build.load("wire")
    for dtype, codec in ((1, "int8"), (2, "bf16")):
        for n, vec in WIRE_BODIES:
            parts = []
            for code, what in WIRE_PASS_INFO:
                check(wire.wire_pass_info(dtype, code, n, vec, out) == 0,
                      f"wire pass info of {what} at {codec} n={n} vec={vec}")
                parts.append(f"{what} {out[0]} regs, {out[1]} local bytes, "
                             f"{out[2]} CTAs/SM, {out[3]} B dynamic shared")
            body = "staged" if vec == 2 else "global"
            print(f"phase 1: {codec} wire passes at n={n} vec={vec} "
                  f"({body}): " + "; ".join(parts), flush=True)


class _Timed:
    """Stands in for a built library: every launcher call is bracketed by
    CUDA events, recorded as (function, start, end) in ``log``."""

    def __init__(self, lib, log):
        self.lib, self.log = lib, log

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.log.append((name.split("_", 1)[1], start, end))
            return rc
        return launch


def yardstick(stacks):
    """The streaming-read rate of the card: torch.sum(0) over each
    (label, float32 stack), a memory rate printed beside the kernels and
    not a counterpart of any."""
    for label, xs in stacks:
        t = time_ms(lambda xs=xs: xs.sum(0))
        nbytes = (xs.numel() + xs.shape[1]) * 4
        print(f"phase 2 yardstick: torch.sum(0) over the {label} float32 "
              f"stack {t:.3f} ms, {nbytes / t / 1e9:.3f} TB/s (reads the "
              "stack once, writes one row)", flush=True)


def off16(xs):
    """A copy of the stack stored one element past a 16-byte boundary, a
    row stride of d + 1: the wrappers send it to the bodies that load
    from global memory column by column (the two-phase clip's global body,
    and that of the norm, update and dot passes)."""
    big = torch.empty((xs.shape[0], xs.shape[1] + 1), dtype=xs.dtype,
                      device=xs.device)
    big[:, 1:].copy_(xs)
    return big[:, 1:]


def off_stage(xs):
    """A copy of a wire stack stored 4 elements past a 16-byte boundary,
    with a row stride of d + 4: every row start on a group of 4 elements
    but none on 16 bytes, so the wire passes take their global body with
    4-element loads instead of the staged one."""
    big = torch.empty((xs.shape[0], xs.shape[1] + 4), dtype=xs.dtype,
                      device=xs.device)
    big[:, 4:].copy_(xs)
    return big[:, 4:]


def host_synchronous_adaptive():
    """The loop #3 ran before it was decided on the card, the host reading
    max ||dv||^2 before every iteration, as the card tests hold it
    (``tests/test_torch_cuda.py``)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_cuda import _host_synchronous_adaptive

    return _host_synchronous_adaptive


def pass_breakdown(dev):
    """#10 at one launch owner's (4, d/4) stack; #3 at the (4, d) stack
    (cap 5) and at the owner stack (cap 20), the whole call against the
    sum of its passes; then on both bodies, aligned (the staged body) and
    off 16 bytes (the global body): #1, #4 and #5 at the (4, d) stack (4
    partitions) and #12 at Fig. 9's (16, d) stack, one element off (a row
    stride of d + 1: column by column), #7 and #8 over the int8 and bf16
    payloads of the (4, d) stack, 4 elements off with a row stride of d +
    4 (the 4-element loads), and #7 and #3 at 8 peers over (8, d/2); 5
    iterations at tau 1 with a warm start, through the public wrappers
    with the libraries behind a timing stand-in: every pass and every
    finish timed on its own with CUDA events around its launch, median
    over 3 calls after one warm-up; every call's output held against the
    plain version, and the global body's bits equal to the staged body's.
    Then #3 against the host-synchronous loop it replaces
    (``host_synchronous_adaptive``) at both stacks, each timed whole
    (median of 5 calls), the same bits; then the streaming-read
    yardstick."""
    from repro_torch.core import compression
    from repro_torch.kernels import build
    from repro_torch.kernels import centered_clip as kc

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    P = 4
    grads = stack(4, D_FULL, gen, dev)
    part = kc.part_len(D_FULL, P)
    owner = grads[:, :part].contiguous()
    taus = [1.0] * CLIP_ITERS
    z = torch.randn((P, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    v0 = (0.1 / math.sqrt(part)) * torch.randn((P, part), generator=gen,
                                               device=dev)
    cases = [("centered_clip_fused", "#10", owner, 1,
              lambda: kc.centered_clip_fused(owner, taus, z[0], None, None,
                                             v0[0]),
              lambda: kc.centered_clip_fused_plain(owner, taus, z[0], None,
                                                   None, v0[0])),
             # the adaptive loop: the gap between its passes is the whole
             # call less their sum
             ("butterfly_clip_adaptive", "#3", grads, P,
              lambda: kc.butterfly_clip_adaptive(grads, P, 1.0, 1e-4,
                                                 CLIP_ITERS, None, v0),
              lambda: kc.butterfly_clip_adaptive_plain(
                  grads, P, 1.0, 1e-4, CLIP_ITERS, None, v0)),
             ("butterfly_clip_adaptive", "#3 at the owner stack, cap 20",
              owner, 1,
              lambda: kc.butterfly_clip_adaptive(owner, 1, 1.0, 1e-4, 20,
                                                 None, v0[:1]),
              lambda: kc.butterfly_clip_adaptive_plain(owner, 1, 1.0, 1e-4,
                                                       20, None, v0[:1]))]
    real, log = build.load, []
    build.load = lambda name="centered_clip": _Timed(real(name), log)

    def run(name, tag, xs, n_parts, kern, plain):
        ref = as_tuple(plain())
        runs, whole = [], []
        for _ in range(4):
            log.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = as_tuple(kern())
            end.record()
            torch.cuda.synchronize()
            check(close(out, ref), f"breakdown {tag}: disagrees with plain")
            runs.append([t0.elapsed_time(t1) for _, t0, t1 in log])
            whole.append(start.elapsed_time(end))
        # the adaptive loop may enqueue a different number of frozen
        # no-op iterations from call to call: the launches all took
        launched = [len(r) for r in runs[1:]]
        whats = [w for w, _, _ in log][:min(launched)]
        ms = [statistics.median(r[i] for r in runs[1:])
              for i in range(len(whats))]
        n = xs.shape[0]
        geo = kc.chunk_grid(n, xs.shape[1], n_parts)
        nd, pd = xs.numel() * xs.element_size(), n_parts * geo.part * 4
        # a two-phase clip pass's rate is that of its median pass, an update
        moved = {"sq_pass": nd + pd, "update": nd + 2 * pd,
                 "dot_pass": nd + 2 * pd, "clip_pass": nd + 2 * pd,
                 "mean_dot_pass": nd + 2 * pd}

        def show(what):
            t = [m for w, m in zip(whats, ms) if w == what]
            # a frozen partition's no-op step (a twentieth of a step's
            # time) moves nothing: the rate is that of the steps that did
            moving = [m for m in t if m >= max(t) / 4]
            rate = (f" ({moved[what] / statistics.median(moving) / 1e9:.3f}"
                    " TB/s)" if what in moved else "")
            return f"{what} {' '.join(f'{x:.3f}' for x in t)} ms" + rate

        print(f"phase 2 breakdown: {name} ({tag}) n={n} d={xs.shape[1]} "
              f"P={n_parts} chunk={geo.cs} C={geo.C}: "
              + "; ".join(show(w) for w in dict.fromkeys(whats))
              + f"; parts sum to {sum(ms):.3f} ms, whole call "
              f"{statistics.median(whole[1:]):.3f} ms (events between "
              f"launches; launches a call {launched})", flush=True)
        return out

    try:
        for case in cases:
            run(*case)
        g16 = stack(16, D_FULL, gen, dev)
        v16 = (0.1 / math.sqrt(D_FULL)) * torch.randn(D_FULL, generator=gen,
                                                      device=dev)
        bodies = [
            ("butterfly_clip_fused", "#1", grads, P,
             lambda xs: kc.butterfly_clip_fused(xs, P, taus, z, None, None,
                                                v0),
             lambda: kc.butterfly_clip_fused_plain(grads, P, taus, z, None,
                                                   None, v0), off16),
            ("butterfly_clip", "#4", grads, P,
             lambda xs: kc.butterfly_clip(xs, P, taus, None, v0),
             lambda: kc.butterfly_clip_plain(grads, P, taus, None, v0),
             off16),
            ("centered_clip", "#12", g16, 1,
             lambda xs: kc.centered_clip(xs, taus, None, v16),
             lambda: kc.centered_clip_plain(g16, taus, None, v16), off16),
            ("mean_digest_fused", "#5", grads, P,
             lambda xs: kc.mean_digest_fused(xs, P, z),
             lambda: kc.mean_digest_fused_plain(grads, P, z), off16)]
        for codec in ("int8", "bf16"):
            q, sc = compression.quantize_grads(grads, codec, P)
            bodies += [(
                "butterfly_clip_fused_dequant", f"#7 {codec}", q, P,
                lambda xs, sc=sc: kc.butterfly_clip_fused_dequant(
                    xs, sc, P, taus, z, None, None, v0),
                lambda q=q, sc=sc: kc.butterfly_clip_fused_dequant_plain(
                    q, sc, P, taus, z, None, None, v0), off_stage), (
                "mean_digest_fused_dequant", f"#8 {codec}", q, P,
                lambda xs, sc=sc: kc.mean_digest_fused_dequant(xs, sc, P, z),
                lambda q=q, sc=sc: kc.mean_digest_fused_dequant_plain(
                    q, sc, P, z), off_stage)]
        # 8 peers over 8 partitions of (8, d/2), the bytes of (4, d): the
        # staged body at its largest peer count
        g8 = stack(8, D_FULL // 2, gen, dev)
        part8 = kc.part_len(D_FULL // 2, 8)
        v8 = (0.1 / math.sqrt(part8)) * torch.randn((8, part8), generator=gen,
                                                    device=dev)
        z8 = torch.randn((8, part8), generator=gen, device=dev)
        z8 = z8 / torch.linalg.vector_norm(z8, dim=1, keepdim=True)
        for codec in ("int8", "bf16"):
            q, sc = compression.quantize_grads(g8, codec, 8)
            bodies.append((
                "butterfly_clip_fused_dequant", f"#7 {codec} at 8 peers", q, 8,
                lambda xs, sc=sc: kc.butterfly_clip_fused_dequant(
                    xs, sc, 8, taus, z8, None, None, v8),
                lambda q=q, sc=sc: kc.butterfly_clip_fused_dequant_plain(
                    q, sc, 8, taus, z8, None, None, v8), off_stage))
        bodies.append((
            "butterfly_clip_adaptive", "#3 at 8 peers", g8, 8,
            lambda xs: kc.butterfly_clip_adaptive(xs, 8, 1.0, 1e-4,
                                                  CLIP_ITERS, None, v8),
            lambda: kc.butterfly_clip_adaptive_plain(g8, 8, 1.0, 1e-4,
                                                     CLIP_ITERS, None, v8),
            off16))
        for name, tag, xs, n_parts, kern, plain, shift in bodies:
            staged = run(name, f"{tag}, staged body", xs, n_parts,
                         lambda: kern(xs), plain)
            off = shift(xs)
            flat = run(name, f"{tag}, global body", off, n_parts,
                       lambda: kern(off), plain)
            check(all(torch.equal(a, b) for a, b in zip(staged, flat)),
                  f"breakdown {tag}: the global body's bits are not the "
                  "staged body's")
            del off
    finally:
        build.load = real
        kc.reset_launch_counts()
    host_loop = host_synchronous_adaptive()
    for label, xs, n_parts, v, cap in (("(4, d)", grads, P, v0, CLIP_ITERS),
                                       ("(4, d/4) owner", owner, 1, v0[:1],
                                        20)):
        host = host_loop(xs, n_parts, 1.0, 1e-4, cap, None, v)
        card = kc.butterfly_clip_adaptive(xs, n_parts, 1.0, 1e-4, cap, None,
                                          v)
        check(bitwise(host, card), f"breakdown #3 {label}: the loop decided "
              "on the card is not the host loop's bits")
        t_host = time_ms(lambda: host_loop(xs, n_parts, 1.0, 1e-4, cap, None,
                                           v))
        t_card = time_ms(lambda: kc.butterfly_clip_adaptive(
            xs, n_parts, 1.0, 1e-4, cap, None, v))
        print(f"phase 2 breakdown: #3 at the {label} stack, cap {cap} "
              f"({int(card[1].max())} iterations): decided on the card "
              f"{t_card:.3f} ms, the host-synchronous loop {t_host:.3f} ms "
              "(the same bits)", flush=True)
    kc.reset_launch_counts()
    yardstick((("(4, d)", grads), ("(4, d/4) owner", owner)))
    del grads, owner, g16, g8, bodies
    torch.cuda.empty_cache()


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

    ecfg, st = tr.engine_config, tr.state
    _, batch_s = timed(lambda: tr.batch_fn(0, st.step, False))
    flips = eng.flip_mask(ecfg, st, tr.byz_mask)
    (G, H), grads_s = timed(lambda: tr._grads_fn()(tr.params, st.step, flips))
    seed_key = prng.key(123, device=tr.device)  # on the card, as the step's
    _, z_s = timed(lambda: bf.get_random_directions(seed_key, ecfg.n_parts,
                                                    ecfg.part))
    (tr.state, out), proto_s = timed(
        lambda: eng.protocol_step(ecfg, st, tr.byz_mask, G, H, donate=True))
    del G, H
    (upd, tr._opt_state), opt_s = timed(
        lambda: tr.opt.update(out.g_hat, tr._opt_state, tr.params, st.step))
    return {"batch_one_peer": batch_s, "grads_all_peers": grads_s,
            "protocol_step": proto_s, "z_draw_in_protocol": z_s,
            "optimizer": opt_s}


def hold_adaptive(label, launched, iters, cap):
    """#3's launches on a path, one a step enqueued, against ``iters``, the
    most iterations any partition stepped in each call: a call enqueues
    every iteration in which some partition steps, and the frozen no-ops
    after it until the host sees the last partition converge, at most
    ``cap`` in all."""
    check(sum(iters) <= launched <= cap * len(iters),
          f"{label}: {launched} launches of adaptive_clip_step for calls "
          f"that stepped {iters} iterations, cap {cap}")


def run_path(label, argv, attack=None, expect=(), breakdown=False,
             launches=None, bans=True, d=D_FULL, setup=None):
    """Drive one path through the launcher with the launch counts set to 0
    just before and read just after, and the card's peak memory over the
    run (``torch.cuda.max_memory_allocated``) printed; ``d``: the model's
    parameter count the run must report; ``setup``: a function that makes
    the ``(loss_fn, params0, batch_fn, model)`` quadruple the launcher then
    trains in place of the one its flags name (``run_model`` calls it).
    ``expect``: kernels that must have
    launched; ``launches``: the exact count of every kernel that may
    launch, all others 0, and then the attacker must be banned (``bans``)
    or, for a non-verifiable baseline, no one (``bans=False``). Where #3
    launched, its launches are held against the iterations each step's
    call stepped (``hold_adaptive``), which the summary returned lists
    under ``clip_iters``."""
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import train_byzantine as tb

    args = tb.build_parser().parse_args(argv)
    if attack is not None:
        attack = AttackConfig(kind=args.attack, delay=5, **attack)
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launch_counts()
    tr, summary, seconds = tb.run_model(args, attack=attack, setup=setup)
    torch.cuda.synchronize()
    counts = dict(kc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    byz = set(summary["byzantine"])
    check(summary["d"] == d, f"{label}: d = {summary['d']}, expected {d}")
    check(all(math.isfinite(r["grad_norm"]) for r in tr.history),
          f"{label}: non-finite grad norm")
    check(not summary["honest_accused"],
          f"{label}: honest peers accused {summary['honest_accused']}")
    check(set(summary["banned"]) <= byz,
          f"{label}: banned {summary['banned']} not within {sorted(byz)}")
    for name in expect:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    if counts["adaptive_clip_step"]:
        summary = dict(summary, clip_iters=[
            r["clip_iters_used"] for r in tr.history])
        hold_adaptive(label, counts["adaptive_clip_step"],
                      summary["clip_iters"], args.clip_iters)
    if launches is not None:
        want = {name: launches.get(name, 0) for name in counts}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        check(set(summary["banned"]) == (byz if bans else set()),
              f"{label}: bans {summary['banned']}, expected "
              f"{sorted(byz) if bans else []}")
    print(f"{label}: median step {statistics.median(seconds):.3f} s over "
          f"{len(seconds)} steps {[round(s, 4) for s in seconds]}; "
          f"launches {counts}; peak memory {peak / 1e9:.2f} GB", flush=True)
    if breakdown:
        parts = step_breakdown(tr)
        print(f"{label}: one more step, seconds by part "
              + json.dumps({k: round(v, 4) for k, v in parts.items()}),
              flush=True)
    del tr
    torch.cuda.empty_cache()
    return dict(summary, peak_memory=peak), counts


def run_engine_path(label, n, aggregator, attack, launches, groups=None):
    """Drive the engine the way the JAX package's sampled/hierarchical
    tests do: ALBERT-large from ``lm_setup``, per-peer gradients through
    ``engine.device_data_grads_fn``, an ``EngineConfig`` with ``audit_k`` /
    ``groups`` from ``config_from_attack``, ``engine.scan_protocol`` with
    ``sgd`` as the update, one step per call so each is timed, for
    ``staleness_bound(n, m, audit_k)`` steps. The launch counts are set to
    0 just before and read just after. Checks: the attacker (the last peer)
    is banned inside that window, no honest peer is accused or banned,
    every g_hat is finite, every column's audit age stays within the
    bound, and ``launches`` gives the exact count of every kernel (all
    others 0). Returns the launch counts."""
    from repro_torch.core import engine as eng
    from repro_torch.core import hierarchy as hier
    from repro_torch.core.flatten import FlatBoundary, tree_unflatten
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.models.workload import lm_setup
    from repro_torch.optim import apply_updates, sgd

    m, audit_k, device = 2, 1, "cuda"
    loss_fn, params0, batch_fn, _ = lm_setup(
        "albert_large", seq_len=128, batch_size=4, reduced=False,
        device=device)
    boundary = FlatBoundary(params0)
    params = boundary.flatten(params0)
    del params0

    def grad_fn(flat, batch, out=None):
        leaves = [t.detach().requires_grad_(True)
                  for t in boundary.unflatten_leaves(flat)]
        loss = loss_fn(tree_unflatten(boundary.template, leaves), batch)
        return boundary.flatten_leaves(torch.autograd.grad(loss, leaves),
                                       out=out)

    opt = sgd(0.05)

    def update_fn(p, g_hat, t):
        upd, _ = opt.update(g_hat, {}, p, t)
        return apply_updates(p, upd)

    grads_fn = eng.device_data_grads_fn(n, batch_fn, grad_fn)
    cfg = eng.config_from_attack(
        n, boundary.d, AttackConfig(**attack), tau=1.0,
        clip_iters=CLIP_ITERS, m_validators=m, aggregator=aggregator,
        audit_k=audit_k, groups=groups)
    byz = [n - 1]
    byz_mask = torch.tensor([1.0 if i in byz else 0.0 for i in range(n)],
                            device=device)
    bound = hier.staleness_bound(n, m, audit_k)
    state = eng.init_state(cfg, seed=0, device=device)
    seconds, outs = [], []
    kc.reset_launch_counts()
    for _ in range(bound):
        (state, params, out), sec = timed(lambda: eng.scan_protocol(
            cfg, state, byz_mask, params, grads_fn, 1, update_fn))
        seconds.append(sec)
        outs += out
        age = int((state.step - 1 - state.col_checked).max())
        check(age <= bound, f"{label}: audit age {age} > bound {bound}")
    counts = dict(kc.LAUNCHES)
    honest = [i for i in range(n) if i not in byz]
    ban_step = state.ban_step.tolist()
    check(all(0 <= ban_step[i] < bound for i in byz),
          f"{label}: attacker not banned within {bound} steps: {ban_step}")
    check(all(ban_step[i] == -1 for i in honest),
          f"{label}: honest peer banned: {ban_step}")
    for t, out in enumerate(outs):
        check(bool(torch.isfinite(out.g_hat).all()),
              f"{label}: non-finite g_hat at step {t}")
        accused = (out.accuse_mat.any(dim=0) | out.sys_accuse).tolist()
        check(not any(accused[i] for i in honest),
              f"{label}: honest peer accused at step {t}: {accused}")
    want = {name: launches.get(name, 0) * bound for name in counts}
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    print(f"{label}: median step {statistics.median(seconds):.3f} s over "
          f"{len(seconds)} steps (staleness bound) "
          f"{[round(x, 4) for x in seconds]}; attacker banned at step "
          f"{[ban_step[i] for i in byz]}; launches {counts}", flush=True)
    parts = engine_breakdown(cfg, state, byz_mask, params, grads_fn)
    print(f"{label}: one more step, seconds by part "
          + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    del params, state, outs
    torch.cuda.empty_cache()
    return counts


def engine_breakdown(cfg, state, byz_mask, params, grads_fn):
    """Seconds of the parts of one more engine step (host clock around
    synchronized work): the n peers' gradients, the protocol step, and the
    unit-direction draws inside it (z1 and z2 in the hierarchical
    butterfly, z in the flat one)."""
    from repro_torch.core import butterfly as bf
    from repro_torch.core import engine as eng
    from repro_torch.core import hierarchy as hier
    from repro_torch.core import prng

    flips = eng.flip_mask(cfg, state, byz_mask)
    (G, H), grads_s = timed(lambda: grads_fn(params, state.step, flips))
    key = prng.key(123, device=params.device)
    g, gs = hier.group_shape(cfg.n, cfg.groups)
    shapes = [(gs, bf.pad_to_parts(cfg.d, gs) // gs)]
    if g > 1:
        shapes.append((g, bf.pad_to_parts(cfg.d, g) // g))
    z_s = sum(timed(lambda s=s: bf.get_random_directions(key, *s))[1]
              for s in shapes)
    _, proto_s = timed(lambda: eng.protocol_step(cfg, state, byz_mask, G, H))
    return {"grads_all_peers": grads_s, "protocol_step": proto_s,
            "z_draws_in_protocol": z_s}


def run_launch_path(label, argv, launches, d=None):
    """Drive ``repro_torch.launch.train`` through its normal entry point
    (``build_parser`` + ``run``): 4 peer ranks as threads on the card. The
    launch counts are set to 0 just before and read when every rank has
    finished its steps (before the one more step of the breakdown).
    ``launches(record)``: the exact count of every kernel that may launch
    (all others 0), but for #3, whose launches are held against the
    iterations each owner's call stepped (``hold_adaptive``). Checks: a
    finite loss at every step, the attacker banned within the steps, no
    honest peer banned, and the model's parameter count ``d`` where
    given. Prints the card's peak memory over the run. Returns the
    counts."""
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import train as lt

    args = lt.build_parser().parse_args(argv)
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    kc.reset_launch_counts()
    rec = lt.run(args, breakdown=True,
                 on_steps_done=lambda: counts.update(kc.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    if d is not None:
        got = sum(t.numel() for t in tree_leaves(rec["state"]["params"]))
        check(got == d, f"{label}: d = {got}, expected {d}")
    byz = {int(b) for b in args.byzantine.split(",")}
    losses, bans = rec["losses"], rec["ban_steps"]
    check(len(losses) == args.steps and all(map(math.isfinite, losses)),
          f"{label}: losses {losses}")
    check(set(bans) == byz and all(t < args.steps for t in bans.values()),
          f"{label}: attacker not banned within {args.steps} steps: {bans}")
    want = {name: 0 for name in counts}
    want.update(launches(rec))
    if counts["adaptive_clip_step"]:
        hold_adaptive(label, counts["adaptive_clip_step"],
                      [i for step in rec["clip_iters"] for i in step],
                      args.clip_iters)
        want["adaptive_clip_step"] = counts["adaptive_clip_step"]
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    print(f"{label}: median step {statistics.median(rec['seconds']):.3f} s "
          f"over {len(rec['seconds'])} steps "
          f"{[round(x, 4) for x in rec['seconds']]}; losses "
          f"{[round(x, 4) for x in losses]}; bans {bans}; clip iters "
          f"{rec['clip_iters']}; launches {counts}; peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    parts = dict(rec["parts"], whole_step=sum(rec["parts"].values()))
    print(f"{label}: one more step, seconds by part "
          + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    torch.cuda.empty_cache()
    return counts


def run_fig9(label, stats):
    """The Fig. 9 sweep through its entry point at full width (d =
    78,223,360, n = 16, 3 attackers at -10 mu): its lines, each fixed
    budget through kernel #12 (the exact count read from the code,
    ``clip_iters.KERNEL_CALLS``, every other kernel 0), the runs to
    tolerance capped at FIG9_CAP. Checks: every error finite, more
    iterations never worse than one, the warm start never slower than the
    cold one; then, with the counts read, #12 at this path's (16, d)
    stack (20 iterations at tau 5 from a cold start, the timed call) held
    against its plain version and timed as in phase 2, folded into #12's
    row of ``stats`` (``at_16_peers``). Returns the launch counts."""
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import clip_iters

    def emit(name, us, derived):
        print(f"{label}: {name},{us:.1f},{derived}", flush=True)

    torch.cuda.empty_cache()
    kc.reset_launch_counts()
    (res, _), sec = timed(lambda: clip_iters.run(
        D_FULL, "cuda", max_iters=FIG9_CAP, emit=emit))
    counts = dict(kc.LAUNCHES)
    want = {name: 0 for name in counts}
    want["centered_clip"] = clip_iters.KERNEL_CALLS
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    for tau_label, r in res.items():
        errs = ([r["err"]] + list(r["budgets"].values())
                + [e for pair in r["warm"].values() for e in pair])
        check(all(map(math.isfinite, errs)),
              f"{label}: non-finite error at tau {tau_label}: {r}")
        check(r["budgets"][max(r["budgets"])] <= r["budgets"][1],
              f"{label}: more iterations did worse at tau {tau_label}: {r}")
        check(r["iters_warm"] <= r["iters_cold"],
              f"{label}: warm start slower at tau {tau_label}: {r}")
    print(f"{label}: {sec:.1f} s in all; launches {counts}", flush=True)
    torch.cuda.empty_cache()
    xs, _ = clip_iters.problem(D_FULL, device="cuda")
    taus = [5.0] * clip_iters.TIMING_ITERS
    nd = xs.numel()
    hold(stats, "centered_clip@16", f"centered_clip n=16 d={D_FULL} "
         f"{len(taus)} iterations tau=5 cold",
         lambda: kc.centered_clip(xs, taus),
         lambda: kc.centered_clip_plain(xs, taus), (nd + D_FULL) * 4,
         two_phase_ops(nd, len(taus)),
         two_phase_moved(16, nd * 4, D_FULL * 4, len(taus), warm=False), True,
         phase=label)
    fold_side(stats, "centered_clip", "@16")
    print(f"{label}: #12 at the (16, d) stack within rtol=atol={RTOL:g} of "
          f"its plain version and bitwise repeatable (max abs err "
          f"{stats['centered_clip']['max_abs_err']:.3e} over every #12 "
          "case)", flush=True)
    del xs
    torch.cuda.empty_cache()
    return counts


def run_membership_path(label):
    """Elastic membership through ``engine.scan_protocol`` at full width:
    ALBERT-large from ``lm_setup`` as ``run_engine_path`` builds it, 6
    slots, butterfly_clip at CLIP_ITERS iterations, 2 validators; slot 0
    starts vacant and an honest peer joins it at step 3, slot 5
    sign-flips (lam 1) from step 0, leaves at step 6 and rejoins under a
    new key at step 8 (``rejoin_under_new_key``); 3 events, a probation
    window of 3, 12 steps. Beside it, in lockstep, a second run where
    slot 5 never comes back (only the leave) on the same gradients: each
    step's (n, d) stack is computed once, for the first run's parameters,
    and handed to both, since autograd's own sums need not repeat bit for
    bit. The launch counts are set to 0 just before and read just after.
    Checks: slot 5 banned before step 6 and never active after its
    rejoin, which ends in BAN_SYBIL; both of slot 5's identities on the
    identity ban ledger; slot 0 vacant, then in probation, then active
    after 3 clean checks; no honest slot accused or banned; every g_hat
    finite and bit for bit the second run's (so are the parameters); #1
    once a step in each run and no other kernel. Returns the counts."""
    from repro_torch.core import engine as eng
    from repro_torch.core.attacks import rejoin_under_new_key
    from repro_torch.core.engine import (BAN_SYBIL, SLOT_ACTIVE, SLOT_BANNED,
                                         SLOT_PROBATION, SLOT_VACANT)
    from repro_torch.core.flatten import FlatBoundary, tree_unflatten
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.models.workload import lm_setup
    from repro_torch.optim import apply_updates, sgd

    n, byz_slot, steps, device = 6, 5, 12, "cuda"
    loss_fn, params0, batch_fn, _ = lm_setup(
        "albert_large", seq_len=128, batch_size=4, reduced=False,
        device=device)
    boundary = FlatBoundary(params0)
    params = boundary.flatten(params0)
    del params0

    def grad_fn(flat, batch, out=None):
        leaves = [t.detach().requires_grad_(True)
                  for t in boundary.unflatten_leaves(flat)]
        loss = loss_fn(tree_unflatten(boundary.template, leaves), batch)
        return boundary.flatten_leaves(torch.autograd.grad(loss, leaves),
                                       out=out)

    opt = sgd(0.05)

    def update_fn(p, g_hat, t):
        upd, _ = opt.update(g_hat, {}, p, t)
        return apply_updates(p, upd)

    grads_fn = eng.device_data_grads_fn(n, batch_fn, grad_fn)
    stash = []

    def stashing_grads_fn(p, t, flips):
        stash[:] = [grads_fn(p, t, flips)]
        return stash[0]

    cfg = eng.config_from_attack(
        n, boundary.d, AttackConfig(kind="sign_flip", lam=1.0), tau=1.0,
        clip_iters=CLIP_ITERS, m_validators=2, n_events=3, probation_steps=3)
    byz_mask = torch.tensor([1.0 if i == byz_slot else 0.0
                             for i in range(n)], device=device)
    join = [(3, "join", 0)]
    state, gone = (eng.init_state(cfg, seed=0, events=ev, vacant=(0,),
                                  device=device)
                   for ev in (join + rejoin_under_new_key(byz_slot, 6, 8),
                              join + [(6, "leave", byz_slot)]))
    p, p_gone, outs, seconds = params, params, [], []
    kc.reset_launch_counts()
    for t in range(steps):
        (state, p, (out,)), sec = timed(lambda: eng.scan_protocol(
            cfg, state, byz_mask, p, stashing_grads_fn, 1, update_fn))
        seconds.append(sec)
        gone, p_gone, (out_gone,) = eng.scan_protocol(
            cfg, gone, byz_mask, p_gone, lambda *_: stash[0], 1, update_fn)
        check(bool(torch.isfinite(out.g_hat).all()),
              f"{label}: non-finite g_hat at step {t}")
        check(torch.equal(out.g_hat, out_gone.g_hat) and torch.equal(
            p, p_gone), f"{label}: g_hat at step {t} differs from the run "
              f"where slot {byz_slot} never came back")
        outs.append(dict(
            life=out.lifecycle.tolist(), banned=out.banned_now.tolist(),
            reason=out.ban_reason_now.tolist(),
            accused=(out.accuse_mat.any(dim=0) | out.sys_accuse).tolist()))
    stash.clear()
    counts = dict(kc.LAUNCHES)
    want = {name: 0 for name in counts}
    want["butterfly_clip_fused"] = 2 * steps
    check(counts == want, f"{label}: launches {counts}, expected {want} "
          "(two runs)")
    life = [o["life"] for o in outs]
    honest = [i for i in range(n) if i != byz_slot]
    first_id, new_id = byz_slot, int(state.slot_identity[byz_slot])
    id_ban = state.id_ban_step.tolist()
    check(SLOT_BANNED in [row[byz_slot] for row in life[:6]]
          and 0 <= id_ban[first_id] < 6,
          f"{label}: slot {byz_slot} not banned before step 6: {life}")
    check(all(row[byz_slot] != SLOT_ACTIVE for row in life[8:])
          and life[-1][byz_slot] == SLOT_BANNED,
          f"{label}: slot {byz_slot} active again after its rejoin: {life}")
    sybil = [o["reason"][byz_slot] for o in outs[8:] if o["banned"][byz_slot]]
    check(sybil == [BAN_SYBIL], f"{label}: rejoin bans {sybil}")
    check(new_id != first_id and id_ban[new_id] >= 8,
          f"{label}: identities {first_id}, {new_id} not both banned: "
          f"{id_ban}")
    check([row[0] for row in life] == [SLOT_VACANT] * 3
          + [SLOT_PROBATION] * 2 + [SLOT_ACTIVE] * 7,
          f"{label}: slot 0 lifecycle {[row[0] for row in life]}")
    for t, o in enumerate(outs):
        check(not any(o["banned"][i] or o["accused"][i] for i in honest),
              f"{label}: honest slot accused or banned at step {t}: {o}")
    print(f"{label}: median step {statistics.median(seconds):.3f} s over "
          f"{steps} steps {[round(x, 4) for x in seconds]}; slot {byz_slot} "
          f"banned at step {id_ban[first_id]}, its new identity {new_id} at "
          f"step {id_ban[new_id]} (BAN_SYBIL); slot 0 active from step 5; "
          "every g_hat and parameter bit for bit the leave-only run's; "
          f"launches {counts} for both runs", flush=True)
    del params, p, p_gone, state, gone
    torch.cuda.empty_cache()
    return counts


def run_section_4_2(label, stats):
    """The paper's §4.2 setup through its entry point,
    ``python -m repro_torch.launch.albert_pretrain --full --steps 12
    --attack-start 4`` (ALBERT-large at full width, vocabulary 512; 16
    peers, 9-15 sign-flipping; lamb(2e-3), tau 2, clip_lambda 20, 40
    iterations, 1 validator; the host loop), with the launch counts set
    to 0 just before and read just after. Checks: a finite eval loss at
    every printed step, every ban inside {9..15} and at least one, no
    honest peer accused, #1 once a step and no other kernel. Then #1 at
    this path's (16, d') stack, 16 partitions, 40 iterations at tau 2
    from a cold start, held against its plain version and timed as in
    phase 2, folded into #1's row of ``stats`` (``at_section_4_2``).
    Returns the launch counts."""
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import albert_pretrain as ap

    args = ap.build_parser().parse_args(
        ["--full", "--steps", "12", "--attack-start", "4"])
    kc.reset_launch_counts()
    tr, rec = ap.run(args)
    torch.cuda.synchronize()
    counts = dict(kc.LAUNCHES)
    byz = set(ap.BYZANTINE)
    losses, final, seconds = (rec["eval_losses"], rec["final_loss"],
                              rec["seconds"])
    check(all(map(math.isfinite, list(losses.values()) + [final])),
          f"{label}: eval losses {losses}, final {final}")
    check(tr.banned and tr.banned <= byz,
          f"{label}: banned {sorted(tr.banned)}, expected a non-empty "
          f"subset of {sorted(byz)}")
    accused = set(rec["accused"])
    check(accused <= byz, f"{label}: honest peers accused {accused - byz}")
    want = {name: 0 for name in counts}
    want["butterfly_clip_fused"] = args.steps
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    d = tr.d
    print(f"{label}: d' = {d}; median step {statistics.median(seconds):.3f}"
          f" s over {len(seconds)} steps {[round(x, 4) for x in seconds]}; "
          f"banned {len(tr.banned)} of {len(byz)} {sorted(tr.banned)}; final "
          f"eval loss {final:.4f}; launches {counts}", flush=True)
    del tr
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(42)
    n = n_parts = ap.PEERS
    grads = stack(n, d, gen, "cuda")
    part = kc.part_len(d, n_parts)
    z = torch.randn((n_parts, part), generator=gen, device="cuda")
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    taus, it = [2.0] * 40, 40
    nd, pd, tbl = n * d, n_parts * part, 2 * n * n_parts * 4
    hold(stats, "butterfly_clip_fused@s42",
         f"butterfly_clip_fused n={n} d={d} P={n_parts} {it} iterations "
         "tau=2 cold",
         lambda: kc.butterfly_clip_fused(grads, n_parts, taus, z),
         lambda: kc.butterfly_clip_fused_plain(grads, n_parts, taus, z),
         (nd + 2 * pd) * 4 + tbl, nd * (6 * it + 6),
         ((it + 2) * nd + (2 * it + 1) * pd) * 4 + tbl, True, phase=label)
    fold_side(stats, "butterfly_clip_fused", "@s42")
    del grads, z
    torch.cuda.empty_cache()
    return counts


QWEN3 = ["--model", "qwen3-1.7b", "--full", "--peers", "4", "--byzantine",
         "1", "--attack", "sign_flip", "--validators", "2", "--clip-iters",
         str(CLIP_ITERS), "--seq", "128", "--batch", "4", "--steps", "6"]


def fused_cold_bound(n, d, n_parts, it):
    """#1's bound on an (n, d) stack in ``n_parts`` partitions, ``it``
    iterations from a cold start: the stack, z and v each once and the
    tables written, or 6 it + 6 float32 operations an element; and the
    bytes its design moves (``it`` + 2 reads of the stack, 2 it + 1
    passes over v and z)."""
    from repro_torch.kernels.centered_clip import part_len

    nd, pd = n * d, n_parts * part_len(d, n_parts)
    tbl = 2 * n * n_parts * 4
    nbytes, ops = (nd + 2 * pd) * 4 + tbl, nd * (6 * it + 6)
    return {"bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_FLOPS_PER_S else "operations"),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  ops / F32_FLOPS_PER_S),
            "moved_bytes": ((it + 2) * nd + (2 * it + 1) * pd) * 4 + tbl}


def run_qwen3(label, stats):
    """(q) the dense-decoder family at full width: ``train_byzantine
    --model qwen3-1.7b --full`` (d = 1,720,574,976, bf16 storage, float32
    flat master params; 4 peers, sign flip on peer 3, 2 validators, 5 clip
    iterations, seq 128, batch 4, 6 steps) through ``run_path``: #1 exactly
    once a step and no other kernel, the attacker banned, no honest peer
    accused or banned, finite norms, the peak memory, the step median and
    one more step by part. Then #1 at this path's (4, d) stack
    (``fused_at_path``), held against its plain version, folded into #1's
    row of ``stats`` (``at_qwen3``). Returns the launch counts."""
    _, counts = run_path(label, QWEN3, breakdown=True,
                         launches={"butterfly_clip_fused": 6}, d=D_QWEN3)
    fused_at_path(label, D_QWEN3, 24, stats, "@q3")
    return counts


def owner_clip_at(label, stats, d, suffix):
    """#10 at a launch path's owner stack, the (4, d/4) receive buffer of
    one partition (d the model's), as the launcher's owner calls it (tau
    1, a cold start, CLIP_ITERS iterations): held against its plain
    version and timed (``hold``), folded into #10's row under
    ``SIDE_ROWS[suffix]``."""
    from repro_torch.kernels import centered_clip as kc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    part = kc.part_len(d, 4)
    xs = stack(4, part, gen, "cuda")
    z = torch.randn((part,), generator=gen, device="cuda")
    z.div_(torch.linalg.vector_norm(z))
    taus = [1.0] * CLIP_ITERS
    nd, it, tbl = 4 * part, CLIP_ITERS, 2 * 4 * 4
    hold(stats, "centered_clip_fused" + suffix,
         f"centered_clip_fused at the owner stack (4, {part}) {it} "
         "iterations tau=1 cold",
         lambda: kc.centered_clip_fused(xs, taus, z),
         lambda: kc.centered_clip_fused_plain(xs, taus, z),
         (nd + 2 * part) * 4 + tbl, nd * (6 * it + 6),
         ((it + 2) * nd + (2 * it + 1) * part) * 4 + tbl, True, phase=label)
    fold_side(stats, "centered_clip_fused", suffix)
    del xs, z
    torch.cuda.empty_cache()


# the body #1's norm, update and dot passes take (``_Stack.body``)
BODIES = {0: "global, column by column", 1: "global, 16-byte loads",
          2: "staged"}


def fused_at_path(label, d, seed, stats=None, suffix=None):
    """#1 at a path's (4, d) stack as the path calls it (4 partitions,
    tau 1, a cold start, CLIP_ITERS iterations): repeated bit for bit and
    timed, with the body its passes take. With ``stats``, also held
    against its plain version one partition at a time (each partition's
    clip and tables read only its own columns, the last zero-padded to
    the partition's length, as ``stacked`` pads; the plain version's
    temporaries for the whole stack would not fit beside it) and the
    plain version timed so, folded into #1's row of ``stats`` under
    ``SIDE_ROWS[suffix]``; the kernel's outputs wait on the host, so the
    plain version's temporaries have room on the card. Returns the
    numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels import centered_clip as kc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = n_parts = 4
    grads = stack(n, d, gen, "cuda")
    part = kc.part_len(d, n_parts)
    z = torch.randn((n_parts, part), generator=gen, device="cuda")
    z.div_(torch.linalg.vector_norm(z, dim=1, keepdim=True))
    taus = [1.0] * CLIP_ITERS

    def kern():
        return kc.butterfly_clip_fused(grads, n_parts, taus, z)

    def plain(j):
        cols = grads[:, j * part:(j + 1) * part]
        cols = F.pad(cols, (0, part - cols.shape[1]))
        return kc.butterfly_clip_fused_plain(cols, 1, taus, z[j:j + 1])

    def plain_all():
        for j in range(n_parts):
            plain(j)

    out = tuple(t.cpu() for t in kern())
    check(bitwise(out, tuple(t.cpu() for t in kern())),
          f"{label}: #1 at (4, d) not bitwise repeatable")
    st = dict(body=BODIES[kc._Stack(grads, n_parts).body],
              **fused_cold_bound(n, d, n_parts, CLIP_ITERS))
    held = ""
    if stats is not None:
        errs, tops, ok = [0.0] * 3, [0.0] * 3, True
        for j in range(n_parts):
            ref = tuple(t.cpu() for t in plain(j))
            for o, (x, y) in enumerate(zip((t[j:j + 1] for t in out), ref)):
                ok = ok and torch.allclose(x, y, rtol=RTOL, atol=ATOL)
                errs[o] = max(errs[o], float((x - y).abs().max()))
                tops[o] = max(tops[o], float(y.abs().max()))
            del ref
        err = max(errs)
        rel = max(e / max(t, 1e-30) for e, t in zip(errs, tops))
        check(ok and rel <= RTOL, f"{label}: #1 at (4, d) disagrees with "
              f"plain, max abs err {err:.3e}, relative {rel:.3e}")
    del out
    st["ms"] = time_ms(kern, reps=3 if stats is None else 5)
    if stats is not None:
        st.update(max_abs_err=err, max_rel_err=rel,
                  plain_ms=time_ms(plain_all, reps=3))
        held = (f"; plain {st['plain_ms']:.3f} ms a partition at a time, "
                f"max abs err {err:.3e}, relative {rel:.3e}")
        stats["butterfly_clip_fused" + suffix] = st
        fold_side(stats, "butterfly_clip_fused", suffix)
    del grads, z
    torch.cuda.empty_cache()
    print(f"{label}: butterfly_clip_fused n={n} d={d} P={n_parts} "
          f"{CLIP_ITERS} iterations tau=1 cold, {st['body']} body: "
          f"{st['ms']:.3f} ms (bound {st['bound_ms']:.3f} ms by "
          f"{st['bound_by']}; moves {st['moved_bytes']} bytes, "
          f"{st['moved_bytes'] / st['ms'] / 1e9:.3f} TB/s){held}",
          flush=True)
    return st


DEEPSEEK = ["--model", "deepseek-v2-lite-16b", "--full", "--peers", "4",
            "--byzantine", "1", "--attack", "sign_flip", "--validators",
            "2", "--clip-iters", str(CLIP_ITERS), "--seq", "128", "--batch",
            "4", "--steps", "6"]


def moe_drop_shares(model, params, batch_fn, peers):
    """The share of routed (token, k) pairs that capacity dropped in each
    MoE layer, over the peers' step-0 batches at ``params``: one forward a
    peer without gradients, with ``moe.route`` wrapped to keep each
    layer's keeps."""
    from repro_torch.models import moe

    route, keeps = moe.route, []

    def recording(p, cfg, x):
        r = route(p, cfg, x)
        keeps.append(r.keeps)
        return r

    moe.route = recording
    try:
        with torch.no_grad():
            for peer in range(peers):
                model.loss_fn(params, batch_fn(peer, 0, False))
    finally:
        moe.route = route
    n_layers = len(keeps) // peers
    return [1.0 - float(torch.stack([keeps[i * n_layers + j].float().mean()
                                     for i in range(peers)]).mean())
            for j in range(n_layers)]


def run_deepseek(label):
    """(r) the MoE/MLA family at full width: DeepSeek-V2-Lite at its
    published widths (MLA with kv_lora_rank 512, 64 routed experts top-6
    at 1408 and 2 shared, vocab 102,400, bf16 storage, float32 flat master
    params), its depth cut to the dense MLA layer 0 and 2 of the 26 MLA +
    MoE repeats (d = 1,670,135,296), through ``train_byzantine --model
    deepseek-v2-lite-16b --full``'s settings (4 peers, sign flip on peer
    3, 2 validators, 5 clip iterations, seq 128, batch 4, 6 steps) with the
    cut model handed to ``run_model``: #1 exactly once a step and no other
    kernel, the attacker banned, no honest peer accused or banned, finite
    norms and a finite ``aux_loss`` in every gradient, the peak memory,
    the step median, one more step by part, and the share of routed
    tokens capacity dropped at step 0 in each MoE layer. Returns the
    launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.workload import model_setup

    cfg = get_config("deepseek-v2-lite-16b")
    cut = dataclasses.replace(cfg, n_repeats=DEEPSEEK_REPEATS)
    model = Model(cut)
    print(f"{label}: {cfg.name} at its published widths, depth cut from "
          f"{cfg.n_layers} layers (dense MLA layer 0 + {cfg.n_repeats} MLA "
          f"+ MoE repeats) to {cut.n_layers} (n_repeats {cfg.n_repeats} -> "
          f"{DEEPSEEK_REPEATS}): the full depth's d = {D_DEEPSEEK_FULL:,} "
          f"would need a {4 * 4 * D_DEEPSEEK_FULL / 1e9:.0f} GB float32 "
          "stack for 4 peers", flush=True)
    aux, drops = [], []

    def loss_fn(params, batch):
        loss, metrics = model.loss_fn(params, batch)
        aux.append(metrics["aux_loss"].detach())
        return loss

    def setup():
        _, params0, batch_fn, _ = model_setup(model, seq_len=128,
                                              batch_size=4, device="cuda")
        drops.extend(moe_drop_shares(model, params0, batch_fn, peers=4))
        return loss_fn, params0, batch_fn, model

    _, counts = run_path(label, DEEPSEEK, breakdown=True,
                         launches={"butterfly_clip_fused": 6}, d=D_DEEPSEEK,
                         setup=setup)
    aux = torch.stack(aux).cpu()
    check(bool(torch.isfinite(aux).all()),
          f"{label}: non-finite aux_loss {aux.tolist()}")
    print(f"{label}: aux_loss over {len(aux)} gradients in "
          f"[{float(aux.min()):.6f}, {float(aux.max()):.6f}], step 0 "
          f"{[round(float(a), 6) for a in aux[:4]]}; routed tokens dropped "
          f"at step 0 by capacity, per MoE layer: {drops}", flush=True)
    torch.cuda.empty_cache()
    return counts


def rglru_kept_bytes(arch, seq):
    """Bytes one RG-LRU mixer of ``arch`` at its published widths keeps for
    the backward after its forward (batch 1 at ``seq``), and its scan
    alone (float32 (1, seq, width) inputs): allocated after the forward
    less before it."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import rglru
    from repro_torch.models.layers import cdtype

    cfg = get_config(arch)
    p = {k: t.requires_grad_(True) for k, t in
         rglru.rglru_init(prng.key(0, device="cuda"), cfg).items()}
    w = cfg.rglru_width or cfg.d_model
    x = torch.randn((1, seq, cfg.d_model), device="cuda",
                    dtype=cdtype(cfg), requires_grad=True)
    log_a = -torch.rand((1, seq, w), device="cuda").requires_grad_(True)
    b = torch.randn((1, seq, w), device="cuda", requires_grad=True)
    kept = []
    for fn in (lambda: rglru.rglru_apply(p, cfg, None, x),
               lambda: rglru.linear_scan(log_a, b)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        kept.append(torch.cuda.memory_allocated() - before)
        del out
    del p, x, log_a, b
    torch.cuda.empty_cache()
    return kept


def run_cut_model(label, arch, cut, d, d_full, seq, steps, card, batch=1,
                  ban_step=LOCAL_BAN_STEP, stats=None, suffix=None):
    """One of (s), (t), (v): ``arch`` at its published widths with its
    depth cut to ``cut(cfg)`` (config fields), through
    ``train_byzantine``'s settings (4 peers, sign flip on peer 3, 2
    validators, 5 clip iterations, ``batch`` rows a peer at ``seq``,
    ``steps`` steps) with the cut model handed to ``run_model``; a model
    with an encoder memory gets its ``memory_raw`` from the pipeline's
    extras, as the launcher feeds it. Checks: #1 exactly once a step and
    no other kernel, the attacker banned at ``ban_step``, no honest peer
    accused or banned, finite losses and norms, the final |g|; prints the
    step median, one more step by part, the peak memory beside the card;
    then #1 at the path's (4, d) stack (``fused_at_path``; held against
    its plain version with ``stats``). Returns the launch counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models.model import Model
    from repro_torch.models.workload import model_setup

    cfg = get_config(arch)
    model = Model(dataclasses.replace(cfg, **cut(cfg)))
    print(f"{label}: {cfg.name} at its published widths, depth cut from "
          f"{cfg.n_layers} blocks to {model.cfg.n_layers} "
          f"{[s.mixer for s in model.cfg.layers]}: the full depth's d = "
          f"{d_full:,} would need a {4 * 4 * d_full / 1e9:.0f} GB float32 "
          "stack for 4 peers", flush=True)
    losses = []

    def loss_fn(params, batch):
        loss = model.loss_fn(params, batch)[0]
        losses.append(loss.detach())
        return loss

    def setup():
        _, params0, batch_fn, _ = model_setup(model, seq_len=seq,
                                              batch_size=batch,
                                              device="cuda")
        if cfg.encoder_len:
            pipe = TokenPipeline(cfg.vocab_size, seq, batch, device="cuda")
            extras = {"memory_raw": ((cfg.encoder_len, cfg.encoder_dim),
                                     torch.float32)}

            def batch_fn(peer, step, flipped):
                out = pipe.device_batch(step, peer, extras=extras)
                if flipped:
                    out["tokens"] = torch.flip(out["tokens"], dims=[1])
                return out
        return loss_fn, params0, batch_fn, model

    argv = ["--model", arch, "--full", "--peers", "4", "--byzantine", "1",
            "--attack", "sign_flip", "--validators", "2", "--clip-iters",
            str(CLIP_ITERS), "--seq", str(seq), "--batch", str(batch),
            "--steps", str(steps)]
    summary, counts = run_path(label, argv, breakdown=True,
                               launches={"butterfly_clip_fused": steps},
                               d=d, setup=setup)
    check(summary["ban_steps"] == {3: ban_step},
          f"{label}: ban steps {summary['ban_steps']}, expected peer 3 at "
          f"step {ban_step}")
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()),
          f"{label}: non-finite loss {losses.tolist()}")
    check(math.isfinite(summary["final_grad_norm"]),
          f"{label}: final |g| {summary['final_grad_norm']}")
    # without stats, #1's plain version is held against it at (q)'s stack
    fused_at_path(label, d, 26, stats, suffix)
    print(f"{label}: d = {summary['d']:,}; peer 3 banned at step "
          f"{summary['ban_steps'][3]}; losses over {len(losses)} gradients "
          f"in [{float(losses.min()):.6f}, {float(losses.max()):.6f}]; final "
          f"|g| {summary['final_grad_norm']!r}; peak memory "
          f"{summary['peak_memory'] / 1e9:.2f} GB on {card}", flush=True)
    return counts


def bits(t):
    """A tensor's bits as an integer tensor of its width on the CPU (bit
    equality, not value equality: -0.0, NaN)."""
    t = t.detach().cpu().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def same_bits(xs, ys):
    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bits(x), bits(y)) for x, y in zip(xs, ys))


# phase (p): launch path (j)'s spec over 8 steps in chunks of 2, with a
# leave of the attacker's slot at the halt and a fresh identity joining it
# two steps later
DRILL = ["--arch", "albert-large", "--mesh", "4x1", "--steps", "8",
         "--scan-steps", "2", "--attack", "sign_flip", "--byzantine", "3",
         "--tau", "1", "--clip-iters", "20", "--aggregator",
         "butterfly_clip:warm_start=true,adaptive_tol=1e-4", "--churn",
         "leave@4:3,join@6:3"]
DRILL_HALT = 4


def run_drill(label, card):
    """The crash drill through ``repro_torch.launch.train``'s entry point
    at full width, three legs in this process: A uninterrupted (8 steps,
    ``--checkpoint``), B ``--checkpoint-dir D --halt-at 4``, C
    ``--checkpoint-dir D --resume --checkpoint``. Checks: B's pair loads
    back bit for bit as B's params, momentum, carry and membership at the
    halt; C's losses, CenteredClip iterations, bans and SUMMARY equal A's
    over steps 4-7, its final params, momentum and carry and its
    ``--checkpoint`` file A's bit for bit; #11's launches on B and on C
    equal A's over the same steps, nothing but #3 and #11 launches, #3
    held by ``hold_adaptive``. The files go under ``build/`` and are
    removed. Returns each leg's launch counts."""
    import shutil

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.core.sybil import HostMembership
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import train as lt

    work = os.path.join(ROOT, "build", "chip_smoke_drill")
    shutil.rmtree(work, ignore_errors=True)
    ck_dir = os.path.join(work, "D")
    a_path, c_path = (os.path.join(work, f"{x}.msgpack") for x in "ac")

    def leg(tag, extra, boundaries):
        """One leg from zeroed launch counts; the counts at each chunk
        boundary in ``boundaries`` (read when every rank has finished the
        chunk) and at the end."""
        at = {}

        def on_chunk_done(next_step):
            if next_step in boundaries:
                at[next_step] = dict(kc.LAUNCHES)

        args = lt.build_parser().parse_args(DRILL + extra)
        kc.reset_launch_counts()
        t0 = time.perf_counter()
        rec = lt.run(args, on_chunk_done=on_chunk_done)
        wall = time.perf_counter() - t0
        counts = dict(kc.LAUNCHES)
        check(all(math.isfinite(x) for x in rec["losses"]),
              f"{label} {tag}: losses {rec['losses']}")
        others = {k: v for k, v in counts.items()
                  if v and k not in ("verify_tables", "adaptive_clip_step")}
        check(not others, f"{label} {tag}: other kernels launched {others}")
        hold_adaptive(f"{label} {tag}", counts["adaptive_clip_step"],
                      [i for step in rec["clip_iters"] for i in step], 20)
        print(f"{label} {tag}: {wall:.1f} s; losses "
              f"{[round(x, 4) for x in rec['losses']]}; bans "
              f"{rec['ban_steps']}; clip iters {rec['clip_iters']}; "
              f"launches {counts}; save s "
              f"{[round(x, 3) for x in rec['save_seconds']]}; load s "
              f"{[round(x, 3) for x in rec['load_seconds']]}", flush=True)
        return rec, at, counts

    a, a_at, a_counts = leg("A (uninterrupted)", ["--checkpoint", a_path],
                            (DRILL_HALT, 8))
    b, b_at, b_counts = leg(
        "B (halt)", ["--checkpoint-dir", ck_dir, "--halt-at",
                     str(DRILL_HALT)], (DRILL_HALT,))
    check(b["halted"] == DRILL_HALT, f"{label}: B halted at {b['halted']}")
    check(b["losses"] == a["losses"][:DRILL_HALT],
          f"{label}: B's losses {b['losses']} against A's")

    # B's pair on disk is B's state at the halt, bit for bit
    state_path = os.path.join(ck_dir, "state.msgpack")
    mem_path = os.path.join(ck_dir, "membership.msgpack")
    t0 = time.perf_counter()
    flat, step, meta = load_checkpoint(state_path)
    load_s = time.perf_counter() - t0
    check(step == DRILL_HALT and meta["arch"] == "albert-large",
          f"{label}: state file at step {step}, meta {meta}")

    def part(prefix):
        return [t for k, t in flat.items() if k.startswith(prefix + "/")]

    def flat_of(leaves):
        return torch.cat([t.reshape(-1) for t in leaves])

    st = b["state"]
    check(same_bits(part("params"), tree_leaves(st["params"])),
          f"{label}: the state file's params are not B's at the halt")
    check(same_bits([flat_of(part("opt/m"))], [st["opt"]["m"]]),
          f"{label}: the state file's momentum is not B's at the halt")
    check(same_bits([flat_of(part("v_prev"))], [st["v_prev"]]),
          f"{label}: the state file's carry is not B's at the halt")
    mem_tree, mem_step, _ = load_checkpoint(mem_path)
    restored = HostMembership(4).restore_tree(mem_tree).summary()
    check(mem_step == DRILL_HALT and all(
        restored[k] == b["summary"][k] for k in restored),
        f"{label}: membership file {restored} at step {mem_step}, B "
        f"{b['summary']}")
    sizes = {os.path.basename(p): os.path.getsize(p)
             for p in (state_path, mem_path)}
    del flat, st, b["state"]

    c, _, c_counts = leg(
        "C (resume)", ["--checkpoint-dir", ck_dir, "--resume",
                       "--checkpoint", c_path], ())
    for key, want, got in (
            ("losses", a["losses"][DRILL_HALT:], c["losses"]),
            ("clip_iters", a["clip_iters"][DRILL_HALT:], c["clip_iters"]),
            ("ban_steps", a["ban_steps"], c["ban_steps"]),
            ("summary", a["summary"], c["summary"])):
        check(want == got, f"{label}: C's {key} {got} against A's {want}")
    check(len(a["summary"]["banned_identities"]) == 2,
          f"{label}: expected the attacker and its rejoin banned: "
          f"{a['summary']}")
    for key in ("params", "opt", "v_prev"):
        check(same_bits(tree_leaves(a["state"][key]),
                        tree_leaves(c["state"][key])),
              f"{label}: C's final {key} differ from A's")
    with open(a_path, "rb") as fa, open(c_path, "rb") as fc:
        check(fa.read() == fc.read(),
              f"{label}: C's --checkpoint file differs from A's")
    sizes[os.path.basename(a_path)] = os.path.getsize(a_path)

    # #11 once per rank and step on every leg: B's and C's counts are A's
    # over the same steps
    a_first = a_at[DRILL_HALT]["verify_tables"]
    a_second = a_at[8]["verify_tables"] - a_first
    check(a_counts["verify_tables"] == a_at[8]["verify_tables"],
          f"{label}: A launched after its last chunk")
    check(b_counts["verify_tables"] == a_first
          and c_counts["verify_tables"] == a_second,
          f"{label}: #11 launches A {a_first} + {a_second}, B "
          f"{b_counts['verify_tables']}, C {c_counts['verify_tables']}")
    a3 = a_at[DRILL_HALT]["adaptive_clip_step"]
    print(f"{label}: {card}; files {sizes} bytes; saves (s) B "
          f"{b['save_seconds']}, C {c['save_seconds']} (the last the "
          f"--checkpoint file); C's resume read {c['load_seconds']} s on "
          f"rank 0, the state file read again {load_s:.3f} s; #11 A "
          f"{a_first} + {a_second} = B "
          f"{b_counts['verify_tables']} + C {c_counts['verify_tables']}; "
          f"#3 A {a3} + {a_counts['adaptive_clip_step'] - a3}, B "
          f"{b_counts['adaptive_clip_step']}, C "
          f"{c_counts['adaptive_clip_step']}: resumed bit for bit",
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"drill_uninterrupted": a_counts, "drill_halt": b_counts,
            "drill_resume": c_counts}


def run_toy(label, argv, banned, launches):
    """The §4.1 toy classifier through ``train_byzantine``'s default path
    (the host loop, no --model) with the launch counts set to 0 just
    before and read just after. Checks: exactly ``banned`` is banned, every
    gradient norm finite, ``launches`` the exact count of every kernel
    (all others 0). Returns the counts."""
    from repro_torch.kernels import centered_clip as kc
    from repro_torch.launch import train_byzantine as tb

    args = tb.build_parser().parse_args(argv)
    kc.reset_launch_counts()
    tr, accuracy, seconds = tb.run_toy(args)
    torch.cuda.synchronize()
    counts = dict(kc.LAUNCHES)
    check(tr.banned == set(banned),
          f"{label}: banned {sorted(tr.banned)}, expected {sorted(banned)}")
    check(all(math.isfinite(r["grad_norm"]) for r in tr.history),
          f"{label}: non-finite grad norm")
    want = {name: 0 for name in counts}
    want.update(launches)
    check(counts == want, f"{label}: launches {counts}, expected {want}")
    acc = accuracy(tr.unraveled_params())
    print(f"{label}: median step {statistics.median(seconds):.4f} s over "
          f"{len(seconds)} steps; final accuracy {acc:.3f}; banned "
          f"{sorted(tr.banned)}; launches {counts}", flush=True)
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import argparse

    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="only build, print the passes' resources and run "
                    "the per-pass breakdown of #1, #3, #4, #5, #7, #8, #10 "
                    "and #12 and the yardstick")
    args = ap.parse_args()
    t_start = time.perf_counter()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    libs = build.compile_all()
    for name in libs:
        build.load(name)
    print(f"phase 1: {card}; built "
          f"{[os.path.relpath(p, ROOT) for p in libs.values()]} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in "
          "parallel)", flush=True)
    print_pass_info()
    if args.breakdown:
        pass_breakdown(dev)
        print(card)
        return

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
    paths = {"main": main_counts}
    adaptive_sum, paths["adaptive"] = run_path(
        "phase 4 (adaptive warm start)",
        common + ["--steps", "3", "--aggregator",
                  "butterfly_clip:warm_start=true,adaptive_tol=1e-4"],
        expect=("adaptive_clip_step", "verify_tables_batched"))
    _, paths["aggregator_attack"] = run_path(
        "phase 4 (aggregator attack)", common + ["--steps", "3"],
        attack={"aggregator_attack": True, "aggregator_scale": 5.0},
        expect=("butterfly_clip", "verify_tables_batched"))
    # the verified:* and compressed:* paths: (label, aggregator, attack,
    # the kernel that runs once a step)
    wrapped = [
        ("verified_mean", "verified:mean", None, "mean_digest_fused"),
        ("verified_trimmed_mean", "verified:trimmed_mean:trim_ratio=0.25",
         None, "digest_tables_batched"),
        ("verified_mean_aggregator_attack", "verified:mean",
         {"aggregator_attack": True, "aggregator_scale": 5.0},
         "digest_tables_batched"),
        ("compressed_butterfly_clip", "compressed:butterfly_clip", None,
         "butterfly_clip_fused_dequant"),
        ("compressed_verified_mean_bf16",
         "compressed:verified:mean:codec=bf16", None,
         "mean_digest_fused_dequant"),
    ]
    for label, aggregator, attack, kernel in wrapped:
        _, paths[label] = run_path(
            f"phase 4 ({label}: {aggregator})",
            common + ["--steps", "3", "--aggregator", aggregator],
            attack=attack, breakdown=True, launches={kernel: 3})
    # the flat-cost verification paths, driven through the engine with
    # EngineConfig(audit_k=..., groups=...): (label, peers, aggregator,
    # attack, kernel launches per step, groups)
    sign_flip = {"kind": "sign_flip"}
    engine_paths = [
        ("sampled_flagship", 4, None, sign_flip,
         {"butterfly_clip": 1, "digest_tables_rows": 1}, None),
        ("sampled_verified_mean_aggregator_attack", 4, "verified:mean",
         {"kind": "none", "aggregator_attack": True,
          "aggregator_scale": 5.0}, {"digest_tables_rows": 1}, None),
        ("hier_sampled_flagship", 8, None, sign_flip,
         {"butterfly_clip_fused": 2, "digest_tables_batched": 1}, 2),
    ]
    for tag, (label, n, aggregator, attack, per_step, groups) in zip(
            "fgh", engine_paths):
        paths[label] = run_engine_path(
            f"phase 4 ({tag}) {label}: n={n} {aggregator or 'butterfly_clip'}"
            f" audit_k=1 groups={groups}", n, aggregator, attack, per_step,
            groups=groups)

    # the distributed launch path: 4 peer ranks on the card, 4 steps;
    # (label, extra flags, kernel launches given the run's record)
    launch = ["--arch", "albert-large", "--mesh", "4x1", "--steps", "4",
              "--attack", "sign_flip", "--byzantine", "3", "--tau", "1",
              "--clip-iters", str(CLIP_ITERS)]
    per_owner_step = lambda name: (  # noqa: E731
        lambda rec: {name: sum(len(r) for r in rec["clip_iters"])})
    launch_paths = [
        ("launch_fixed", ["--aggregator", "butterfly_clip"],
         per_owner_step("centered_clip_fused")),
        ("launch_adaptive",
         ["--aggregator", "butterfly_clip:warm_start=true,adaptive_tol=1e-4",
          "--clip-iters", "20"],
         lambda rec: {"verify_tables": sum(map(len, rec["clip_iters"]))}),
        ("launch_verified_mean", ["--aggregator", "verified:mean"],
         per_owner_step("mean_digest_fused")),
        ("launch_compressed", ["--aggregator", "compressed:butterfly_clip"],
         per_owner_step("butterfly_clip_fused_dequant")),
        ("launch_groups_sampled", ["--aggregator", "butterfly_clip",
                                   "--groups", "2", "--audit-k", "1"],
         per_owner_step("centered_clip_fused")),
    ]
    for tag, (label, extra, launches) in zip("ijklm", launch_paths):
        paths[label] = run_launch_path(
            f"phase 5 ({tag}) {label}: {' '.join(extra)}, 4 thread ranks",
            launch + extra, launches)
    for label in ("launch_fixed", "launch_verified_mean",
                  "launch_compressed", "launch_groups_sampled"):
        check(max(paths[label].values()) == 16,
              f"{label}: expected one launch per rank and step (16)")
    check(paths["launch_adaptive"]["verify_tables"] == 16,
          "launch_adaptive: expected 16 table passes")

    # the §4.1 full-vector baselines at full width: non-verifiable, so no
    # z, no tables and no kernel
    for defense in ("centered_clip", "krum", "geometric_median"):
        _, paths[f"baseline_{defense}"] = run_path(
            f"phase 6 (baseline {defense})",
            common + ["--steps", "3", "--defense", defense], launches={},
            bans=False, breakdown=True)
    paths["fig9"] = run_fig9("phase 7 (fig9, d=78223360)", stats)
    # the toy classifier, 7 of the peers sign-flipping from step 10, 60
    # steps of the host loop: btard runs #1 once a step (past 32 peers
    # the peer-tiled passes); the trusted-server centered_clip no kernel
    toy = ["--attack", "sign_flip", "--byzantine", "7"]
    for tag, peers, defense, launches in (
            ("toy_btard_16", 16, "btard", {"butterfly_clip_fused": 60}),
            ("toy_btard_40", 40, "btard", {"butterfly_clip_fused": 60}),
            ("toy_centered_clip_16", 16, "centered_clip", {})):
        paths[tag] = run_toy(
            f"phase 8 ({tag})", toy + ["--peers", str(peers), "--defense",
                                       defense],
            range(peers - 7, peers) if defense == "btard" else (), launches)

    # elastic membership through the engine, and the paper's §4.2 setup
    paths["membership"] = run_membership_path(
        "phase 9 (n) elastic membership: 6 slots, join, leave, rejoin under "
        "a new key")
    paths["section_4_2"] = run_section_4_2(
        "phase 9 (o) section 4.2: albert_pretrain --full", stats)
    # the crash drill: halt and resume bit for bit on launch path (j)
    paths.update(run_drill("phase 9 (p) crash drill: " + " ".join(DRILL),
                           card))
    # the dense-decoder family at full width on the main path
    paths["qwen3"] = run_qwen3("phase 9 (q) qwen3-1.7b --full", stats)
    # the MoE/MLA family at full width, depth cut, on the main path
    paths["deepseek"] = run_deepseek("phase 9 (r) deepseek-v2-lite-16b "
                                     "--full")
    # the RG-LRU and local-attention families at published widths, depth
    # cut, on the main path
    paths["recurrentgemma"] = run_cut_model(
        "phase 9 (s) recurrentgemma-9b --full", "recurrentgemma-9b",
        lambda cfg: {"prefix": (), "n_repeats": 1}, D_RGEMMA,
        D_RGEMMA_FULL, 4096, 6, card)
    kept = rglru_kept_bytes("recurrentgemma-9b", 4096)
    print(f"phase 9 (s): kept for the backward at seq 4096, width 4096: "
          f"{kept[0] / 1e9:.3f} GB by one RG-LRU mixer, {kept[1] / 1e9:.3f} "
          "GB by its scan alone", flush=True)
    paths["gemma3"] = run_cut_model(
        "phase 9 (t) gemma3-27b --full", "gemma3-27b",
        lambda cfg: {"prefix": cfg.prefix[:1], "pattern": (),
                     "n_repeats": 0}, D_GEMMA3, D_GEMMA3_FULL, 2048, 3, card)
    # the encoder-decoder family whole through the distributed launcher,
    # and gated cross attention at published widths, depth cut, on the
    # main path
    print("phase 9 (u) whisper-small: the whole model (12 encoder + 12 "
          f"decoder layers, d = {D_WHISPER:,}), memory 1500 frames x 768 "
          "from the pipeline's extras", flush=True)
    paths["whisper"] = run_launch_path(
        "phase 9 (u) whisper-small: " + " ".join(WHISPER[2:]),
        WHISPER, per_owner_step("centered_clip_fused"), d=D_WHISPER)
    check(paths["whisper"]["centered_clip_fused"] == 16,
          "whisper: expected one launch per rank and step (16)")
    owner_clip_at("phase 9 (u)", stats, D_WHISPER, "@wh")
    from repro_torch.configs.base import SA, XA

    paths["llama_vision"] = run_cut_model(
        "phase 9 (v) llama-3.2-vision-11b --full", "llama-3.2-vision-11b",
        lambda cfg: {"pattern": (SA, XA), "n_repeats": 1}, D_VISION,
        D_VISION_FULL, 128, 6, card, batch=4, ban_step=VISION_BAN_STEP,
        stats=stats, suffix="@lv")
    print("phase 10: kernels launched per path: " + json.dumps(paths),
          flush=True)
    home = {"butterfly_clip_fused": "main", "verify_tables_batched":
            "adaptive", "adaptive_clip_step": "adaptive",
            "butterfly_clip": "aggregator_attack",
            "mean_digest_fused": "verified_mean",
            "digest_tables_batched": "verified_trimmed_mean",
            "butterfly_clip_fused_dequant": "compressed_butterfly_clip",
            "mean_digest_fused_dequant": "compressed_verified_mean_bf16",
            "digest_tables_rows": "sampled_flagship",
            "centered_clip_fused": "launch_fixed",
            "verify_tables": "launch_adaptive",
            "centered_clip": "fig9"}
    rows = []
    for name, (replaces, source) in KERNELS.items():
        st = stats[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": home[name],
            "launches": paths[home[name]][name],
            "max_abs_err": st["max_abs_err"],
            "max_rel_err": st["max_rel_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": None,
            "moved_bytes": st["moved_bytes"],
        }
        if name == "adaptive_clip_step":
            # the iterations the path's calls stepped, beside the launches
            row["iters"] = sum(adaptive_sum["clip_iters"])
        if name == "butterfly_clip_fused":
            row["launches_qwen3"] = paths["qwen3"][name]
            row["launches_deepseek"] = paths["deepseek"][name]
            row["launches_recurrentgemma"] = paths["recurrentgemma"][name]
            row["launches_gemma3"] = paths["gemma3"][name]
            row["launches_llama_vision"] = paths["llama_vision"][name]
        if name == "centered_clip_fused":
            row["launches_whisper"] = paths["whisper"][name]
        if name in ("verify_tables", "adaptive_clip_step"):
            # the crash drill's legs: A uninterrupted, B halted, C resumed
            row["launches_drill"] = {
                leg: paths[f"drill_{leg}"][name]
                for leg in ("uninterrupted", "halt", "resume")}
        if name in PATH_CODEC:
            row["codec"] = PATH_CODEC[name]
            row["by_codec"] = st["by_codec"]
        for key in SIDE_ROWS.values():
            if key in st:
                row[key] = st[key]
        rows.append(row)
    print(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
