"""Kernels #1-#12 on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (rtol = atol = 1e-5), bitwise repeatable,
launch counted; the wire-payload twins #7 and #8 give the bits of #1 and
#5 on the dequantized payloads, and the sampled-digest kernel #9 gives, row
for row, the bits of #2 (tau > 0) or #6 (tau = 0) at the sampled
partitions; the single-partition kernels #10, #11 and #12 give the bits of
#1, #2 and #4 at one partition, #12 also over a bf16 stack (the bits of
the float32 kernel on the widened stack) and with a tau schedule; the
two-phase clip (#4, #12) at each of its bodies (staged or global, up to
32 peers), its one-read passes giving the bits of the two-pass
composition up to 8 peers, refusing what it cannot run; every
kernel above 32 peers (n = 33 and 64, the peer-tiled passes) and at
partition lengths around a chunk boundary; and one stack gives the same
bits at every storage offset and row stride. The adaptive loop (#3),
decided on the card, gives the bits of the loop that read ||dv||^2 on
the host before every iteration; the wire passes' staged body (#7, #8)
gives its float32 twins' bits; verified:mean's one pass (#5, #8) gives
the digests a validator recomputes (#6, #9) against its v, bit for bit.
A bf16 and f32 tree on the card round-trips through a checkpoint bit for
bit, onto its example's device. One MoE layer (DeepSeek-V2-Lite's
routing: 64 experts top-6, 2 shared, tokens dropped) runs forward and
backward on the card within 1e-5 of the same code on the CPU (each
gradient within 1e-5 of its largest value), with its
routing equal and its gradients equal bit for bit over two runs; the
reduced DeepSeek-V2-Lite trains through ``run_scan`` on the card with #1
once a step and the CPU run's bans. One block of Gemma3-27B (local
attention) and of RecurrentGemma-9B (local attention, RG-LRU) at the
published widths runs forward and backward on the card bit for bit
twice and within 1e-5 of the CPU's; the reduced Gemma3-27B and
RecurrentGemma-9B ban on the card as on the CPU. So do, at the published
widths, Whisper-small's decoder block (self and cross attention over a
memory of 1500 frames) and one encoder layer (1500 frames,
bidirectional), and Llama-3.2-Vision's gated cross-attention block (1600
patches, ``xgate`` 0.5); the reduced Whisper-small and Llama-3.2-Vision,
fed ``memory_raw`` from the pipeline's extras, ban on the card as on the
CPU. Serving at the published widths: a block of Mamba2-2.7B (the SSM),
DeepSeek-V2-Lite (MLA's absorbed decode), RecurrentGemma-9B (the RG-LRU)
and Whisper-small (the cross caches) runs prefill and 4 decode steps on
the card bit for bit twice and within 1e-5 of the CPU's, caches too.
Marked
``cuda``; skips without a CUDA device. Run on the GPU
machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import centered_clip as kc

# the last four run the two-phase clip's staged body (8, 9, 32: aligned
# rows) and its global body (24: ragged) at more peers
SHAPES = [(4, 4 * 517 - 3), (5, 5 * 1001 - 3), (16, 16 * 3000 + 5),
          (8, 8 * 2052), (9, 9 * 4100), (24, 24 * 1028 - 3), (32, 32 * 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, d, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n * 7919 + d)
    part = kc.part_len(d, n)
    g = torch.randn((n, d), generator=gen, device=dev) / math.sqrt(part)
    g[-1] *= 10.0
    z = torch.randn((n, part), generator=gen, device=dev)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    v = 0.1 * torch.randn((n, part), generator=gen, device=dev) / math.sqrt(part)
    w = torch.ones((n,), device=dev)
    w[-2] = 0.0
    return g, z, v, w


def _check(kernel, plain, name):
    before = kc.LAUNCHES[name]
    a, b, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    a, b, ref = [x if isinstance(x, tuple) else (x,) for x in (a, b, ref)]
    assert kc.LAUNCHES[name] > before
    for x, y, r in zip(a, b, ref):
        assert x.is_cuda
        assert torch.equal(x, y), f"{name}: not bitwise repeatable"
        torch.testing.assert_close(x.float(), r.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [1.0, math.inf])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions_on_card(cuda, shape, tau):
    n, d = shape
    g, z, v, w = _inputs(n, d, cuda)
    taus = [tau] * 5
    _check(lambda: kc.butterfly_clip_fused(g, n, taus, z, None, w, v),
           lambda: kc.butterfly_clip_fused_plain(g, n, taus, z, None, w, v),
           "butterfly_clip_fused")
    _check(lambda: kc.verify_tables_batched(g, n, v, z, tau),
           lambda: kc.verify_tables_batched_plain(g, n, v, z, tau),
           "verify_tables_batched")
    _check(lambda: kc.butterfly_clip_adaptive(g, n, tau, 1e-4, 5, w, v),
           lambda: kc.butterfly_clip_adaptive_plain(g, n, tau, 1e-4, 5, w, v),
           "adaptive_clip_step")
    _check(lambda: kc.butterfly_clip(g, n, taus, w, v),
           lambda: kc.butterfly_clip_plain(g, n, taus, w, v),
           "butterfly_clip")


@pytest.mark.cuda
def test_adaptive_at_tol_zero_is_fixed_budget_bitwise_on_card(cuda):
    n, d = SHAPES[1]
    g, z, v, w = _inputs(n, d, cuda)
    fixed, _, _ = kc.butterfly_clip_fused(g, n, [1.0] * 6, z, None, w, v)
    adapt, iters = kc.butterfly_clip_adaptive(g, n, 1.0, 0.0, 6, w, v)
    assert torch.equal(adapt, fixed)
    assert iters.tolist() == [6] * n


def _wire(g, n, codec):
    from repro_torch.core import compression

    return compression.quantize_grads(g, codec, n)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_digest_and_wire_kernels_match_plain_versions_on_card(cuda, shape,
                                                              codec):
    n, d = shape
    g, z, v, w = _inputs(n, d, cuda)
    g[1, :kc.part_len(d, n)] = 0.0  # an all-zero payload: int8 scale 0
    q, sc = _wire(g, n, codec)
    taus = [1.0] * 5
    _check(lambda: kc.digest_tables_batched(g, n, v, z),
           lambda: kc.digest_tables_batched_plain(g, n, v, z),
           "digest_tables_batched")
    _check(lambda: kc.mean_digest_fused(g, n, z, w),
           lambda: kc.mean_digest_fused_plain(g, n, z, w),
           "mean_digest_fused")
    _check(lambda: kc.butterfly_clip_fused_dequant(q, sc, n, taus, z, None,
                                                   w, v),
           lambda: kc.butterfly_clip_fused_dequant_plain(q, sc, n, taus, z,
                                                         None, w, v),
           "butterfly_clip_fused_dequant")
    _check(lambda: kc.mean_digest_fused_dequant(q, sc, n, z, w),
           lambda: kc.mean_digest_fused_dequant_plain(q, sc, n, z, w),
           "mean_digest_fused_dequant")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_wire_kernels_equal_f32_kernels_on_dequantized_bitwise(cuda, codec):
    from repro_torch.core import compression

    n, d = SHAPES[1]
    g, z, v, w = _inputs(n, d, cuda)
    q, sc = _wire(g, n, codec)
    xd = compression.wire_grads(g, codec, n)
    a = kc.butterfly_clip_fused_dequant(q, sc, n, [1.0] * 5, z, None, w, v)
    b = kc.butterfly_clip_fused(xd, n, [1.0] * 5, z, None, w, v)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = kc.mean_digest_fused_dequant(q, sc, n, z, w)
    b = kc.mean_digest_fused(xd, n, z, w)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


ROWS = [[3, 1], [0], [2, 0, 3, 1], [1, 1]]


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.0, 1.0, math.inf])
@pytest.mark.parametrize("shape", SHAPES)
def test_rows_digest_kernel_matches_plain_and_full_tables_on_card(cuda, shape,
                                                                  tau):
    n, d = shape
    g, z, v, _ = _inputs(n, d, cuda)
    g[1, :kc.part_len(d, n)] = 0.0  # an all-zero payload
    if tau > 0:
        fs, fn = kc.verify_tables_batched(g, n, v, z, tau)
    else:
        fs, fn = kc.digest_tables_batched(g, n, v, z)
    for rows in ROWS:
        rows = [r % n for r in rows]
        _check(lambda: kc.digest_tables_rows(g, n, v, z, rows, tau),
               lambda: kc.digest_tables_rows_plain(g, n, v, z, rows, tau),
               "digest_tables_rows")
        s, norms = kc.digest_tables_rows(g, n, v, z, rows, tau)
        assert torch.equal(s, fs[rows]) and torch.equal(norms, fn[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [[4], [-1], [0, 9], [], [[0, 1]]])
def test_rows_digest_kernel_rejects_bad_rows_on_card(cuda, rows):
    n, d = SHAPES[0]
    g, z, v, _ = _inputs(n, d, cuda)
    before = kc.LAUNCHES["digest_tables_rows"]
    with pytest.raises(ValueError, match="rows"):
        kc.digest_tables_rows(g, n, v, z, torch.tensor(rows, device=cuda),
                              1.0)
    assert kc.LAUNCHES["digest_tables_rows"] == before



@pytest.mark.cuda
@pytest.mark.parametrize("tau", [1.0, math.inf])
@pytest.mark.parametrize("n, part", [(1, 517), (3, 1001), (4, 4096 + 5),
                                     (8, 3000)])
def test_single_partition_kernels_match_plain_versions_on_card(cuda, n, part,
                                                               tau):
    m = max(n, 2)  # _inputs zeroes the weight of peer m - 2
    g, z, v, w = _inputs(m, m * part, cuda)
    xs, z, v, w = g[:n, :part].contiguous(), z[0], v[0], w[:n].contiguous()
    taus = [tau] * 5
    _check(lambda: kc.centered_clip_fused(xs, taus, z, None, w, v),
           lambda: kc.centered_clip_fused_plain(xs, taus, z, None, w, v),
           "centered_clip_fused")
    _check(lambda: kc.verify_tables(xs, v, z, tau),
           lambda: kc.verify_tables_plain(xs, v, z, tau), "verify_tables")
    # the passes of #1 and #2 at one partition: the same bits
    a = kc.centered_clip_fused(xs, taus, z, None, w, v)
    b = kc.butterfly_clip_fused(xs, 1, taus, z[None], None, w, v[None])
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    a = kc.verify_tables(xs, v, z, tau)
    b = kc.verify_tables_batched(xs, 1, v[None], z[None], tau)
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n, d", [(2, 517), (4, 4096 + 5), (16, 16 * 3000 + 5),
                                  (33, 1001), (8, 2 * 4096 + 8),
                                  (9, 3 * 4096 + 8), (16, 4096 + 1024 + 16),
                                  (24, 4096 + 1024 + 8), (32, 2 * 1024 + 8)])
def test_centered_clip_kernel_matches_plain_version_on_card(cuda, n, d,
                                                            dtype):
    """#12 with weights (a banned peer), a warm start and a tau schedule
    with an infinite radius in it, at every body of the two-phase clip (d
    a multiple of 8 stages a bf16 stack too); its bits are #4's at one
    partition, and a bf16 stack gives the bits of the float32 kernel on
    the widened stack."""
    g, _, v, w = _inputs(n, n * d, cuda)
    xs, v0 = g[:, :d].contiguous().to(dtype), v[0]
    for taus in ([1.0] * 5, [0.5, 2.0, math.inf, 1.0]):
        _check(lambda: kc.centered_clip(xs, taus, w, v0),
               lambda: kc.centered_clip_plain(xs, taus, w, v0),
               "centered_clip")
        _check(lambda: kc.centered_clip(xs, taus),
               lambda: kc.centered_clip_plain(xs, taus), "centered_clip")
    a = kc.centered_clip(xs, [1.0] * 5, w, v0)
    if dtype == torch.float32:
        b = kc.butterfly_clip(xs, 1, [1.0] * 5, w, v0[None])
        assert torch.equal(a, b[0])
    else:
        assert torch.equal(a, kc.centered_clip(xs.float(), [1.0] * 5, w, v0))


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(4, 4 * (kc.CHUNK + 1024) - 3),
                                  (4, 4 * (kc.CHUNK + 1024)),
                                  (5, 5 * 1001 - 3), (8, 8 * 2052)])
def test_two_phase_clip_is_its_composed_passes_bitwise_on_card(cuda, n, d):
    """Up to 8 peers the one-read #4 (a prologue, then updates carrying the
    next norms) gives the bits of L rounds of the norm pass and the update
    composed as the two-pass kernel ran them, whichever body it takes
    (global on the ragged stacks, staged on the aligned ones)."""
    g, _, v, w = _inputs(n, d, cuda)
    taus = [1.0, 0.5, math.inf, 2.0]
    want = kc.butterfly_clip(g, n, taus, w, v)
    k = kc._Stack(g, n)
    ww, sq_part = k.weights(w), k.partials()
    sq, cw, wsum = k.empty(n, n), k.empty(n, n), k.empty(1)
    out = k.empty(n, k.part)
    for it, tau in enumerate(taus):
        vin = v if it == 0 else out
        k.sq_pass(vin, sq_part)
        k.finish_weights(sq_part, ww, tau, sq, cw, wsum if it == 0 else None)
        k.clip_pass(vin, out, cw, wsum, None)
    assert torch.equal(out, want)
    assert k.clip_vec == (d % 4 == 0)


@pytest.mark.cuda
def test_two_phase_pass_refuses_what_it_cannot_run_on_card(cuda):
    """No fallback: a pass that neither updates nor forms norms, the
    staged body asked for over rows off 16 bytes, and an update carrying
    the next norms above 32 peers are refused and raise; nothing runs
    another body instead."""
    g, _, v, w = _inputs(16, 16 * 4100, cuda)
    k = kc._Stack(g, 16)
    with pytest.raises(RuntimeError, match="clip_pass"):
        k.clip_pass(v, None, None, None, None)
    u = kc._Stack(_at(g, 1), 16)
    assert not u.clip_vec
    with pytest.raises(RuntimeError, match="clip_pass"):
        u._pass("clip_pass", (v,), v.data_ptr(), None, None, None,
                u.partials().data_ptr(), vec=True)
    big = kc._Stack(_inputs(33, 33 * 64, cuda)[0], 1)
    cw, wsum = big.empty(1, 33), torch.ones(1, device=cuda)
    with pytest.raises(RuntimeError, match="clip_pass"):
        big.clip_pass(None, big.empty(1, big.part), cw, wsum, big.partials())


@pytest.mark.cuda
def test_centered_clip_kernel_rejects_bad_inputs_on_card(cuda):
    before = kc.LAUNCHES["centered_clip"]
    xs = torch.zeros((4, 100), device=cuda)
    for bad in (xs.to(torch.int8), xs[0], xs.t()):
        with pytest.raises(ValueError):
            kc.centered_clip(bad, [1.0])
    with pytest.raises(ValueError, match="v0"):
        kc.centered_clip(xs, [1.0], v0=torch.zeros(99, device=cuda))
    assert kc.LAUNCHES["centered_clip"] == before


def _check_every_kernel(g, n, z, v, w, taus):
    """Kernels #1-#12 over the (n, d) stack g read as n partitions,
    against their plain versions; the wire kernels give their float32
    twins' bits, #9 gives #2/#6's at its rows, and the single-partition
    kernels #10-#12 give #1/#2/#4's."""
    from repro_torch.core import compression

    _check(lambda: kc.butterfly_clip_fused(g, n, taus, z, None, w, v),
           lambda: kc.butterfly_clip_fused_plain(g, n, taus, z, None, w, v),
           "butterfly_clip_fused")
    _check(lambda: kc.verify_tables_batched(g, n, v, z, 1.0),
           lambda: kc.verify_tables_batched_plain(g, n, v, z, 1.0),
           "verify_tables_batched")
    _check(lambda: kc.butterfly_clip_adaptive(g, n, 1.0, 1e-4, 4, w, v),
           lambda: kc.butterfly_clip_adaptive_plain(g, n, 1.0, 1e-4, 4, w, v),
           "adaptive_clip_step")
    _check(lambda: kc.butterfly_clip(g, n, taus, w, v),
           lambda: kc.butterfly_clip_plain(g, n, taus, w, v),
           "butterfly_clip")
    _check(lambda: kc.mean_digest_fused(g, n, z, w),
           lambda: kc.mean_digest_fused_plain(g, n, z, w),
           "mean_digest_fused")
    _check(lambda: kc.digest_tables_batched(g, n, v, z),
           lambda: kc.digest_tables_batched_plain(g, n, v, z),
           "digest_tables_batched")
    for codec in ("int8", "bf16"):
        q, sc = _wire(g, n, codec)
        xd = compression.wire_grads(g, codec, n)
        _check(lambda: kc.butterfly_clip_fused_dequant(q, sc, n, taus, z,
                                                       None, w, v),
               lambda: kc.butterfly_clip_fused_dequant_plain(
                   q, sc, n, taus, z, None, w, v),
               "butterfly_clip_fused_dequant")
        _check(lambda: kc.mean_digest_fused_dequant(q, sc, n, z, w),
               lambda: kc.mean_digest_fused_dequant_plain(q, sc, n, z, w),
               "mean_digest_fused_dequant")
        a = kc.butterfly_clip_fused_dequant(q, sc, n, taus, z, None, w, v)
        b = kc.butterfly_clip_fused(xd, n, taus, z, None, w, v)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), codec
        a = kc.mean_digest_fused_dequant(q, sc, n, z, w)
        b = kc.mean_digest_fused(xd, n, z, w)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), codec
    rows = [n - 1, 0, 2 % n]
    for tau in (0.0, 1.0):
        _check(lambda: kc.digest_tables_rows(g, n, v, z, rows, tau),
               lambda: kc.digest_tables_rows_plain(g, n, v, z, rows, tau),
               "digest_tables_rows")
    s, norms = kc.digest_tables_rows(g, n, v, z, rows, 1.0)
    fs, fn = kc.verify_tables_batched(g, n, v, z, 1.0)
    assert torch.equal(s, fs[rows]) and torch.equal(norms, fn[rows])
    part = kc.part_len(g.shape[1], n)
    xs = g[:, :part].contiguous()
    _check(lambda: kc.centered_clip_fused(xs, taus, z[0], None, w, v[0]),
           lambda: kc.centered_clip_fused_plain(xs, taus, z[0], None, w,
                                                v[0]),
           "centered_clip_fused")
    _check(lambda: kc.verify_tables(xs, v[0], z[0], 1.0),
           lambda: kc.verify_tables_plain(xs, v[0], z[0], 1.0),
           "verify_tables")
    _check(lambda: kc.centered_clip(xs, taus, w, v[0]),
           lambda: kc.centered_clip_plain(xs, taus, w, v[0]),
           "centered_clip")
    a = kc.centered_clip_fused(xs, taus, z[0], None, w, v[0])
    b = kc.butterfly_clip_fused(xs, 1, taus, z[:1], None, w, v[:1])
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))
    assert torch.equal(kc.centered_clip(xs, taus, w, v[0]),
                       kc.butterfly_clip(xs, 1, taus, w, v[:1])[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64])
def test_every_kernel_past_32_peers_on_card(cuda, n):
    """The peer-tiled passes: kernels #1-#12 at n = 33 and 64 peers (n
    partitions, ragged) against their plain versions; the wire kernels
    give their float32 twins' bits, #9 gives #2/#6's at its rows, and
    the single-partition kernels #10-#12 give #1/#2/#4's."""
    d = n * 301 - 5
    g, z, v, w = _inputs(n, d, cuda)
    g[1, :kc.part_len(d, n)] = 0.0  # an all-zero payload
    _check_every_kernel(g, n, z, v, w, [1.0] * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [0, 3])
@pytest.mark.parametrize("part", [kc.CHUNK - kc.GROUP, kc.CHUNK + kc.GROUP,
                                  2 * kc.CHUNK + 2, 4097])
def test_every_kernel_at_chunk_edges_on_card(cuda, part, ragged):
    """Kernels #1-#12 over 4 peers and 4 partitions whose length lies one
    group either side of a chunk boundary or is not a multiple of 4 (the
    column-by-column body), with and without a ragged tail in the last
    partition."""
    n = 4
    d = n * part - ragged
    g, z, v, w = _inputs(n, d, cuda)
    g[1, :part] = 0.0  # an all-zero payload
    assert kc.part_len(d, n) == part
    _check_every_kernel(g, n, z, v, w, [1.0] * 3)


def _at(x, offset):
    """x's values at storage offset ``offset`` of a wider buffer whose row
    stride (a multiple of 4, not x's width) keeps only offset 0 aligned for
    the 16-byte loads."""
    n, d = x.shape
    width = -(-(d + offset) // 4) * 4 + 4
    big = torch.zeros((n, width), dtype=x.dtype, device=x.device)
    big[:, offset:offset + d] = x
    return big[:, offset:offset + d]


def _vec_at(v, offset):
    """A (rows, part) float32 vector at storage offset ``offset``
    (contiguous, so the kernels read it in place, off 16 bytes unless
    offset is a multiple of 4)."""
    flat = torch.zeros(v.numel() + offset, device=v.device)
    flat[offset:] = v.reshape(-1)
    return flat[offset:].view(v.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d", [(4, 4 * 8192), (4, 4 * 8192 - 3),
                                  (5, 5 * 1001 - 3), (8, 8 * 4100),
                                  (16, 16 * 4100), (9, 9 * 4100 - 3)])
def test_same_bits_at_every_storage_offset_and_row_stride_on_card(cuda, n, d):
    """One stack, stored contiguous and at storage offsets 0-3 of wider
    rows (row stride != d), with v0 and z also off 16 bytes at offset 1:
    #1, #10, #2, #11, #5, the two-phase #4 and #12 (float32 and bf16) and,
    over int8 and bf16 payloads, #7 and #8 give the same bits every time
    (the 16-byte, the staged and the column-by-column bodies sum in one
    order)."""
    g, z, v, w = _inputs(n, d, cuda)
    part = kc.part_len(d, n)
    taus = [1.0] * 4
    wire = {codec: _wire(g, n, codec) for codec in ("int8", "bf16")}
    gb = g.to(torch.bfloat16)

    def outputs(x, xb, zz, vv, qs):
        xs = x[:, :part]
        out = [*kc.butterfly_clip_fused(x, n, taus, zz, None, w, vv),
               *kc.centered_clip_fused(xs, taus, zz[0], None, w, vv[0]),
               *kc.verify_tables_batched(x, n, vv, zz, 1.0),
               *kc.verify_tables(xs, vv[0], zz[0], 1.0),
               *kc.mean_digest_fused(x, n, zz, w),
               kc.butterfly_clip(x, n, taus, w, vv),
               kc.centered_clip(xs, taus, w, vv[0]),
               kc.centered_clip(xb[:, :part], taus, w, vv[0])]
        for q, sc in qs:
            out += [*kc.butterfly_clip_fused_dequant(q, sc, n, taus, zz,
                                                     None, w, vv),
                    *kc.mean_digest_fused_dequant(q, sc, n, zz, w)]
        return out

    ref = outputs(g, gb, z, v, wire.values())
    for offset in range(4):
        zz, vv = (_vec_at(z, 1), _vec_at(v, 1)) if offset == 1 else (z, v)
        got = outputs(_at(g, offset), _at(gb, offset), zz, vv,
                      [(_at(q, offset), sc) for q, sc in wire.values()])
        assert all(torch.equal(a, b) for a, b in zip(ref, got)), offset


def _staggered(n, cuda, warm, ragged):
    """An (n, d) stack of 4 partitions (the last ``ragged`` columns short)
    whose spreads differ, so the adaptive loop converges them at different
    iterations (one only at the cap of 12 at tol 1e-3), drawn with numpy;
    a small warm start when ``warm``."""
    P, part = 4, 4096 + 16
    d = P * part - ragged
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, d)).astype(np.float32) / math.sqrt(part)
    g[-1] *= 10.0
    for p, s in enumerate((1.0, 0.05, 0.01, 3.0)):
        g[:, p * part:(p + 1) * part] *= s
    v0 = (0.01 * rng.standard_normal((P, part)).astype(np.float32)
          if warm else None)
    return (torch.from_numpy(g).to(cuda), P,
            None if v0 is None else torch.from_numpy(v0).to(cuda))


def _host_synchronous_adaptive(g, P, tau, tol, max_iters, w, v0):
    """The adaptive loop as it ran before the decision moved to the card:
    the same passes on the global body, with the host reading max
    ||dv||^2 before every iteration and stopping at once, updating a copy
    of v0 in place."""
    k = kc._Stack(g, P)
    k.stage = False
    ww, v = k.weights(w), k.start(v0)
    sq_part, d2_part = k.partials(), k.empty(k.P, k.C)
    sq, cw, wsum = k.empty(k.P, k.n), k.empty(k.P, k.n), k.empty(1)
    tol2 = float(np.float32(tol) ** 2)
    d2 = torch.full((k.P,), math.inf, device=g.device)
    iters = torch.zeros((k.P,), dtype=torch.int32, device=g.device)
    k.sq_pass(v, sq_part)
    k.finish_weights(sq_part, ww, tau, sq, cw, wsum)
    for _ in range(max_iters):
        if not bool((d2 > tol2).any()):
            break
        k.update(v, v, cw, wsum, sq_part=sq_part, d2_part=d2_part, d2=d2,
                 tol2=tol2)
        k.finish_weights(sq_part, ww, tau, sq, cw, d2_part=d2_part, d2=d2,
                         iters=iters, tol2=tol2)
    return v, iters


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [0, 3])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("n", [4, 33])
def test_adaptive_loop_decided_on_card_is_the_host_loop_bitwise(cuda, n,
                                                                  warm,
                                                                  ragged):
    """#3 with partitions that converge at different iterations, some
    before the cap and one at it, on the staged body (4 peers, aligned
    rows) and the global one: iters equals the plain version's exactly
    and the launch count is the cap (one partition steps at every
    iteration, so every step enqueued moves it); agg is within 1e-5 of
    plain and,
    with iters, bit for bit the host-synchronous loop's (whose passes
    load from global memory)."""
    g, P, v0 = _staggered(n, cuda, warm, ragged)
    assert kc._Stack(g, P).stage == (n <= 8 and ragged == 0)
    w = torch.ones((n,), device=cuda)
    w[-2] = 0.0
    tau, tol, cap = 1.0, 1e-3, 12
    plain_v, plain_it = kc.butterfly_clip_adaptive_plain(g, P, tau, tol, cap,
                                                         w, v0)
    its = plain_it.tolist()
    assert max(its) == cap and min(its) < cap and len(set(its)) > 2
    before = kc.LAUNCHES["adaptive_clip_step"]
    v, it = kc.butterfly_clip_adaptive(g, P, tau, tol, cap, w, v0)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["adaptive_clip_step"] - before == cap
    assert torch.equal(it, plain_it)
    torch.testing.assert_close(v, plain_v, rtol=1e-5, atol=1e-5)
    ref_v, ref_it = _host_synchronous_adaptive(g, P, tau, tol, cap, w, v0)
    assert torch.equal(v, ref_v) and torch.equal(it, ref_it)
    # a cap the last partitions do not reach: the same bits as the host
    # loop stopped there
    v, it = kc.butterfly_clip_adaptive(g, P, tau, tol, 3, w, v0)
    ref_v, ref_it = _host_synchronous_adaptive(g, P, tau, tol, 3, w, v0)
    assert torch.equal(v, ref_v) and torch.equal(it, ref_it)


def _strided(x, offset, ld):
    """x's values stored ``offset`` elements into a flat buffer with row
    stride ``ld`` (>= x's width); the buffer's start is 512-byte
    aligned."""
    n, d = x.shape
    flat = torch.zeros(n * ld + offset + 16, dtype=x.dtype, device=x.device)
    out = flat[offset:offset + n * ld].view(n, ld)[:, :d]
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [0, 3])
@pytest.mark.parametrize("n", [4, 8, 16, 33])
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_wire_staged_body_gives_the_float32_twins_bits_on_card(cuda, codec,
                                                               n, ragged):
    """#7 and #8 over int8/bf16 payloads stored at offsets 0-3, with the
    row stride d and one 16-byte aligned above it, with and without a
    ragged tail: up to 8 peers the aligned stacks run the staged body and
    the others the global one, and every one gives the bits of the
    float32 kernels on the dequantized payloads (#1, #5), within 1e-5 of
    plain."""
    from repro_torch.core import compression

    part = 2 * kc.CHUNK + 1024 + 16  # a partial last chunk
    d = n * part - ragged
    g, z, v, w = _inputs(n, d, cuda)
    g[1, :part] = 0.0  # an all-zero payload: int8 scale 0
    q, sc = _wire(g, n, codec)
    xd = compression.wire_grads(g, codec, n)
    taus = [1.0, 0.5, math.inf]
    want_clip = kc.butterfly_clip_fused(xd, n, taus, z, None, w, v)
    want_mean = kc.mean_digest_fused(xd, n, z, w)
    wide = -(-d // 16) * 16 + 16
    for ld in (d, wide):
        for offset in range(4):
            qs = _strided(q, offset, ld)
            staged = (n <= 8 and offset == 0
                      and ld * qs.element_size() % 16 == 0)
            assert kc._Stack(qs, n, sc).stage == staged
            got = kc.butterfly_clip_fused_dequant(qs, sc, n, taus, z, None, w,
                                                  v)
            assert all(torch.equal(a, b) for a, b in zip(got, want_clip)), (
                ld, offset)
            got = kc.mean_digest_fused_dequant(qs, sc, n, z, w)
            assert all(torch.equal(a, b) for a, b in zip(got, want_mean)), (
                ld, offset)
            if offset == 0 and ld == wide:
                _check(lambda: kc.butterfly_clip_fused_dequant(
                           qs, sc, n, taus, z, None, w, v),
                       lambda: kc.butterfly_clip_fused_dequant_plain(
                           qs, sc, n, taus, z, None, w, v),
                       "butterfly_clip_fused_dequant")


@pytest.mark.cuda
def test_adaptive_loop_stops_early_on_card(cuda):
    """On a small stack, where a step takes the card less time than the
    host takes to enqueue one, the finish's readings of d2 reach the host
    through the pinned slots in time: the loop stops enqueuing within a
    few iterations of the last partition's convergence, far below the
    cap, with the host loop's bits; each step enqueued is one launch
    counted."""
    g, P, v0 = _staggered(4, cuda, True, 0)
    w = torch.ones((4,), device=cuda)
    pushes = []

    class Ring(kc._D2Ring):
        def push(self, j):
            pushes.append(j)
            super().push(j)

    cap = 400
    before = kc.LAUNCHES["adaptive_clip_step"]
    v, it = kc._adaptive_clip(kc._Stack(g, P), 1.0, 1e-3, cap, w, v0,
                              ring=Ring)
    assert kc.LAUNCHES["adaptive_clip_step"] - before == len(pushes)
    ref_v, ref_it = _host_synchronous_adaptive(g, P, 1.0, 1e-3, cap, w, v0)
    assert torch.equal(v, ref_v) and torch.equal(it, ref_it)
    last = int(it.max())
    assert last < cap
    assert last <= len(pushes) <= last + kc.ADAPTIVE_RING


@pytest.mark.cuda
def test_adaptive_ring_is_not_reused_while_finishes_are_queued(cuda):
    """The adaptive loop returns while its finishes are still queued on
    the card, each writing d2 into the pinned ring through a mapped
    pointer. A pinned buffer of the ring's size allocated and filled from
    the host right after the call, with no sync, must keep its values
    once the card has drained: the ring is held until its last finish has
    landed, and released after that."""
    n, P, part = 4, 4, 1 << 24  # 1 GiB a read: the card lags the host
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    g = torch.randn((n, P * part), generator=gen, device=cuda)
    cap = kc.ADAPTIVE_RING
    kc.butterfly_clip_adaptive(g, P, 1.0, 1e-30, 2, None, None)  # warm up
    torch.cuda.synchronize()
    kc._release_landed()
    kc._adaptive_clip(kc._Stack(g, P), 1.0, 1e-30, cap, None, None)
    probe = torch.empty((cap, P), dtype=torch.float32, pin_memory=True)
    probe.numpy().fill(7.0)
    held = len(kc._HELD_RINGS)
    torch.cuda.synchronize()
    assert held >= 1
    assert (probe.numpy() == 7.0).all()
    kc._release_landed()
    assert kc._HELD_RINGS == []


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [math.inf, 2e19])
def test_adaptive_loop_at_unbounded_tol_on_card(cuda, tol):
    """A tolerance whose float32 square is +inf freezes every partition
    before its first step: the warm start comes back, as from the plain
    version, with iters 0 and no launch."""
    g, P, v0 = _staggered(4, cuda, True, 0)
    before = kc.LAUNCHES["adaptive_clip_step"]
    with np.errstate(over="ignore"):
        v, it = kc.butterfly_clip_adaptive(g, P, 1.0, tol, 12, None, v0)
        want_v, want_it = kc.butterfly_clip_adaptive_plain(g, P, 1.0, tol,
                                                           12, None, v0)
    torch.cuda.synchronize()
    assert kc.LAUNCHES["adaptive_clip_step"] == before
    assert torch.equal(v, want_v) and torch.equal(it, want_it)
    assert it.tolist() == [0] * P


def _index_order_mean(x, n_parts, w):
    """v of verified:mean as the kernels form it, column by column: the
    weighted sum by one rounding a peer (__fmaf_rn) in index order, then
    one correctly rounded division by max(sum w, 1e-30). Each float32
    operation is taken in float64 and rounded once to float32: exact for
    peer weights in {0, 1}, where the product is exact and a float64 sum
    or quotient of float32 values rounds to the same float32 as the
    operation itself (53 >= 2 * 24 + 2). x (n, d) float32 -> (P, part)."""
    xs = kc.stacked(x, n_parts).double()
    num = torch.zeros((xs.shape[0], xs.shape[2]), dtype=torch.float64,
                      device=x.device)
    for i, wi in enumerate(w.tolist()):
        assert wi in (0.0, 1.0)
        num = (num + wi * xs[:, i]).float().double()
    ws = max(float(np.float32(w.sum().item())), 1e-30)
    return (num / np.float64(np.float32(ws))).float()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 8, 9, 16, 32, 33, 64])
def test_mean_digest_tables_are_the_validators_recompute_bitwise_on_card(
        cuda, n):
    """verified:mean reads the stack once (#5 over float32, #8 over int8
    and bf16 payloads), and its tables are what a validator recomputes:
    s and norms equal #6 (``digest_tables_batched``) run over the stack
    against #5's own v, and #9 (``digest_tables_rows``, tau 0) at two
    sampled partitions, bit for bit; v is the index-order weighted sum
    (``_index_order_mean``); a copy stored with every row start on 16
    bytes (the staged body up to 8 peers) and one an element off (the
    global body) give the same bits; #8 gives #5's bits on the dequantized
    payloads. Four partitions with a partial last chunk and a ragged tail,
    an all-zero payload (int8 scale 0) and a zero weight."""
    from repro_torch.core import compression

    P, rows = 4, [3, 1]
    part = 2 * kc.CHUNK + 1024 + 16
    d = P * part - 3
    rng = np.random.default_rng(n)
    g = torch.from_numpy((rng.standard_normal((n, d)) / math.sqrt(part))
                         .astype(np.float32)).to(cuda)
    g[-1] *= 10.0
    g[0, :part] = 0.0
    z = torch.from_numpy(rng.standard_normal((P, part))
                         .astype(np.float32)).to(cuda)
    z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    w = torch.ones((n,), device=cuda)
    if n > 1:
        w[-2] = 0.0
    wide = -(-d // 16) * 16 + 16
    want5 = None
    for codec in (None, "int8", "bf16"):
        if codec is None:
            x, sc, xd = g, None, g
        else:
            x, sc = _wire(g, P, codec)
            xd = compression.wire_grads(g, codec, P)

        def mean(x, sc=sc):
            if sc is None:
                return kc.mean_digest_fused(x, P, z, w)
            return kc.mean_digest_fused_dequant(x, sc, P, z, w)

        name = ("mean_digest_fused" if sc is None
                else "mean_digest_fused_dequant")
        before = kc.LAUNCHES[name]
        out = mean(x)
        torch.cuda.synchronize()
        assert kc.LAUNCHES[name] - before == 1
        v, s, norms = out
        assert torch.equal(v, _index_order_mean(xd, P, w)), codec
        s6, n6 = kc.digest_tables_batched(xd, P, v, z)
        assert torch.equal(s, s6) and torch.equal(norms, n6), codec
        s9, n9 = kc.digest_tables_rows(xd, P, v, z, rows, 0.0)
        assert torch.equal(s[rows], s9) and torch.equal(norms[rows], n9)
        for offset, ld in ((0, wide), (1, d)):
            xs = _strided(x, offset, ld)
            assert kc._Stack(xs, P, sc).stage == (offset == 0 and n <= 8)
            got = mean(xs)
            assert all(torch.equal(a, b) for a, b in zip(got, out)), (
                codec, offset)
        if codec is None:
            want5 = out
        else:
            twin = kc.mean_digest_fused(xd, P, z, w)
            assert all(torch.equal(a, b) for a, b in zip(out, twin)), codec
    torch.testing.assert_close(
        want5[0], kc.mean_digest_fused_plain(g, P, z, w)[0], rtol=1e-5,
        atol=1e-5)


@pytest.mark.cuda
def test_checkpoint_round_trips_cuda_trees_bitwise_onto_the_examples_device(
        cuda, tmp_path):
    """A bf16 and f32 tree on the card (the launcher's params, momentum and
    carry) saves and loads back bit for bit, each leaf on its example's
    device, bf16 through its 16 bits; a CPU example restores on the CPU."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    tree = {"params": {"emb": torch.randn((1000, 33), generator=gen,
                                          device=cuda).to(torch.bfloat16),
                       "blocks": [torch.randn((7, 5), generator=gen,
                                              device=cuda)]},
            "opt": {"m": torch.randn((70_001,), generator=gen, device=cuda)},
            "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    path = str(tmp_path / "ck.msgpack")
    save_checkpoint(path, tree, step=4, meta={"arch": "x"})
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    example = {"params": {"emb": zeros(tree["params"]["emb"]),
                          "blocks": [zeros(tree["params"]["blocks"][0])]},
               "opt": {"m": zeros(tree["opt"]["m"])},
               "step": zeros(tree["step"])}
    got, step, meta = load_checkpoint(path, example)
    assert step == 4 and meta == {"arch": "x"}
    pairs = [(got["params"]["emb"], tree["params"]["emb"]),
             (got["params"]["blocks"][0], tree["params"]["blocks"][0]),
             (got["opt"]["m"], tree["opt"]["m"]), (got["step"], tree["step"])]
    for a, b in pairs:
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    on_cpu, _, _ = load_checkpoint(path, {"opt": {"m": torch.zeros(70_001)}})
    assert on_cpu["opt"]["m"].device.type == "cpu"
    assert torch.equal(on_cpu["opt"]["m"], tree["opt"]["m"].cpu())


@pytest.mark.cuda
def test_engine_path_builds_and_attacks_its_stack_in_place_on_card(
        cuda, monkeypatch):
    """The trainer's engine path at 8 peers on the toy classifier widened
    to d = 2^20 + 4, its batches made beforehand: the gradients go
    straight into one (8, d) stack (the peak above what was held stays
    within the stack and two rows), and the donated protocol step zeroes
    and sign-flips it in place (its peak stays under one more stack, where
    copying makes two) with every output bit for bit the copying step's.
    z is drawn in blocks of 2^16 (the same bits), so the draw's
    temporaries stay small beside the stack, as they do at full width; one
    gradient beforehand makes the matmul library's workspaces."""
    from repro_torch.core import engine as eng
    from repro_torch.core import prng
    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.models.workload import classification_setup

    monkeypatch.setattr(prng, "NORMAL_BLOCK", 2**16)
    loss_fn, params0, make_batch, _ = classification_setup(dim=2**18,
                                                           device=cuda)
    batches = [make_batch(i, 0, False) for i in range(8)]

    def batch_fn(peer, step, flipped):
        return batches[peer]

    tr = BTARDTrainer(loss_fn, params0, batch_fn, TrainerConfig(
        n_peers=8, byzantine=(7,), attack=AttackConfig(kind="sign_flip"),
        clip_iters=5, m_validators=2, device=cuda))
    n, d = 8, tr.d
    stack_bytes, row_bytes = n * d * 4, d * 4
    flips = eng.flip_mask(tr.engine_config, tr.state, tr.byz_mask)
    tr._grad(tr.params, batches[0])  # makes the library's workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    G, H = tr._grads_fn()(tr.params, 0, flips)
    torch.cuda.synchronize()
    assert H is G and G.shape == (n, d)
    assert torch.cuda.max_memory_allocated() - base <= stack_bytes + 2 * row_bytes
    for i in (0, 5):
        assert torch.equal(G[i], tr._grad(tr.params, batch_fn(i, 0, False)))

    Gc = G.clone()
    st_copy, out_copy = eng.protocol_step(tr.engine_config, tr.state,
                                          tr.byz_mask, Gc, Gc)
    del Gc
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    honest_row = G[7].clone()
    st_don, out_don = eng.protocol_step(tr.engine_config, tr.state,
                                        tr.byz_mask, G, G, donate=True)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base - row_bytes < stack_bytes
    assert torch.equal(G[7], -1000.0 * honest_row)
    for name in out_copy._fields:
        a, b = getattr(out_don, name), getattr(out_copy, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), name
    for name in ("active", "validator", "prev_agg", "ban_step", "ban_reason",
                 "accused_count", "last_checked"):
        assert torch.equal(getattr(st_don, name), getattr(st_copy, name)), name


@pytest.mark.cuda
def test_moe_layer_on_card_matches_cpu_and_repeats_bitwise(cuda,
                                                          monkeypatch):
    """DeepSeek-V2-Lite's MoE routing (64 experts, top-6, 2 shared,
    capacity factor 1.25) at d_model 512, float32, batch 4 x 128 tokens:
    some tokens dropped; the routing equal to the CPU's, y and aux within
    1e-5 of the CPU's and every gradient within 1e-5 of its largest
    value, and the gradients of two runs on the card equal bit for bit
    (the buffer and the combine write each place once, so no float atomic
    meets two terms)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.flatten import tree_leaves, tree_unflatten
    from repro_torch.models import moe

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              d_model=512, d_ff_expert=256, dtype="float32")
    params = moe.moe_init(prng.key(0), cfg)
    gen = torch.Generator().manual_seed(25)
    x = torch.randn((4, 128, 512), generator=gen)
    dy = torch.randn(x.shape, generator=gen)

    def run(device):
        leaves = [t.to(device).requires_grad_(True)
                  for t in tree_leaves(params)]
        xx = x.to(device).requires_grad_(True)
        p = tree_unflatten(params, leaves)
        r = moe.route(p, cfg, xx)
        y, aux = moe.moe_apply(p, cfg, xx)
        grads = torch.autograd.grad((y * dy.to(device)).sum() + aux,
                                    leaves + [xx])
        return r, y.detach(), aux.detach(), grads

    r_cpu, y_cpu, aux_cpu, g_cpu = run("cpu")
    r1, y1, aux1, g1 = run(cuda)
    _, _, _, g2 = run(cuda)
    assert 0 < int((~r_cpu.keeps).sum()) < r_cpu.keeps.numel() // 4
    for name in ("top_e", "slots", "keeps"):
        assert torch.equal(getattr(r1, name).cpu(), getattr(r_cpu, name)), name
    torch.testing.assert_close(y1.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux1.cpu(), aux_cpu, rtol=1e-5, atol=1e-5)
    for a, b, c in zip(g1, g2, g_cpu):
        assert a.is_cuda and torch.equal(a, b)
        # the weight gradients sum up to 512 products in float32, in
        # cuBLAS's order on the card: each element within 1e-5 of its
        # gradient's largest value (12-80 here)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.cuda
def test_reduced_deepseek_run_scan_on_card_bans_as_on_cpu(cuda, monkeypatch):
    """The reduced DeepSeek-V2-Lite (MLA + dense, MLA + MoE) through
    ``run_scan`` for 4 steps, 4 peers, a sign flip on peer 3: on the card
    #1 launches once a step, and the bans, ban steps, reasons and
    accusations are the CPU run's."""
    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.models.workload import lm_setup
    from repro_torch.optim import sgd

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def run(device):
        loss_fn, params0, batch_fn, _ = lm_setup(
            "deepseek-v2-lite-16b", seq_len=16, batch_size=2, device=device)
        tr = BTARDTrainer(loss_fn, params0, batch_fn, TrainerConfig(
            n_peers=4, byzantine=(3,),
            attack=AttackConfig(kind="sign_flip", start_step=0, delay=5),
            tau=1.0, clip_iters=5, m_validators=2, device=device),
            optimizer=sgd(0.05))
        tr.run_scan(4)
        return tr

    before = kc.LAUNCHES["butterfly_clip_fused"]
    card = run(cuda)
    assert kc.LAUNCHES["butterfly_clip_fused"] - before == 4
    cpu = run("cpu")
    assert [r["banned_now"] for r in card.history] == \
        [r["banned_now"] for r in cpu.history]
    assert card.banned == cpu.banned == {3}
    for a, b in zip(card.history, cpu.history):
        assert a["accused_peers"] == b["accused_peers"]
        assert math.isfinite(a["grad_norm"])


# (arch, block, sequence): the local-attention blocks one query block past
# their windows (1024, 2048), the RG-LRU block at an odd length
PUBLISHED_BLOCKS = [("gemma3-27b", "attn_local", 1100),
                    ("recurrentgemma-9b", "attn_local", 2100),
                    ("recurrentgemma-9b", "rglru", 301)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch, mixer, S", PUBLISHED_BLOCKS)
def test_published_width_block_on_card_matches_cpu_and_repeats_bitwise(
        cuda, monkeypatch, arch, mixer, S):
    """One block of Gemma3-27B or RecurrentGemma-9B at its published
    widths, float32 (TF32 off), batch 1: forward and backward on the card
    equal bit for bit over two runs, and y and every gradient within 1e-5
    of the CPU's, relative to its largest value."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec
    from repro_torch.core import prng
    from repro_torch.core.flatten import tree_leaves, tree_unflatten
    from repro_torch.models import transformer as tfm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    spec = LayerSpec(mixer, "dense")
    params = tfm.block_init(prng.key(0, device=cuda), cfg, spec)
    gen = torch.Generator().manual_seed(26)
    x = torch.randn((1, S, cfg.d_model), generator=gen)
    dy = torch.randn(x.shape, generator=gen)

    def run(device):
        leaves = [t.to(device).requires_grad_(True)
                  for t in tree_leaves(params)]
        xx = x.to(device).requires_grad_(True)
        y, _ = tfm.block_apply(tree_unflatten(params, leaves), cfg, spec, xx,
                               torch.arange(S, device=device))
        grads = torch.autograd.grad((y * dy.to(device)).sum(), leaves + [xx])
        return [y.detach()] + list(grads)

    one, two = run(cuda), run(cuda)
    for a, b in zip(one, two):
        assert a.is_cuda and torch.equal(a, b)
    for a, c in zip(one, run("cpu")):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-27b", "recurrentgemma-9b"])
def test_reduced_local_and_rglru_run_scan_on_card_bans_as_on_cpu(
        cuda, monkeypatch, arch):
    """The reduced Gemma3-27B (local + global attention) and
    RecurrentGemma-9B (RG-LRU + local attention) at seq 48, past their
    window of 32, through ``run_scan`` for 4 steps, 4 peers, a sign flip on
    peer 3: on the card #1 launches once a step, and the bans, ban steps
    and accusations are the CPU run's."""
    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.models.workload import lm_setup
    from repro_torch.optim import sgd

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def run(device):
        loss_fn, params0, batch_fn, _ = lm_setup(
            arch, seq_len=48, batch_size=2, device=device)
        tr = BTARDTrainer(loss_fn, params0, batch_fn, TrainerConfig(
            n_peers=4, byzantine=(3,),
            attack=AttackConfig(kind="sign_flip", start_step=0, delay=5),
            tau=1.0, clip_iters=5, m_validators=2, device=device),
            optimizer=sgd(0.05))
        tr.run_scan(4)
        return tr

    before = kc.LAUNCHES["butterfly_clip_fused"]
    card = run(cuda)
    assert kc.LAUNCHES["butterfly_clip_fused"] - before == 4
    cpu = run("cpu")
    assert [r["banned_now"] for r in card.history] == \
        [r["banned_now"] for r in cpu.history]
    assert card.banned == cpu.banned == {3}
    for a, b in zip(card.history, cpu.history):
        assert a["accused_peers"] == b["accused_peers"]
        assert math.isfinite(a["grad_norm"])


# (arch, what, decoder sequence): Whisper-small's self + cross decoder
# block and one encoder layer over its 1500 frames, Llama-3.2-Vision's
# gated cross-attention block over its 1600 patches
CROSS_BLOCKS = [("whisper-small", "decoder", 448),
                ("whisper-small", "encoder", 0),
                ("llama-3.2-vision-11b", "gated", 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch, what, S", CROSS_BLOCKS)
def test_published_width_cross_block_on_card_matches_cpu_and_repeats_bitwise(
        cuda, monkeypatch, arch, what, S):
    """A cross-attending block of Whisper-small or Llama-3.2-Vision, or one
    of Whisper's encoder layers, at its published widths, float32 (TF32
    off), batch 1, the memory (1, encoder_len, d_model) an input too, and
    ``xgate`` 0.5 where the block has one: forward and backward on the
    card equal bit for bit over two runs, and the output and every
    gradient within 1e-5 of the CPU's, relative to its largest value."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DEC_XA, XA
    from repro_torch.core import prng
    from repro_torch.core.flatten import tree_leaves, tree_unflatten
    from repro_torch.models import transformer as tfm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_encoder_layers=1)
    spec = DEC_XA if what == "decoder" else XA
    key = prng.key(0, device=cuda)
    if what == "encoder":
        params = tfm.encoder_init(key, cfg)
    else:
        params = tfm.block_init(key, cfg, spec)
    if what == "gated":
        params["mixer"]["xgate"] = torch.tensor(0.5, device=cuda)
    gen = torch.Generator().manual_seed(27)
    mem = torch.randn((1, cfg.encoder_len, cfg.d_model), generator=gen)
    x = torch.randn((1, S, cfg.d_model), generator=gen)
    dy = torch.randn(mem.shape if what == "encoder" else x.shape,
                     generator=gen)

    def run(device):
        leaves = [t.to(device).requires_grad_(True)
                  for t in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        mm = mem.to(device).requires_grad_(True)
        inputs = [mm]
        if what == "encoder":
            y = tfm.encoder_apply(p, cfg, mm)
        else:
            xx = x.to(device).requires_grad_(True)
            inputs.append(xx)
            y, _ = tfm.block_apply(p, cfg, spec, xx,
                                   torch.arange(S, device=device),
                                   memory=mm)
        grads = torch.autograd.grad((y * dy.to(device)).sum(),
                                    leaves + inputs)
        return [y.detach()] + list(grads)

    one, two = run(cuda), run(cuda)
    for a, b in zip(one, two):
        assert a.is_cuda and torch.equal(a, b)
    for a, c in zip(one, run("cpu")):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-5,
                                   atol=1e-5 * float(c.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_reduced_cross_models_run_scan_on_card_bans_as_on_cpu(
        cuda, monkeypatch, arch):
    """The reduced Whisper-small (encoder, self + cross decoder blocks) and
    Llama-3.2-Vision (projector, SA and gated XA) at seq 16, each peer's
    ``memory_raw`` from the pipeline's extras, through ``run_scan`` for 4
    steps, 4 peers, a sign flip on peer 3: on the card #1 launches once a
    step, and the bans, ban steps and accusations are the CPU run's."""
    from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
    from repro_torch.core.protocol import AttackConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.models.workload import lm_setup
    from repro_torch.optim import sgd

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)

    def run(device):
        loss_fn, params0, _, model = lm_setup(
            arch, seq_len=16, batch_size=2, device=device)
        cfg = model.cfg
        pipe = TokenPipeline(cfg.vocab_size, 16, 2, device=device)
        extras = {"memory_raw": ((cfg.encoder_len, cfg.encoder_dim),
                                 torch.float32)}
        tr = BTARDTrainer(
            loss_fn, params0,
            lambda peer, step, flipped: pipe.device_batch(step, peer,
                                                          extras=extras),
            TrainerConfig(
                n_peers=4, byzantine=(3,),
                attack=AttackConfig(kind="sign_flip", start_step=0, delay=5),
                tau=1.0, clip_iters=5, m_validators=2, device=device),
            optimizer=sgd(0.05))
        tr.run_scan(4)
        return tr

    before = kc.LAUNCHES["butterfly_clip_fused"]
    card = run(cuda)
    assert kc.LAUNCHES["butterfly_clip_fused"] - before == 4
    cpu = run("cpu")
    assert [r["banned_now"] for r in card.history] == \
        [r["banned_now"] for r in cpu.history]
    assert card.banned == cpu.banned == {3}
    for a, b in zip(card.history, cpu.history):
        assert a["accused_peers"] == b["accused_peers"]
        assert math.isfinite(a["grad_norm"])


# (arch, block, prompt): the SSM block past one chunk of 256 (a ragged
# second), DeepSeek-V2-Lite's dense MLA layer (absorbed decode over the
# latent cache), RecurrentGemma-9B's RG-LRU block at an odd length, and
# Whisper-small's self + cross decoder block over its 1500 frames
SERVING_BLOCKS = [("mamba2-2.7b", "ssm", 300),
                  ("deepseek-v2-lite-16b", "mla", 64),
                  ("recurrentgemma-9b", "rglru", 301),
                  ("whisper-small", "decoder", 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch, block, S", SERVING_BLOCKS)
def test_published_width_serving_block_on_card_matches_cpu_and_repeats_bitwise(
        cuda, monkeypatch, arch, block, S):
    """One block of Mamba2-2.7B, DeepSeek-V2-Lite, RecurrentGemma-9B or
    Whisper-small at its published widths, float32 (TF32 off), batch 2:
    prefill of S positions into a cache of S + 4, then 4 decode steps (the
    cross block's without its memory, from the ``mem_k``/``mem_v`` the
    prefill wrote): every output and every cache leaf after each call
    equal bit for bit over two runs on the card, and within 1e-5 of the
    CPU's, relative to its largest value; the SSM's prefill output within
    1e-4: over a chunk of 256 its decays' float32 running sum reaches
    about 10^3, and exp(lcum_i - lcum_j), the JAX package's form, turns
    the sum's rounding (the card and the CPU add in other orders) into
    relative error (2.7e-5 measured on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DEC_XA, MLA_D, RG, SSM
    from repro_torch.core import prng
    from repro_torch.core.flatten import tree_leaves, tree_unflatten
    from repro_torch.models import transformer as tfm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    spec = {"ssm": SSM, "mla": MLA_D, "rglru": RG, "decoder": DEC_XA}[block]
    params = tfm.block_init(prng.key(0, device=cuda), cfg, spec)
    gen = torch.Generator().manual_seed(28)
    xs = [torch.randn((2, S, cfg.d_model), generator=gen)] + \
        [torch.randn((2, 1, cfg.d_model), generator=gen) for _ in range(4)]
    mem = (torch.randn((2, cfg.encoder_len, cfg.d_model), generator=gen)
           if block == "decoder" else None)

    def run(device):
        p = tree_unflatten(params, [t.to(device)
                                    for t in tree_leaves(params)])
        cache = {part: {k: torch.zeros(shape, dtype=dt, device=device)
                        for k, (shape, dt) in leaves.items()}
                 for part, leaves in tfm.block_cache_shapes(
                     cfg, spec, 2, S + 4).items()}
        outs = []
        with torch.inference_mode():
            y, _ = tfm.block_apply(
                p, cfg, spec, xs[0].to(device),
                torch.arange(S, device=device),
                memory=None if mem is None else mem.to(device),
                cache=cache, mode="prefill")
            outs += [y] + [t.clone() for t in tree_leaves(cache)]
            for i, x in enumerate(xs[1:]):
                y, _ = tfm.block_apply(
                    p, cfg, spec, x.to(device),
                    torch.full((2,), S + i, device=device), cache=cache,
                    mode="decode")
                outs += [y] + [t.clone() for t in tree_leaves(cache)]
        return outs

    one, two = run(cuda), run(cuda)
    for a, b in zip(one, two):
        assert a.is_cuda and torch.equal(a, b)
    for n, (a, c) in enumerate(zip(one, run("cpu"))):
        tol = 1e-4 if block == "ssm" and n == 0 else 1e-5
        torch.testing.assert_close(a.cpu(), c, rtol=tol,
                                   atol=tol * float(c.abs().max()))
