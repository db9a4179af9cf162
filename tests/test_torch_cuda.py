"""Kernels #1-#11 on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (rtol = atol = 1e-5), bitwise repeatable,
launch counted; the wire-payload twins #7 and #8 give the bits of #1 and
#5 on the dequantized payloads, and the sampled-digest kernel #9 gives, row
for row, the bits of #2 (tau > 0) or #6 (tau = 0) at the sampled
partitions; the single-partition kernels #10 and #11 (one launch owner's
stack) give the bits of #1 and #2 at one partition. Marked ``cuda``; skips
without a CUDA device. Run on the GPU
machine with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import centered_clip as kc

SHAPES = [(4, 4 * 517 - 3), (5, 5 * 1001 - 3), (16, 16 * 3000 + 5)]


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
