"""Kernels #1-#8 on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (rtol = atol = 1e-5), bitwise repeatable,
launch counted; the wire-payload twins #7 and #8 give the bits of #1 and
#5 on the dequantized payloads. Marked ``cuda``; skips without a CUDA device. Run on the
GPU machine with

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
