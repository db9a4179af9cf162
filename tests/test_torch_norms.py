"""The port's float32 norms (``core/norms.vector_norm``) on the CPU: within
1e-6 of a float64 norm at d = 1e7 and over rows of (4, 1.6e6), where
torch's own float32 ``linalg.vector_norm`` errs by 2.4e-5 to 3.7e-4; the
shapes and dtypes of ``torch.linalg.vector_norm`` for every ``dim`` and
``keepdim``."""
import numpy as np
import pytest
import torch

from repro_torch.core.norms import vector_norm


@pytest.mark.parametrize("shape, dim", [((10_000_000,), None),
                                        ((4, 1_600_000), 1),
                                        ((4, 1_600_000), -1),
                                        ((2, 3, 1_000_000), 2)])
def test_norm_within_1e_6_of_float64(shape, dim):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = np.sqrt((x.astype(np.float64) ** 2).sum(axis=dim))
    out = vector_norm(torch.from_numpy(x), dim=dim)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy().astype(np.float64), ref,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dim", [None, 0, 1, 2, -1])
@pytest.mark.parametrize("keepdim", [False, True])
def test_norm_has_torchs_shapes(dim, keepdim):
    x = torch.randn(3, 5, 7)
    out = vector_norm(x, dim=dim, keepdim=keepdim)
    want = torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)
    assert out.shape == want.shape and out.dtype == want.dtype
    torch.testing.assert_close(out, want, rtol=1e-5, atol=0)
