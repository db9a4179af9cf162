"""The port's wire codecs (repro_torch.core.compression) against the JAX
package's (repro.core.compression): quantize, dequantize and wire_grads
give the same BITS (exact f32 math: IEEE division, round half to even,
one multiply), over ragged shapes, extreme magnitudes and all-zero
payloads; the compressed:* grammar round-trips to the JAX strings; the
compressed aggregation with its tables matches the JAX package's (the
kernels' plain versions here, within 1e-5) and equals the inner spec run
over the wire values."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import verification as jverif
from repro.core.aggregators import AggregatorSpec as JSpec
from repro_torch.core import compression as tcomp
from repro_torch.core import verification as tverif
from repro_torch.core.aggregators import AggregatorSpec as TSpec

TOL = dict(rtol=1e-5, atol=1e-5)
CODECS = ("int8", "bf16")


def _x(seed, shape, expo=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 ** expo).astype(np.float32)
    x.flat[::7] = np.round(x.flat[::7] * 4) / 4  # ties for round-half-even
    return x


def _bits(t):
    """A tensor's raw bits as numpy (bf16 via its 16-bit pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def _jbits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("expo", [-20, 0, 20])
@pytest.mark.parametrize("codec", CODECS)
def test_codecs_equal_jax_bitwise(codec, expo):
    """quantize (wire and scales), dequantize and roundtrip over the last
    axis, with an all-zero payload and exact .5 ties."""
    x = _x(100 + expo, (3, 5, 37), expo)
    x[1, 2] = 0.0
    jq, js = jcomp.quantize(jnp.asarray(x), codec)
    tq, ts = tcomp.quantize(torch.from_numpy(x), codec)
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))
    np.testing.assert_array_equal(_bits(tcomp.dequantize(tq, ts)),
                                  _jbits(jcomp.dequantize(jq, js)))
    np.testing.assert_array_equal(
        _bits(tcomp.roundtrip(torch.from_numpy(x), codec)),
        _jbits(jcomp.roundtrip(jnp.asarray(x), codec)))
    if codec == "int8":
        assert float(ts[1, 2]) == 0.0 and not tq[1, 2].any()


@pytest.mark.parametrize("d", [64, 61, 5])
@pytest.mark.parametrize("codec", CODECS)
def test_wire_grads_equal_jax_bitwise(codec, d):
    """wire_grads over the butterfly payloads (n_parts = n), ragged or not,
    and quantize_grads' (n, d) payloads with their (n_parts, n) scales,
    whose dequantized values are the same bits."""
    n = 4
    G = _x(7 + d, (n, d))
    G[2, :-(-d // n)] = 0.0  # an all-zero payload
    tw = tcomp.wire_grads(torch.from_numpy(G), codec, n)
    jw = jcomp.wire_grads(jnp.asarray(G), codec, n)
    np.testing.assert_array_equal(_bits(tw.contiguous()), _jbits(jw))
    q, sc = tcomp.quantize_grads(torch.from_numpy(G), codec, n)
    assert q.shape == (n, d) and sc.shape == (n, n)
    from repro_torch.kernels import centered_clip as tkc

    xd = tcomp.dequantize(tkc.stacked(q, n), sc)  # (n_parts, n, part)
    back = xd.transpose(0, 1).reshape(n, -1)[:, :d]
    np.testing.assert_array_equal(_bits(back.contiguous()), _jbits(jw))


@pytest.mark.parametrize("text", [
    "compressed:butterfly_clip",
    "compressed:verified:mean",
    "compressed:verified:mean:codec=bf16",
    "compressed:butterfly_clip:n_iters=20,codec=bf16",
    "compressed:verified:trimmed_mean:trim_ratio=0.25,codec=int8",
    "compressed:mean",
])
def test_compressed_grammar_round_trips_like_jax(text):
    t, j = TSpec.parse(text), JSpec.parse(text)
    assert t.canonical() == j.canonical()
    assert TSpec.parse(t.canonical()) == t
    assert t.params == j.params and t.param_dict() == j.param_dict()
    assert (t.verifiable, t.warm_startable, t.coordinatewise) == \
        (j.verifiable, j.warm_startable, j.coordinatewise)
    assert tcomp.inner_spec(t).canonical() == \
        jcomp.inner_spec(j).canonical()
    assert tcomp.codec_of(t) == jcomp.codec_of(j)
    assert tverif.has_zero_checksum(t) == jverif.has_zero_checksum(j)


def test_compressed_combinator_and_registry_like_jax():
    from repro.core.aggregators import REGISTRY as JREG
    from repro_torch.core.aggregators import REGISTRY as TREG

    assert sorted(n for n in TREG if n.startswith("compressed:")) == \
        sorted(n for n in JREG if n.startswith("compressed:"))
    for name in ("butterfly_clip", "verified:mean", "mean"):
        for codec in (None, "bf16"):
            assert tcomp.compressed(name, codec).canonical() == \
                jcomp.compressed(name, codec).canonical()
    with pytest.raises(ValueError):
        tcomp.compressed("butterfly_clip", "fp4")
    for compressed in (tcomp.compressed, jcomp.compressed):
        with pytest.raises(ValueError, match="not coordinatewise"):
            compressed("krum")


SPECS = [
    "compressed:butterfly_clip:n_iters=8",
    "compressed:butterfly_clip:n_iters=8,adaptive_tol=1e-3",
    "compressed:verified:mean",
    "compressed:verified:coordinate_median:codec=bf16",
    "compressed:verified:mean:codec=bf16",
]


@pytest.mark.parametrize("with_z", [True, False])
@pytest.mark.parametrize("text", SPECS)
def test_compressed_aggregate_matches_jax(text, with_z):
    """The aggregate and tables over the wire values: the port's
    compressed_aggregate (the dequantizing kernels' plain versions for
    butterfly_clip and verified:mean with tables) against the JAX package's
    on its Pallas path, with zero weights; and the tables recomputed
    against a given aggregate over the wire values."""
    n, d = 4, 4 * 300 - 7
    G = _x(3, (n, d), -3)
    part = -(-d // n)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((n, part)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    jz = jnp.asarray(z) if with_z else None
    tz = torch.from_numpy(z) if with_z else None
    ja, jparts, js, jn, jit = jverif.spec_aggregate(
        JSpec.parse(text), jnp.asarray(G), z=jz, weights=jnp.asarray(w),
        use_pallas=True)
    ta, ts, tn, tit = tverif.spec_aggregate(
        TSpec.parse(text), torch.from_numpy(G), z=tz,
        weights=torch.from_numpy(w))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    assert tit == int(jit)
    if with_z:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
        codec = tcomp.codec_of(TSpec.parse(text))
        tw = tcomp.wire_grads(torch.from_numpy(G), codec, n)
        js2, jn2 = jverif.spec_tables(JSpec.parse(text), jparts, ja, jz)
        ts2, tn2 = tverif.spec_tables(TSpec.parse(text), tw, ta, tz)
        np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), **TOL)
        np.testing.assert_allclose(tn2.numpy(), np.asarray(jn2), **TOL)
    else:
        assert ts is None and tn is None


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_aggregate_equals_inner_over_wire(codec):
    """compressed:<spec> is the inner spec run over wire_grads, bit for
    bit, on the plain path."""
    n, d = 4, 203
    G = torch.from_numpy(_x(5, (n, d)))
    part = -(-d // n)
    z = torch.from_numpy(_x(6, (n, part)))
    wire = tcomp.wire_grads(G, codec, n)
    for inner in ("butterfly_clip:n_iters=6", "verified:mean",
                  "verified:trimmed_mean"):
        spec = tcomp.compressed(TSpec.parse(inner), codec)
        a = tverif.spec_aggregate(spec, G, z=z)
        b = tverif.spec_aggregate(TSpec.parse(inner), wire.contiguous(), z=z)
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x, y), inner
