"""The port's threefry generator (repro_torch.core.prng) against jax.random
in the partitionable mode tests/conftest.py sets: integer bits, fold_in,
split, uniform, randint and bernoulli bit for bit; normal within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 12345, 2**31 - 5]
SHAPES = [(), (5,), (3, 7), (1000,)]


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
    for data in (0, 3, 123456, 2**31 - 1):
        np.testing.assert_array_equal(
            _kd(jax.random.fold_in(jk, data)), prng.fold_in(tk, data).numpy())
    for num in (2, 3, 6):
        np.testing.assert_array_equal(
            _kd(jax.random.split(jk, num)), prng.split(tk, num).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64),
        prng.bits(tk, shape).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, shape)),
                                  prng.uniform(tk, shape).numpy())
    for p in (0.2, 0.5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, p, shape)),
            prng.bernoulli(tk, p, shape).numpy())


@pytest.mark.parametrize("bounds", [(0, 10), (0, 512), (0, 30000), (-5, 7),
                                    (0, 2**31 - 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equal_jax(seed, bounds):
    """The two-draw bias-reduced construction, every span class."""
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    lo, hi = bounds
    for shape in ((), (4,), (2, 33)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, shape, lo, hi)).astype(np.int64),
            prng.randint(tk, shape, lo, hi).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_1e6(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    # 2e5 draws reach |z| ~ 4.5, where erfinv magnifies any error in w
    for shape in ((3, 7), (4, 1000), (200000,)):
        a = np.asarray(jax.random.normal(jk, shape))
        b = prng.normal(tk, shape).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_engine_key_chain_seed_and_directions_equal_jax():
    """The MPRNG seed of a step (fold(fold(key, t), 0) -> randint) is exact,
    and the unit directions z drawn from it agree within 1e-6."""
    from repro.core import butterfly as jbf
    from repro_torch.core import butterfly as tbf

    for t in range(3):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), t), 0)
        tk = prng.fold_in(prng.fold_in(prng.key(0), t), 0)
        js = jax.random.randint(jk, (), 0, jnp.int32(2**31 - 1), jnp.int32)
        ts = prng.randint(tk, (), 0, 2**31 - 1)
        assert int(js) == int(ts)
        np.testing.assert_allclose(
            tbf.get_random_directions(ts, 4, 300).numpy(),
            np.asarray(jbf.get_random_directions(js, 4, 300)), atol=1e-6)


@pytest.mark.parametrize("shape, block", [((3, 37), 16), ((4, 300), 7),
                                          ((5000,), 1000)])
def test_blocked_normal_is_the_one_shot_draw_bitwise(shape, block,
                                                     monkeypatch):
    """A draw above ``NORMAL_BLOCK`` elements goes in blocks through
    ``offset``: the bits of one draw, at any block size."""
    tk = prng.key(11)
    one, one5 = prng.normal(tk, shape), prng.normal(tk, shape, offset=5)
    monkeypatch.setattr(prng, "NORMAL_BLOCK", block)
    assert torch.equal(prng.normal(tk, shape), one)
    assert torch.equal(prng.normal(tk, shape, offset=5), one5)


def test_blocked_directions_equal_the_one_shot_draw(monkeypatch):
    """So do the unit directions z drawn under a small ``NORMAL_BLOCK``."""
    from repro_torch.core import butterfly as tbf

    seed = prng.randint(prng.key(2), (), 0, 2**31 - 1)
    one = tbf.get_random_directions(seed, 4, 300)
    monkeypatch.setattr(prng, "NORMAL_BLOCK", 64)
    assert torch.equal(tbf.get_random_directions(seed, 4, 300), one)
