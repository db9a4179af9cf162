"""The port's Sybil gate and MPRNG against the JAX package's: the engine's
probation_check / probation_step give exactly the JAX functions' masks and
counters; SybilGate, seeded alike, admits and rejects the same identities
at the same rounds; and repro_torch.core.mprng gives the same value, bans
and rounds as repro.core.mprng on the transcripts of tests/test_mprng.py
(honest peers, a lying peer, the aborting attacker over 40 seeds, 200
draws of 4 honest peers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mprng as jmprng
from repro.core import sybil as jsybil
from repro_torch.core import mprng as tmprng
from repro_torch.core import sybil as tsybil


@pytest.mark.parametrize("seed", range(4))
def test_probation_gate_equals_jax(seed):
    """Random probation masks, payload mismatches and clean counters over
    a few steps: the same mismatches, counters, promotions and bans."""
    rng = np.random.default_rng(seed)
    n, d, window = 9, 5, 3
    clean = np.zeros(n, np.int32)
    jclean, tclean = jnp.asarray(clean), torch.from_numpy(clean)
    for _ in range(6):
        G = rng.standard_normal((n, d)).astype(np.float32)
        H = G.copy()
        H[rng.random(n) < 0.2, rng.integers(0, d)] += 1.0
        prob = rng.random(n) < 0.6
        jm = jsybil.probation_check(jnp.asarray(G), jnp.asarray(H),
                                    jnp.asarray(prob))
        tm = tsybil.probation_check(torch.from_numpy(G), torch.from_numpy(H),
                                    torch.from_numpy(prob))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jout = jsybil.probation_step(jnp.asarray(prob), jm, jclean, window)
        tout = tsybil.probation_step(torch.from_numpy(prob), tm, tclean,
                                     window)
        for t, j in zip(tout, jout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        jclean, tclean = jout[0], tout[0]
    assert (tclean.numpy() >= 0).all()


def _grad_fn(pid, t, params, flipped):
    rng = np.random.default_rng(pid * 1000 + t)
    return rng.standard_normal(16).astype(np.float32) + params


@pytest.mark.parametrize("seed, check_prob", [(0, 0.5), (1, 0.5), (2, 0.9),
                                              (3, 0.2)])
def test_sybil_gate_admits_and_rejects_like_jax(seed, check_prob):
    gates = [mod.SybilGate(_grad_fn, probation_steps=5,
                           check_prob=check_prob, seed=seed)
             for mod in (jsybil, tsybil)]
    for gate in gates:
        for pid in range(8):
            gate.request_join(pid, 0, dishonest=pid % 3 == 0)
    for t in range(12):
        if t == 4:
            for gate in gates:
                gate.request_join(20, t, dishonest=True)
                gate.request_join(21, t)
        j, p = (g.step(np.float32(0.5), t) for g in gates)
        assert j == p, (t, j, p)
    admitted, rejected = p
    # every honest identity is admitted; only dishonest ones are rejected
    # (a dishonest one may slip through unchecked rounds: App. F's odds)
    assert {1, 2, 4, 5, 7, 21} <= set(admitted)
    assert set(rejected) <= {0, 3, 6, 20} and rejected


def _peers(mod, kinds):
    return [getattr(mod, kind)(i) for i, kind in enumerate(kinds)]


@pytest.mark.parametrize("kinds, seeds", [
    (["MPRNGPeer"] * 8, range(2)),
    (["MPRNGPeer"] * 7 + ["LyingPeer"], [1]),
    (["MPRNGPeer"] * 7 + ["AbortingPeer"], range(40)),
    (["MPRNGPeer", "AbortingPeer", "MPRNGPeer", "LyingPeer"], range(5)),
])
def test_mprng_transcripts_equal_jax(kinds, seeds):
    for seed in seeds:
        j = jmprng.run_mprng(_peers(jmprng, kinds),
                             np.random.default_rng(seed))
        t = tmprng.run_mprng(_peers(tmprng, kinds),
                             np.random.default_rng(seed))
        assert t == j, (seed, t, j)


def test_mprng_repeated_draws_equal_jax():
    """200 draws of 4 honest peers from one generator, as the JAX
    package's uniformity test makes them."""
    jr, tr = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(200):
        assert (tmprng.run_mprng(_peers(tmprng, ["MPRNGPeer"] * 4), tr)
                == jmprng.run_mprng(_peers(jmprng, ["MPRNGPeer"] * 4), jr))
