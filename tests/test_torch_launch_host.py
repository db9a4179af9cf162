"""The launch path's host half on the CPU, against the JAX package in
process: ``core.sybil``'s ``HostMembership`` and ``parse_churn`` (random
schedules of joins, leaves, bans and probation probes give the same
lifecycle, identities, ban ledger, log and checkpoint tree), the ban
policy's ``checksum_offender_peers`` with ``checksum_violations`` and
``delta_max_votes`` (equal results on random tables), and
``TokenPipeline.batch`` (the host entry: the tokens of the JAX pipeline,
bit for bit). All of it is integer or boolean output, so every comparison
is exact, except the checksum sums (float32 sums of the same four terms:
rtol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.core import sybil as jsybil
from repro.data.pipeline import TokenPipeline as JPipeline
from repro_torch.core import butterfly as tbf
from repro_torch.core import sybil as tsybil
from repro_torch.data import TokenPipeline as TPipeline

N = 6


def _schedule(seed, steps=24):
    """A random churn string and, per step, the slots to ban and a probe
    row (zero = a clean spot-check)."""
    rng = np.random.default_rng(seed)
    events = [f"{rng.choice(['join', 'leave'])}@{rng.integers(steps)}:"
              f"{rng.integers(N)}" for _ in range(10)]
    bans = [set(rng.choice(N, rng.integers(0, 2)).tolist())
            if rng.random() < 0.3 else set() for _ in range(steps)]
    probes = [np.where(rng.random(N) < 0.1, 1.0, 0.0) for _ in range(steps)]
    return ",".join(events), bans, probes


def _drive(mod, churn, bans, probes, start_vacant):
    mem = mod.HostMembership(N, probation_steps=2,
                             events=mod.parse_churn(churn),
                             start_vacant=start_vacant)
    trace = []
    for step, (ban, probe) in enumerate(zip(bans, probes)):
        mem.apply_events(step)
        newly = mem.ban_slots(ban, step)
        mem.observe_probe(probe, step)
        trace.append((mem.weights().tolist(), mem.probation_mask().tolist(),
                      mem.banned_slots(), list(newly)))
    return mem, trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("start_vacant", [(), (1, 4)])
def test_host_membership_matches_jax(seed, start_vacant):
    churn, bans, probes = _schedule(seed)
    jmem, jtrace = _drive(jsybil, churn, bans, probes, start_vacant)
    tmem, ttrace = _drive(tsybil, churn, bans, probes, start_vacant)
    assert ttrace == jtrace
    assert tmem.summary() == jmem.summary()
    assert tmem.log == jmem.log
    assert tmem.banned_identities == jmem.banned_identities
    jt, tt = jmem.to_tree(), tmem.to_tree()
    assert sorted(tt) == sorted(jt)
    for k in jt:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]))
    fresh = tsybil.HostMembership(N).restore_tree(tt)
    assert fresh.summary() == tmem.summary()


@pytest.mark.parametrize("bad", ["join@3", "hop@3:1", "leave@x:1"])
def test_parse_churn_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        jsybil.parse_churn(bad)
    with pytest.raises(ValueError) as terr:
        tsybil.parse_churn(bad)
    assert str(terr.value) == str(jerr.value)


def test_parse_churn_matches_jax():
    text = " leave@6:1, join@8:1,,join@9:3 "
    assert [vars(e) for e in tsybil.parse_churn(text)] == \
        [vars(e) for e in jsybil.parse_churn(text)]


@pytest.mark.parametrize("seed", range(8))
def test_ban_policy_tables_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4
    s = (rng.standard_normal((n, n)) * 1e-3).astype(np.float32)
    s[:, rng.integers(n)] *= 1e3  # one owner's checksum is off
    norms = np.abs(rng.standard_normal((n, n))).astype(np.float32) * 3
    w = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.from_numpy(weights)
        js, jv = jbf.checksum_violations(jnp.asarray(s), jw, 1e-2)
        ts, tv = tbf.checksum_violations(torch.from_numpy(s), tw, 1e-2)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jvotes, jmaj = jbf.delta_max_votes(jnp.asarray(norms), jw, 2.0)
        tvotes, tmaj = tbf.delta_max_votes(torch.from_numpy(norms), tw, 2.0)
        np.testing.assert_array_equal(tvotes.numpy(), np.asarray(jvotes))
        np.testing.assert_array_equal(tmaj.numpy(), np.asarray(jmaj))
        cs = np.abs(np.asarray(js))
        want = jbf.checksum_offender_peers(cs).tolist()
        assert tbf.checksum_offender_peers(cs).tolist() == want
        assert tbf.checksum_offender_peers(torch.from_numpy(cs)).tolist() \
            == want
    assert want  # the inflated owner is named


@pytest.mark.parametrize("step", [0, 3, 271])
def test_pipeline_batch_is_the_jax_host_batch(step):
    want = np.asarray(JPipeline(30000, 64, 8).batch(step)["tokens"])
    got = TPipeline(30000, 64, 8).batch(step)["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_schedules_exercise_every_transition():
    """The random schedules are not vacuous: across them slots leave, fresh
    identities join, clean probation windows admit, failed spot-checks and
    checksum/audit offenders ban."""
    log = []
    for seed in range(6):
        for start_vacant in ((), (1, 4)):
            mem, _ = _drive(tsybil, *_schedule(seed), start_vacant)
            log += mem.log
    for what in ("left", "joined", "admitted", "spot-check failed",
                 ": banned"):
        assert any(what in line for line in log), what
