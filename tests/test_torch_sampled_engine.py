"""The port's protocol engine under sampled-digest audits (``audit_k``), the
hierarchical butterfly (``groups``) and both together, against the JAX
package's engine: over modes x specs x attacks, scanned steps give EXACTLY
the same seeds, validators, accusation matrices, system accusations, ban
sets, ban steps and reasons, ``col_checked`` ledgers and sampled columns,
and g_hat within 1e-5. Then the properties of the JAX package's
tests/test_sampled_hier.py on the port alone: the ledger stays within
``staleness_bound``, honest runs accuse no one, sampling leaves the
aggregate alone, and an unsampled cheating aggregator is banned within the
window."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.protocol import AttackConfig as JAttack
from repro_torch.core import engine as teng
from repro_torch.core import hierarchy as thier
from repro_torch.core.protocol import AttackConfig as TAttack

N, D = 8, 61  # part = 8 flat, 16 per group of 4: ragged
BYZ = (5, 6)
MODES = {
    "sampled": dict(audit_k=1),
    "hier": dict(groups=2),
    "hier_sampled": dict(groups=2, audit_k=1),
}
SPECS = {
    "butterfly_clip": None,
    "verified_mean": "verified:mean",
    "verified_trimmed_mean": "verified:trimmed_mean:trim_ratio=0.25",
    "compressed_butterfly_clip": "compressed:butterfly_clip",
}
ATTACKS = {
    "sign_flip": dict(kind="sign_flip"),
    "alie": dict(kind="alie"),
    "aggregator": dict(kind="none", aggregator_attack=True,
                       aggregator_scale=5.0),
}
STEP_OUTPUTS = ("seed", "validators", "banned_now", "ban_reason_now",
                "accuse_mat", "sys_accuse", "cheated", "checksum_violations",
                "check_averaging", "n_active", "sampled_parts")
STATE = ("active", "validator", "ban_step", "ban_reason", "accused_count",
         "last_checked", "col_checked")


def _byz(n=N, byz=BYZ):
    return np.array([1.0 if i in byz else 0.0 for i in range(n)], np.float32)


def _linear_problem(steps, n=N, d=D, seed=11):
    """Public-seed linear regression per (step, peer): G depends on the
    parameters, so the aggregate feeds back into the next step."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((steps, n, 4, d)).astype(np.float32)
    w_true = rng.standard_normal(d).astype(np.float32)
    y = np.einsum("tnbd,d->tnb", X, w_true).astype(np.float32)
    return X, y


def _grads_fns(X, y):
    jX, jy = jnp.asarray(X), jnp.asarray(y)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)

    def jgrads(p, t, flips):
        r = jnp.einsum("nbd,d->nb", jX[t], p) - jy[t]
        G = 2.0 * jnp.einsum("nbd,nb->nd", jX[t], r) / 4.0
        return G, G

    def tgrads(p, t, flips):
        r = torch.einsum("nbd,d->nb", tX[t], p) - ty[t]
        G = 2.0 * torch.einsum("nbd,nb->nd", tX[t], r) / 4.0
        return G, G

    return jgrads, tgrads


@pytest.mark.parametrize("attack", list(ATTACKS))
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("mode", list(MODES))
def test_scanned_steps_equal_jax(mode, spec, attack):
    steps = 5
    kw = dict(tau=1.0, clip_iters=20, m_validators=2,
              aggregator=SPECS[spec], **MODES[mode])
    jcfg = jeng.config_from_attack(N, D, JAttack(**ATTACKS[attack]), **kw)
    tcfg = teng.config_from_attack(N, D, TAttack(**ATTACKS[attack]), **kw)
    jgrads, tgrads = _grads_fns(*_linear_problem(steps))
    jst, jp, jouts = jeng.scan_protocol(
        jcfg, jeng.init_state(jcfg, seed=0), jnp.asarray(_byz()),
        jnp.zeros((D,), jnp.float32), jgrads, steps,
        update_fn=lambda p, g, t: p - 0.05 * g)
    tst, tp, touts = teng.scan_protocol(
        tcfg, teng.init_state(tcfg, seed=0, device="cpu"),
        torch.from_numpy(_byz()), torch.zeros(D), tgrads, steps,
        update_fn=lambda p, g, t: p - 0.05 * g)
    # the mean-based specs let the first step's 1000x sign flip into the
    # aggregate, so the parameters reach ~1e6, where the two frameworks'
    # float32 summation orders differ at 1e-5 of that scale
    scale = max(1.0, float(np.abs(np.asarray(jp)).max()))
    for k, tout in enumerate(touts):
        jout = jax.tree.map(lambda a: a[k], jouts)
        for name in STEP_OUTPUTS:
            np.testing.assert_array_equal(
                np.asarray(getattr(tout, name)),
                np.asarray(getattr(jout, name)), err_msg=f"step {k} {name}")
        assert tout.clip_iters_used == int(jout.clip_iters_used)
        np.testing.assert_allclose(tout.g_hat.numpy(),
                                   np.asarray(jout.g_hat), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"step {k}")
    assert tst.step == int(jst.step)
    for name in STATE:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tst.prev_agg.numpy(), np.asarray(jst.prev_agg),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5 * scale)
    if attack != "aggregator":
        assert (tst.ban_step.numpy()[list(BYZ)] >= 0).all()


def test_config_validates_like_jax():
    for kw in (dict(audit_k=0), dict(groups=3), dict(groups=4, n=4)):
        args = dict(n=8, d=16)
        args.update(kw)
        with pytest.raises(ValueError):
            jeng.EngineConfig(**args)
        with pytest.raises(ValueError):
            teng.EngineConfig(**args)
    cfg = teng.EngineConfig(n=8, d=16, groups=2, audit_k=1)
    assert cfg.hierarchical and not teng.EngineConfig(n=8, d=16,
                                                      groups=1).hierarchical


# ---------------------------------------------------------------------------
# The properties of tests/test_sampled_hier.py, on the port
# ---------------------------------------------------------------------------
PN, PD = 16, 64


def _noise_grads(n=PN, d=PD):
    """iid noise around a fixed descent direction, from numpy."""
    rng = np.random.default_rng(7)
    mu = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32))
    noise = torch.from_numpy(
        rng.standard_normal((64, n, d)).astype(np.float32))

    def grads_fn(params, t, flips):
        G = mu[None] + noise[t]
        return G, G

    return grads_fn


def _run(steps, byz=(), aggregator="verified:mean", m=2, **kw):
    cfg = teng.EngineConfig(n=PN, d=PD, tau=1.0, clip_iters=10,
                            m_validators=m, aggregator=aggregator, **kw)
    state, _, outs = teng.scan_protocol(
        cfg, teng.init_state(cfg, seed=0, device="cpu"),
        torch.from_numpy(_byz(PN, byz)), torch.zeros(()), _noise_grads(),
        steps)
    return cfg, state, outs


@pytest.mark.parametrize("groups", [None, 4])
def test_sampled_ledger_stays_within_staleness_bound(groups):
    """The gap between two broadcasts of any column never exceeds
    staleness_bound (+1 for the ledger's end-of-step update)."""
    m, k = 2, 2
    bound = thier.staleness_bound(PN, m, k)
    steps = 4 * bound
    _, state, outs = _run(steps, m=m, audit_k=k, groups=groups)
    samp = torch.stack([o.sampled_parts for o in outs]).numpy()
    assert samp.shape == (steps, PN)
    assert (samp.sum(axis=1) == thier.sampled_k(PN, m, k)).all()
    for c in range(PN):
        hits = np.nonzero(samp[:, c])[0]
        assert len(hits) > 0, f"column {c} never sampled"
        gaps = np.diff(np.concatenate([[-1], hits]))
        assert gaps.max() <= bound + 1
    assert (state.col_checked >= 0).all()
    assert ((state.step - 1 - state.col_checked) <= bound).all()


@pytest.mark.parametrize("kw", [dict(audit_k=2), dict(groups=4),
                                dict(audit_k=2, groups=4)],
                         ids=["sampled", "hier", "hier_sampled"])
@pytest.mark.parametrize("aggregator", [
    "verified:mean", "verified:trimmed_mean:trim_ratio=0.25"])
def test_honest_run_no_bans_no_accusations(kw, aggregator):
    _, state, outs = _run(12, aggregator=aggregator, **kw)
    assert (state.ban_step == -1).all()
    for out in outs:
        assert not out.accuse_mat.any() and not out.sys_accuse.any()
        assert int(out.checksum_violations) == 0


@pytest.mark.parametrize("aggregator", [
    "verified:trimmed_mean:trim_ratio=0.25", "verified:mean", None])
def test_sampling_does_not_change_the_aggregate(aggregator):
    """audit_k shrinks the digest tables, not the aggregation. Where the
    aggregation is the same code with and without tables (the trimmed mean)
    the g_hat streams are equal bit for bit; the mean and the flagship
    aggregate through another kernel when no tables are fused in (the
    torch mean instead of #5, #4 instead of #1), so there they agree to
    float32 rounding."""
    _, _, full = _run(8, aggregator=aggregator)
    _, _, sampled = _run(8, aggregator=aggregator, audit_k=1)
    for f, s in zip(full, sampled):
        if aggregator and "trimmed" in aggregator:
            assert torch.equal(f.g_hat, s.g_hat)
        else:
            torch.testing.assert_close(s.g_hat, f.g_hat, rtol=1e-5,
                                       atol=1e-6)
        assert torch.equal(f.banned_now, s.banned_now)


def test_hier_mean_matches_flat_mean():
    """The two-level weighted mean equals the flat mean (equal weights)."""
    _, _, flat = _run(6)
    _, _, h = _run(6, groups=4)
    for f, g in zip(flat, h):
        torch.testing.assert_close(g.g_hat, f.g_hat, rtol=0, atol=1e-4)


def test_unsampled_cheating_aggregator_banned_within_window():
    """A lying aggregator (corrupts its partition, cancels the checksum)
    under audit_k = 1, m = 1: its column is unseen while unsampled, but the
    age-priority draw reaches it within the staleness window, and the
    validators' peer audit runs beside it."""
    m, k = 1, 1
    liar = 3
    bound = max(thier.staleness_bound(PN, m, k), PN // m + 2)
    cfg = teng.EngineConfig(n=PN, d=PD, tau=1.0, clip_iters=10,
                            m_validators=m, attack="none",
                            aggregator_attack=True, aggregator_scale=5.0,
                            misreport_s=True, start_step=0, audit_k=k)
    state, _, outs = teng.scan_protocol(
        cfg, teng.init_state(cfg, seed=0, device="cpu"),
        torch.from_numpy(_byz(PN, (liar,))), torch.zeros(()),
        _noise_grads(), bound + 4)
    ban_step = state.ban_step.numpy()
    assert 0 <= ban_step[liar] <= bound
    assert (np.delete(ban_step, liar) == -1).all()
    # before the ban the liar's column was unsampled or its misreport was
    # caught at once: no step banned anyone else
    for out in outs:
        assert not (out.banned_now.numpy() & (np.arange(PN) != liar)).any()
