"""The port's protocol engine (repro_torch.core.engine) against the JAX
package's (repro.core.engine): the same init_state(seed) and the same
numpy gradients give EXACTLY the same seed, validators, accusation
matrices, system accusations, ban sets and ban reasons, and g_hat within
1e-5 — over the attack grid, with the flagship (fixed and adaptive
warm-started), the verified:* wrappers and the compressed:* wire codecs;
then a few scanned steps give the same ban steps, honest runs accuse
no one, and the non-verifiable baselines match with no bans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.protocol import AttackConfig as JAttack
from repro_torch.core import engine as teng
from repro_torch.core.protocol import AttackConfig as TAttack

N, D = 8, 61  # part = 8, ragged
BYZ = (5, 6, 7)
SPECS = {
    "fixed": {},
    "adaptive_warm": {"aggregator":
                      "butterfly_clip:warm_start=true,adaptive_tol=1e-4"},
    "verified_mean": {"aggregator": "verified:mean"},
    "verified_trimmed_mean": {"aggregator":
                              "verified:trimmed_mean:trim_ratio=0.25"},
    "verified_coordinate_median": {"aggregator":
                                   "verified:coordinate_median"},
    "compressed_butterfly_clip": {"aggregator": "compressed:butterfly_clip"},
    "compressed_verified_mean_bf16": {
        "aggregator": "compressed:verified:mean:codec=bf16"},
}
BASELINES = ("mean", "coordinate_median", "trimmed_mean")
ATTACKS = {
    "sign_flip": dict(kind="sign_flip"),
    "random_direction": dict(kind="random_direction"),
    "alie": dict(kind="alie"),
    "ipm_06": dict(kind="ipm_06"),
    "delayed_gradient": dict(kind="delayed_gradient", delay=2),
    "aggregator": dict(kind="none", aggregator_attack=True,
                       aggregator_scale=5.0),
}


# attack and engine switches outside the grid above: (attack, engine kw)
SWITCHES = {
    "false_accuse": (dict(kind="sign_flip", false_accuse=True), {}),
    "mprng_abort": (dict(kind="sign_flip", mprng_abort=True), {}),
    "misreport_off": (dict(kind="none", aggregator_attack=True,
                           aggregator_scale=5.0, misreport_s=False), {}),
    "end_step": (dict(kind="sign_flip", end_step=2), {}),
    "clip_lambda": (dict(kind="sign_flip"), {"clip_lambda": 0.5}),
    "label_flip": (dict(kind="label_flip"), {}),
    "ipm_01": (dict(kind="ipm_01"), {}),
    "m_validators_1": (dict(kind="sign_flip"), {"m_validators": 1}),
    "m_validators_3": (dict(kind="sign_flip"), {"m_validators": 3}),
    "delta_max": (dict(kind="sign_flip"), {"delta_max": 30.0}),
}


def _configs(attack, spec, **kw):
    attack, extra = (ATTACKS[attack], {}) if attack in ATTACKS \
        else SWITCHES[attack]
    common = {**dict(tau=1.0, clip_iters=20, m_validators=2), **SPECS[spec],
              **extra, **kw}
    jcfg = jeng.config_from_attack(N, D, JAttack(**attack), **common)
    tcfg = teng.config_from_attack(N, D, TAttack(**attack), **common)
    return jcfg, tcfg


def _byz():
    return np.array([1.0 if i in BYZ else 0.0 for i in range(N)], np.float32)


def _grads(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)) * 0.3 + 0.1).astype(np.float32)


def _assert_outputs_equal(jout, tout):
    for name in ("banned_now", "ban_reason_now", "accuse_mat", "sys_accuse",
                 "cheated", "validators", "checksum_violations",
                 "check_averaging", "n_active"):
        np.testing.assert_array_equal(
            getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
            err_msg=name)
    assert int(tout.seed) == int(jout.seed)
    assert tout.clip_iters_used == int(jout.clip_iters_used)
    np.testing.assert_allclose(tout.g_hat.numpy(), np.asarray(jout.g_hat),
                               rtol=1e-5, atol=1e-5)


def _assert_states_equal(jst, tst, scale=1.0):
    assert tst.step == int(jst.step)
    for name in ("active", "validator", "ban_step", "ban_reason",
                 "accused_count", "last_checked", "col_checked"):
        np.testing.assert_array_equal(
            getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
            err_msg=name)
    np.testing.assert_allclose(tst.prev_agg.numpy(), np.asarray(jst.prev_agg),
                               rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("attack", list(ATTACKS))
def test_one_step_outcomes_equal_jax(attack, spec):
    jcfg, tcfg = _configs(attack, spec)
    G = _grads(1)
    jst = jeng.init_state(jcfg, seed=3)
    tst = teng.init_state(tcfg, seed=3, device="cpu")
    _assert_states_equal(jst, tst)
    jst, jout = jeng.protocol_step(jcfg, jst, jnp.asarray(_byz()),
                                   jnp.asarray(G), jnp.asarray(G))
    tG = torch.from_numpy(G)
    tst, tout = teng.protocol_step(tcfg, tst, torch.from_numpy(_byz()), tG, tG)
    _assert_outputs_equal(jout, tout)
    _assert_states_equal(jst, tst)


def _linear_problem(steps):
    """Public-seed linear regression per (step, peer): G depends on params."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((steps, N, 4, D)).astype(np.float32)
    w_true = rng.standard_normal(D).astype(np.float32)
    y = np.einsum("tnbd,d->tnb", X, w_true).astype(np.float32)
    return X, y


@pytest.mark.parametrize(
    "attack, spec",
    [(a, s) for s in SPECS for a in ("sign_flip", "alie", "aggregator")]
    # each switch on the flagship and on one verified:* spec
    + [(a, s) for s in ("fixed", "verified_mean") for a in SWITCHES])
def test_scanned_steps_ban_steps_equal_jax(attack, spec):
    steps = 5
    X, y = _linear_problem(steps)
    jcfg, tcfg = _configs(attack, spec)
    jX, jy = jnp.asarray(X), jnp.asarray(y)

    # a flipped peer (label_flip) fits negated targets; honest_G is the
    # gradient on its true ones
    def jgrads(p, t, flips):
        def grad(y_t):
            r = jnp.einsum("nbd,d->nb", jX[t], p) - y_t
            return 2.0 * jnp.einsum("nbd,nb->nd", jX[t], r) / 4.0
        return grad(jnp.where(flips[:, None], -jy[t], jy[t])), grad(jy[t])

    tX, ty = torch.from_numpy(X), torch.from_numpy(y)

    def tgrads(p, t, flips):
        def grad(y_t):
            r = torch.einsum("nbd,d->nb", tX[t], p) - y_t
            return 2.0 * torch.einsum("nbd,nb->nd", tX[t], r) / 4.0
        return grad(torch.where(flips[:, None], -ty[t], ty[t])), grad(ty[t])

    jst, jp, jouts = jeng.scan_protocol(
        jcfg, jeng.init_state(jcfg, seed=0), jnp.asarray(_byz()),
        jnp.zeros((D,), jnp.float32), jgrads, steps,
        update_fn=lambda p, g, t: p - 0.05 * g)
    tst, tp, touts = teng.scan_protocol(
        tcfg, teng.init_state(tcfg, seed=0, device="cpu"),
        torch.from_numpy(_byz()), torch.zeros(D), tgrads, steps,
        update_fn=lambda p, g, t: p - 0.05 * g)
    # the mean-based wrappers let the 1000x sign flip into the first
    # step's aggregate, so the parameters reach ~1e6 and the two
    # frameworks' f32 summation orders differ at 1e-5 of that scale
    scale = (1.0 if spec in ("fixed", "adaptive_warm")
             else max(1.0, float(np.abs(np.asarray(jp)).max())))
    _assert_states_equal(jst, tst, scale)
    for k, tout in enumerate(touts):
        jout = jax.tree.map(lambda a: a[k], jouts)
        for name in ("banned_now", "ban_reason_now", "accuse_mat",
                     "sys_accuse", "validators"):
            np.testing.assert_array_equal(
                getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"step {k} {name}")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5 * scale)
    assert (tst.ban_step.numpy() >= 0).any() or attack == "aggregator"


def test_engine_config_rejects_unported_branches():
    """Every branch is ported and validated as in JAX. Elastic membership
    (n_events > 0) builds, with the JAX package's identity capacity; a
    negative n_events or a probation window under one step raises. The
    full-vector baselines resolve to non-verifiable specs. Hierarchical
    groups and sampled audits: a bad audit_k or a group count that does
    not split n into groups of >= 2 raises ValueError."""
    for kw in (dict(n_events=2), dict(n_events=2, probation_steps=3,
                                      max_identities=9)):
        t, j = teng.EngineConfig(n=4, d=8, **kw), jeng.EngineConfig(n=4, d=8,
                                                                     **kw)
        assert t.elastic and j.elastic and t.n_ids == j.n_ids
        assert t.probation_steps == j.probation_steps
    assert not teng.EngineConfig(n=4, d=8).elastic
    for kw in (dict(audit_k=0), dict(groups=3), dict(n_events=-1),
               dict(n_events=2, probation_steps=0)):
        with pytest.raises(ValueError):
            jeng.EngineConfig(n=4, d=8, **kw)
        with pytest.raises(ValueError):
            teng.EngineConfig(n=4, d=8, **kw)
    for kw in (dict(groups=2), dict(audit_k=1), dict(groups=2, audit_k=1)):
        assert teng.EngineConfig(n=4, d=8, **kw).audit_k == kw.get("audit_k")
    for name in ("krum", "geometric_median", "centered_clip"):
        t = teng.EngineConfig(n=4, d=8, aggregator=name).agg_spec()
        j = jeng.EngineConfig(n=4, d=8, aggregator=name).agg_spec()
        assert t.canonical() == j.canonical() and t.name == name
        assert not t.verifiable and not j.verifiable


@pytest.mark.parametrize("spec", [s for s in SPECS if s != "adaptive_warm"])
def test_honest_steps_accuse_no_one(spec):
    """Honest multi-step runs (the JAX package's
    tests/test_verification_grid.py and tests/test_compression.py
    acceptance): no peer or system accusation, no ban, on either engine."""
    steps = 12
    jcfg = jeng.config_from_attack(N, D, JAttack(), tau=1.0,
                                   clip_iters=200, m_validators=3,
                                   **SPECS[spec])
    tcfg = teng.config_from_attack(N, D, TAttack(), tau=1.0,
                                   clip_iters=200, m_validators=3,
                                   **SPECS[spec])
    X, y = _linear_problem(steps)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)

    def tgrads(p, t, flips):
        r = torch.einsum("nbd,d->nb", tX[t], p) - ty[t]
        G = 2.0 * torch.einsum("nbd,nb->nd", tX[t], r) / 4.0
        return G, G

    none = torch.zeros(N)
    tst, _, touts = teng.scan_protocol(
        tcfg, teng.init_state(tcfg, seed=0, device="cpu"), none,
        torch.zeros(D), tgrads, steps, update_fn=lambda p, g, t: p - 0.05 * g)
    for out in touts:
        assert not out.accuse_mat.any() and not out.sys_accuse.any(), spec
        assert not out.banned_now.any(), spec
    assert (tst.ban_step == -1).all()
    jX, jy = jnp.asarray(X), jnp.asarray(y)

    def jgrads(p, t, flips):
        r = jnp.einsum("nbd,d->nb", jX[t], p) - jy[t]
        G = 2.0 * jnp.einsum("nbd,nb->nd", jX[t], r) / 4.0
        return G, G

    jst, _, jouts = jeng.scan_protocol(
        jcfg, jeng.init_state(jcfg, seed=0), jnp.zeros(N), jnp.zeros(D),
        jgrads, steps, update_fn=lambda p, g, t: p - 0.05 * g)
    assert not np.asarray(jouts.accuse_mat).any()
    _assert_states_equal(jst, tst)


@pytest.mark.parametrize("attack", ["sign_flip", "aggregator"])
@pytest.mark.parametrize("base", BASELINES)
def test_baselines_run_without_verification_like_jax(base, attack):
    """--defense mean|coordinate_median|trimmed_mean: the non-verifiable
    branch aggregates every active peer (no validator set-aside) and
    accuses and bans no one, as the JAX engine does."""
    jcfg, tcfg = _configs(attack, "fixed", aggregator=base)
    G = _grads(2)
    jst = jeng.init_state(jcfg, seed=4)
    tst = teng.init_state(tcfg, seed=4, device="cpu")
    for _ in range(2):
        jst, jout = jeng.protocol_step(jcfg, jst, jnp.asarray(_byz()),
                                       jnp.asarray(G), jnp.asarray(G))
        tG = torch.from_numpy(G)
        tst, tout = teng.protocol_step(tcfg, tst, torch.from_numpy(_byz()),
                                       tG, tG)
        _assert_outputs_equal(jout, tout)
        _assert_states_equal(jst, tst)
        assert not tout.banned_now.any() and not tout.accuse_mat.any()


@pytest.mark.parametrize("text", [
    "butterfly_clip",
    "butterfly_clip:tau=2.5,n_iters=7",
    "butterfly_clip:warm_start=true,adaptive_tol=1e-4",
    "butterfly_clip:adaptive_tol=none",
    "mean",
    "trimmed_mean:trim_ratio=0.1",
])
def test_spec_grammar_round_trips_like_jax(text):
    from repro.core.aggregators import AggregatorSpec as JSpec
    from repro_torch.core.aggregators import AggregatorSpec as TSpec

    t, j = TSpec.parse(text), JSpec.parse(text)
    assert t.canonical() == j.canonical()
    assert TSpec.parse(t.canonical()) == t
    assert t.params == j.params
    assert t.param_dict() == j.param_dict()


def _assert_same_bits(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8) if a.is_floating_point() else a,
            b.reshape(-1).view(torch.uint8) if b.is_floating_point() else b
        ), what
    else:
        assert a == b, what


@pytest.mark.parametrize("attack, spec", [
    ("sign_flip", "fixed"), ("sign_flip", "verified_mean"),
    ("false_accuse", "fixed"), ("end_step", "fixed"),
    ("label_flip", "fixed"), ("compressed", "compressed_butterfly_clip")])
def test_donated_stack_gives_the_copying_steps_bits(attack, spec):
    """protocol_step(donate=True) zeroes and attacks the stack in place
    (one row at a time) and gives every output and state field of the
    copying step bit for bit, over 3 steps from a state where attacker 6
    is already out (its row zeroed); a configuration it does not cover
    takes the copying path."""
    _, tcfg = _configs("sign_flip" if attack == "compressed" else attack,
                       spec)
    byz = torch.from_numpy(_byz())
    st0 = teng.init_state(tcfg, seed=3, device="cpu")
    active = st0.active.clone()
    active[6] = 0.0
    lifecycle = st0.lifecycle.clone()
    lifecycle[6] = teng.SLOT_BANNED
    st_copy = st_don = st0._replace(active=active, lifecycle=lifecycle,
                                    validator=st0.validator * active)
    for t in range(3):
        G = torch.from_numpy(_grads(t))
        st_copy, out_copy = teng.protocol_step(tcfg, st_copy, byz, G, G)
        Gd = G.clone()
        st_don, out_don = teng.protocol_step(tcfg, st_don, byz, Gd, Gd,
                                             donate=True)
        for name in out_copy._fields:
            _assert_same_bits(getattr(out_don, name), getattr(out_copy, name),
                              f"step {t} out.{name}")
        for name in st_copy._fields:
            _assert_same_bits(getattr(st_don, name), getattr(st_copy, name),
                              f"step {t} state.{name}")
        flipped = (attack in ("sign_flip", "false_accuse")
                   or (attack == "end_step" and t < 2))
        engaged = active if t == 0 else prev_active
        assert engaged[6] == 0
        for i in range(N):
            if attack == "compressed" or engaged[i] > 0 and not (
                    flipped and i in BYZ):
                assert torch.equal(Gd[i], G[i]), (t, i)
            elif engaged[i] > 0:
                assert torch.equal(Gd[i], -1000.0 * G[i]), (t, i)
            else:
                assert not Gd[i].any(), (t, i)
        prev_active = st_copy.active
