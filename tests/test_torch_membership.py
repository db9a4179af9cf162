"""Elastic membership in the port's engine (repro_torch.core.engine with
core.sybil) against the JAX package's, on the scenarios of the JAX
package's tests/test_membership.py at N, D = 6, 24: the same numpy
gradients through both engines give EXACTLY the same lifecycle, ban
steps and reasons, slot identities, identity ledgers (id_ban_step,
id_ban_reason, id_accused), accusations, validators and bans at every
step, and g_hat within 1e-5 (the two frameworks sum in different orders),
also on random join/leave interleavings with no-op events. Within the
port the bitwise properties hold: an inert schedule changes no
bit of a fixed-membership run, a probation row never touches the
aggregate (bit for bit the run where its slot stayed vacant), and a
rejoin under a new key is re-banned (BAN_SYBIL) with every aggregate bit
for bit that of the run where it never came back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.attacks import rejoin_under_new_key as j_rejoin
from repro.core.protocol import AttackConfig as JAttack
from repro_torch.core import engine as teng
from repro_torch.core.attacks import rejoin_under_new_key
from repro_torch.core.protocol import AttackConfig as TAttack

N, D = 6, 24
STEPS = 12
BYZ_SLOT = 5
SIGN_FLIP = dict(kind="sign_flip", lam=1.0)
STEP_EXACT = ("lifecycle", "banned_now", "ban_reason_now", "accuse_mat",
              "sys_accuse", "n_active", "validators", "sampled_parts",
              "cheated")
STATE_EXACT = ("ban_step", "ban_reason", "lifecycle", "slot_identity",
               "probation_clean", "id_ban_step", "id_ban_reason",
               "id_accused", "active", "validator", "accused_count",
               "col_checked", "last_checked")


def _grads():
    """(STEPS, N, D) float32: a linear-regression gradient per (step,
    peer) at zero parameters, from a numpy seed."""
    rng = np.random.default_rng(9)
    w_true = rng.standard_normal(D).astype(np.float32)
    X = rng.standard_normal((STEPS, N, 4, D)).astype(np.float32)
    y = np.einsum("tnbd,d->tnb", X, w_true)
    return (-2.0 * np.einsum("tnbd,tnb->tnd", X, y) / 4.0).astype(np.float32)


GRADS = _grads()


def _configs(attack=None, **kw):
    kw.setdefault("tau", 1.0)
    kw.setdefault("clip_iters", 30)
    kw.setdefault("m_validators", 2)
    kw.setdefault("aggregator", "verified:mean")
    att = dict(start_step=0, **(attack or dict(kind="none")))
    return (jeng.config_from_attack(N, D, JAttack(**att), **kw),
            teng.config_from_attack(N, D, TAttack(**att), **kw))


def _byz(slots=(BYZ_SLOT,)):
    return np.array([1.0 if i in slots else 0.0 for i in range(N)],
                    np.float32)


def _run_jax(cfg, byz, events=None, vacant=()):
    G_all = jnp.asarray(GRADS)

    def grads_fn(params, t, flips):
        return G_all[t], G_all[t]

    state = jeng.init_state(cfg, seed=0, events=events, vacant=vacant)
    st, _, outs = jax.jit(lambda s, b, p: jeng.scan_protocol(
        cfg, s, b, p, grads_fn, STEPS))(state, jnp.asarray(byz),
                                        jnp.zeros(D, jnp.float32))
    return st, outs


def _run_port(cfg, byz, events=None, vacant=()):
    G_all = torch.from_numpy(GRADS)

    def grads_fn(params, t, flips):
        return G_all[t], G_all[t]

    state = teng.init_state(cfg, seed=0, events=events, vacant=vacant,
                            device="cpu")
    st, _, outs = teng.scan_protocol(cfg, state, torch.from_numpy(byz),
                                     torch.zeros(D), grads_fn, STEPS)
    return st, outs


def _stack(outs, name):
    return torch.stack([getattr(o, name) for o in outs]).numpy()


def _assert_matches_jax(jst, jouts, tst, touts):
    for name in STEP_EXACT:
        np.testing.assert_array_equal(_stack(touts, name),
                                      np.asarray(getattr(jouts, name)),
                                      err_msg=name)
    np.testing.assert_allclose(_stack(touts, "g_hat"),
                               np.asarray(jouts.g_hat), rtol=1e-5, atol=1e-5)
    for name in STATE_EXACT:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tst.events.numpy(), np.asarray(jst.events))


def _scenario(attack=None, events=None, vacant=(), byz=_byz(), **kw):
    """Both engines on one scenario; asserts they agree and returns the
    port's (state, outputs)."""
    jcfg, tcfg = _configs(attack, **kw)
    jst, jouts = _run_jax(jcfg, byz, events, vacant)
    tst, touts = _run_port(tcfg, byz, events, vacant)
    _assert_matches_jax(jst, jouts, tst, touts)
    return tst, touts


@pytest.mark.parametrize("attack", [None, SIGN_FLIP])
def test_inert_schedule_is_bitwise_neutral_and_equals_jax(attack):
    """n_events > 0 with no event scheduled: every output of the port is
    bit for bit that of the fixed-membership port, and the JAX engine's
    (floats to 1e-5)."""
    _, tcfg_fixed = _configs(attack)
    _, fixed = _run_port(tcfg_fixed, _byz())
    _, elastic = _scenario(attack, n_events=4, probation_steps=2)
    for name in STEP_EXACT + ("g_hat",):
        np.testing.assert_array_equal(_stack(elastic, name),
                                      _stack(fixed, name), err_msg=name)


def test_join_is_weight_zero_until_a_clean_window_promotes():
    """A fresh honest joiner sits in probation for probation_steps clean
    checks, never touching the aggregate (bit for bit the run where its
    slot stayed vacant), then turns active and moves it."""
    probation, join_step, slot = 3, 2, 2
    kw = dict(n_events=2, probation_steps=probation)
    st, joined = _scenario(events=[(join_step, "join", slot)],
                           vacant=(slot,), byz=_byz(()), **kw)
    _, vacant = _scenario(vacant=(slot,), byz=_byz(()), **kw)
    life = _stack(joined, "lifecycle")[:, slot]
    promote = join_step + probation - 1
    assert list(life[:join_step]) == [teng.SLOT_VACANT] * join_step
    assert list(life[join_step:promote]) == [teng.SLOT_PROBATION] * (
        probation - 1)
    assert (life[promote:] == teng.SLOT_ACTIVE).all()
    g_join, g_vac = _stack(joined, "g_hat"), _stack(vacant, "g_hat")
    np.testing.assert_array_equal(g_join[:promote + 1], g_vac[:promote + 1])
    assert (g_join[promote + 1:] != g_vac[promote + 1:]).any()
    assert int(joined[-1].n_active) == N
    assert int(st.slot_identity[slot]) == N  # the first minted identity


def test_leave_vacates_the_slot_and_keeps_the_identity_ban():
    """The banned attacker leaves: its slot goes vacant (slot ledgers
    reset), its identity stays banned."""
    st, outs = _scenario(SIGN_FLIP, events=[(6, "leave", BYZ_SLOT)],
                         n_events=2, probation_steps=3)
    life = _stack(outs, "lifecycle")[:, BYZ_SLOT]
    assert teng.SLOT_BANNED in life[:6]
    assert (life[6:] == teng.SLOT_VACANT).all()
    assert int(st.id_ban_step[BYZ_SLOT]) >= 0
    assert int(st.ban_step[BYZ_SLOT]) == -1
    assert int(st.slot_identity[BYZ_SLOT]) == -1


@pytest.mark.parametrize("aggregator", ["verified:mean", "butterfly_clip"])
def test_rejoin_under_new_key_rebanned_without_entering_aggregate(
        aggregator):
    """The banned attacker leaves and rejoins under a fresh identity,
    still attacking: the probation spot-check bans it (BAN_SYBIL), both
    identities end on the ban ledger, no honest peer is accused or
    banned, and every aggregate is bit for bit that of the run where it
    never came back."""
    assert rejoin_under_new_key(BYZ_SLOT, 6, 8) == j_rejoin(BYZ_SLOT, 6, 8)
    kw = dict(n_events=2, probation_steps=3, aggregator=aggregator)
    st, back = _scenario(SIGN_FLIP, events=rejoin_under_new_key(BYZ_SLOT, 6,
                                                                8), **kw)
    _, gone = _scenario(SIGN_FLIP, events=[(6, "leave", BYZ_SLOT)], **kw)
    life = _stack(back, "lifecycle")[:, BYZ_SLOT]
    assert teng.SLOT_BANNED in life[:6]
    assert not (life[8:] == teng.SLOT_ACTIVE).any()
    assert life[-1] == teng.SLOT_BANNED
    banned = _stack(back, "banned_now")[8:, BYZ_SLOT]
    reasons = _stack(back, "ban_reason_now")[8:, BYZ_SLOT]
    assert banned.any() and reasons[banned.argmax()] == teng.BAN_SYBIL
    assert int(st.id_ban_step[BYZ_SLOT]) >= 0 and int(st.id_ban_step[N]) >= 0
    np.testing.assert_array_equal(_stack(back, "g_hat"), _stack(gone, "g_hat"))
    honest = [i for i in range(N) if i != BYZ_SLOT]
    assert not _stack(back, "banned_now")[:, honest].any()
    assert not _stack(back, "accuse_mat")[:, :, honest].any()


def test_same_key_rejoin_lands_banned_with_the_original_ban_step():
    """Rejoining with the banned identity is refused at admission: the
    slot comes back BANNED with the identity's ban step and reason."""
    events = [(6, "leave", BYZ_SLOT), (8, "join", BYZ_SLOT, BYZ_SLOT)]
    st, outs = _scenario(SIGN_FLIP, events=events, n_events=2)
    life = _stack(outs, "lifecycle")[:, BYZ_SLOT]
    assert (life[8:] == teng.SLOT_BANNED).all()
    orig = int(st.id_ban_step[BYZ_SLOT])
    assert 0 <= orig < 6 and int(st.ban_step[BYZ_SLOT]) == orig
    assert int(st.ban_reason[BYZ_SLOT]) == int(st.id_ban_reason[BYZ_SLOT])


def test_identity_ledger_written_once_and_col_checked_monotone():
    """Stepwise through a leave and a rejoin under sampled audits
    (audit_k = 2): each step's state equals the JAX engine's, the
    identity's ban entry never moves once written, and col_checked never
    decreases."""
    jcfg, tcfg = _configs(SIGN_FLIP, n_events=4, audit_k=2, m_validators=1)
    events = [(5, "leave", BYZ_SLOT), (7, "join", BYZ_SLOT)]
    jst = jeng.init_state(jcfg, seed=0, events=events)
    tst = teng.init_state(tcfg, seed=0, events=events, device="cpu")
    jstep = jeng.jit_protocol_step(jcfg)
    byz = _byz()
    prev_col, entry = np.full((N,), -1), None
    for t in range(STEPS):
        G = GRADS[t]
        jst, jout = jstep(jst, jnp.asarray(byz), jnp.asarray(G),
                          jnp.asarray(G))
        tG = torch.from_numpy(G)
        tst, tout = teng.protocol_step(tcfg, tst, torch.from_numpy(byz), tG,
                                       tG)
        for name in STATE_EXACT:
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=f"step {t} {name}")
        col = tst.col_checked.numpy()
        assert (col >= prev_col).all()
        prev_col = col
        ban = int(tst.id_ban_step[BYZ_SLOT])
        if entry is None and ban >= 0:
            entry = ban
        if entry is not None:
            assert ban == entry
    assert entry is not None


def _random_schedule(seed, n_events):
    """A possibly nonsensical interleaving, as the JAX package's property
    test draws it: leaves of vacant slots and joins onto occupied ones
    must be no-ops in both engines."""
    rng = np.random.RandomState(seed)
    return [(int(rng.randint(0, STEPS)),
             "join" if rng.rand() < 0.5 else "leave", int(rng.randint(0, N)))
            for _ in range(int(rng.randint(1, n_events + 1)))]


@pytest.mark.parametrize("attacked", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 7, 12, 31, 40])
def test_random_interleavings_equal_jax(seed, attacked):
    """Any join/leave schedule, with bans landing mid-flight when the
    attack is on and slot 0 starting vacant on odd seeds: the same
    lifecycle, ledgers and bans as the JAX engine, step by step."""
    events = _random_schedule(seed, 4)
    _scenario(SIGN_FLIP if attacked else None, events=events,
              vacant=(0,) if seed % 2 else (), n_events=4,
              probation_steps=2)


def test_encode_events_sorts_handoffs_and_mints_identities():
    """Leaves before joins at one step, fresh identities n, n+1, ... in
    schedule order, inert padding; bad slots and identities raise."""
    jcfg, tcfg = _configs(n_events=5)
    sched = [(4, "join", 1), (4, "leave", 1), (2, "join", 3, 0),
             (7, "join", 2)]
    np.testing.assert_array_equal(teng.encode_events(tcfg, sched).numpy(),
                                  np.asarray(jeng.encode_events(jcfg, sched)))
    for bad in ([(0, "join", N)], [(0, "join", 0, N + 5)],
                [(0, "leave", 0)] * 6):
        with pytest.raises(ValueError):
            teng.encode_events(tcfg, bad)
