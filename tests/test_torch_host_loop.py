"""The §4.1 controlled workload on the CPU against the JAX package: the
public-seed classification data, the toy classifier of
``benchmarks/common.py``, and the host-loop trainer (``BTARDTrainer.run``:
the protocol step for btard, the trusted-server step for the baselines)
over Fig. 3 cells, the quickstart scenario and the restarted variant
(Alg. 8).

What must be equal: labels, bans and ban steps with their reasons, the
records' keys. What matches to a tolerance: the gaussian features within
1e-6 (the port's threefry ``normal`` matches jax's to float32 rounding:
XLA's float32 log1p inside it is not correctly rounded, and differs from
torch's by an ulp on ~8% of draws), parameters within 1e-5 of their
scale (rtol 1e-5, atol 1e-5 times the largest parameter, at least 1: a
baseline that lets the 1000x sign flip in drives them to ~1e2-1e3, as in
tests/test_torch_engine.py), accuracy to 3 decimals, gradient norms
within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import classification_setup as jsetup
from repro.core.btard_sgd import BTARDTrainer as JTrainer
from repro.core.btard_sgd import TrainerConfig as JConfig
from repro.core.btard_sgd import restarted_btard_sgd as jrestarted
from repro.core.protocol import AttackConfig as JAttack
from repro.data import pipeline as jpipe
from repro.optim import sgd as jsgd
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TConfig
from repro_torch.core.btard_sgd import restarted_btard_sgd as trestarted
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data import pipeline as tpipe
from repro_torch.models.workload import classification_setup as tsetup
from repro_torch.optim import sgd as tsgd

FEATURES_TOL = dict(rtol=1e-6, atol=1e-6)
PARAMS_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed, step, peer", [(0, 0, 0), (0, 37, 15),
                                              (3, 10**6, 7), (12345, 5, 2)])
def test_peer_seed_equals_jax(seed, step, peer):
    assert tpipe.peer_seed(seed, step, peer) == jpipe.peer_seed(seed, step,
                                                                peer)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed, batch, dim, margin", [
    (0, 16, 16, 2.0), (151678, 16, 16, 2.0), (10**7, 1024, 16, 2.0),
    (42, 8, 256, 0.5)])
def test_classification_batch_matches_jax(seed, batch, dim, margin, flip):
    j = jpipe.classification_batch(seed, batch, dim, 4, flip_labels=flip,
                                   margin=margin)
    t = tpipe.classification_batch(seed, batch, dim, 4, flip_labels=flip,
                                   margin=margin)
    np.testing.assert_array_equal(t["y"].numpy(), np.asarray(j["y"]))
    assert t["x"].dtype == torch.float32 and t["x"].shape == (batch, dim)
    np.testing.assert_allclose(t["x"].numpy(), np.asarray(j["x"]),
                               **FEATURES_TOL)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_classification_setup_matches_jax():
    """The loss, its gradient and the accuracy of the toy classifier at
    the same parameters."""
    jl, jp, jb, jacc = jsetup()
    tl, tp, tb, tacc = tsetup(device="cpu")
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((16, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    assert set(_np(tp)) == set(_np(jp))
    for k in params:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for peer, step, flipped in [(0, 0, False), (5, 12, True)]:
        jbatch, tbatch = jb(peer, step, flipped), tb(peer, step, flipped)
        jg = jax.grad(jl)({k: jnp.asarray(v) for k, v in params.items()},
                          jbatch)
        tparams = {k: torch.tensor(v, requires_grad=True)
                   for k, v in params.items()}
        loss = tl(tparams, tbatch)
        loss.backward()
        np.testing.assert_allclose(
            float(loss.detach()), float(jl({k: jnp.asarray(v)
                                   for k, v in params.items()}, jbatch)),
            rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(tparams[k].grad.numpy(),
                                       np.asarray(jg[k]), **PARAMS_TOL)
    assert tacc({k: torch.from_numpy(v) for k, v in params.items()}) == \
        pytest.approx(jacc({k: jnp.asarray(v) for k, v in params.items()}),
                      abs=1e-3)


def _trainers(defense, attack, steps, n_peers=16, n_byz=7, start=2,
              clip_iters=60):
    """The same Fig. 3 cell (benchmarks/common.run_cell's configuration,
    host loop) in both packages, run for ``steps``."""
    byz = tuple(range(n_peers - n_byz, n_peers))
    kw = dict(n_peers=n_peers, byzantine=byz, defense=defense, tau=1.0,
              clip_iters=clip_iters, m_validators=2, seed=0)
    jl, jp, jb, jacc = jsetup()
    jtr = JTrainer(jl, jp, jb,
                   JConfig(attack=JAttack(kind=attack, start_step=start,
                                          delay=5), **kw),
                   optimizer=jsgd(0.3, momentum=0.9))
    jtr.run(steps)
    tl, tp, tb, tacc = tsetup(device="cpu")
    ttr = TTrainer(tl, tp, tb,
                   TConfig(attack=TAttack(kind=attack, start_step=start,
                                          delay=5), device="cpu", **kw),
                   optimizer=tsgd(0.3, momentum=0.9))
    ttr.run(steps)
    return jtr, ttr, jacc, tacc


def _assert_runs_match(jtr, ttr, jacc, tacc):
    assert len(ttr.history) == len(jtr.history)
    for t, j in zip(ttr.history, jtr.history):
        assert set(t) == set(j)
        assert t["step"] == j["step"] and t["n_banned"] == j["n_banned"]
        assert t.get("banned_now") == j.get("banned_now"), (t, j)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    assert ttr.banned == jtr.banned
    jparams = np.asarray(jtr.params)
    scale = max(1.0, float(np.abs(jparams).max()))
    np.testing.assert_allclose(ttr.params.numpy(), jparams, rtol=1e-5,
                               atol=1e-5 * scale)
    assert round(tacc(ttr.unraveled_params()), 3) == \
        round(jacc(jtr.unraveled_params()), 3)


CELLS = [(d, a) for d in ("btard", "krum", "centered_clip",
                          "geometric_median", "trimmed_mean")
         for a in ("sign_flip", "ipm_06")] + [("btard", "label_flip")]


@pytest.mark.parametrize("defense, attack", CELLS)
def test_fig3_cells_match_jax(defense, attack):
    """Bans and ban steps equal, parameters within 1e-5 and accuracy to 3
    decimals after 6 steps with the attack from step 2 (btard bans under
    sign flip and label flip within them)."""
    jtr, ttr, jacc, tacc = _trainers(defense, attack, steps=6)
    _assert_runs_match(jtr, ttr, jacc, tacc)
    if defense == "btard" and attack != "ipm_06":
        assert ttr.banned, "no ban within the 6 steps"
    if defense != "btard":
        assert ttr.banned == set()


def test_quickstart_scenario_bans_all_seven_in_both():
    """examples/quickstart.py: 16 peers, 7 Byzantine, sign flip from step
    5, 30 steps of the host loop, btard: all 7 banned in both packages at
    the same steps for the same reasons, no honest peer."""
    jtr, ttr, jacc, tacc = _trainers("btard", "sign_flip", steps=30,
                                     start=5)
    _assert_runs_match(jtr, ttr, jacc, tacc)
    assert ttr.banned == jtr.banned == set(range(9, 16))


def test_restarted_btard_sgd_matches_jax():
    """Alg. 8 with 2 restarts (3 then 6 steps, lr 0.3 then 0.3/sqrt(2)):
    the same history, restart tags included, and final parameters."""
    steps_fn = lambda r: 3 * 2 ** r  # noqa: E731
    lr_fn = lambda r: 0.3 * 2.0 ** (-r / 2)  # noqa: E731
    kw = dict(n_peers=8, byzantine=(6, 7), tau=1.0, clip_iters=30,
              m_validators=2)
    jl, jp0, jb, _ = jsetup()
    tl, tp0, tb, _ = tsetup(device="cpu")

    def jmake(lr, params):
        return JTrainer(jl, jp0 if params is None else params, jb,
                        JConfig(attack=JAttack(kind="sign_flip",
                                               start_step=1), **kw),
                        optimizer=jsgd(lr, momentum=0.9))

    def tmake(lr, params):
        return TTrainer(tl, tp0 if params is None else params, tb,
                        TConfig(attack=TAttack(kind="sign_flip",
                                               start_step=1),
                                device="cpu", **kw),
                        optimizer=tsgd(lr, momentum=0.9))

    jparams, jhist = jrestarted(jmake, 2, steps_fn, lr_fn)
    tparams, thist = trestarted(tmake, 2, steps_fn, lr_fn)
    assert len(thist) == len(jhist) == 9
    for t, j in zip(thist, jhist):
        assert (t["restart"], t["step"], t["n_banned"], t["banned_now"]) == \
            (j["restart"], j["step"], j["n_banned"], j["banned_now"])
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    assert any(t["banned_now"] for t in thist)
    for k in ("w", "b"):
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), **PARAMS_TOL)


def test_run_records_eval_every_and_krum_byzantine_default():
    """run's eval_fn / eval_every / log, and the trainer filling krum's
    n_byzantine from the Byzantine count as the JAX trainer does."""
    tl, tp, tb, tacc = tsetup(device="cpu")
    cfg = TConfig(n_peers=6, byzantine=(4, 5), defense="krum",
                  attack=TAttack(kind="sign_flip"), device="cpu")
    tr = TTrainer(tl, tp, tb, cfg, optimizer=tsgd(0.3, momentum=0.9))
    assert tr.engine_config.agg_spec().get("n_byzantine") == 2
    logged = []
    tr.run(5, eval_fn=tacc, eval_every=2, log=logged.append)
    assert [("eval" in r) for r in tr.history] == [True, False, True, False,
                                                   True]
    assert logged == tr.history and tr.banned == set()
    assert all(np.isfinite(r["grad_norm"]) for r in tr.history)
