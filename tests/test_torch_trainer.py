"""The slice as a whole: the port's BTARDTrainer.run_scan against the JAX
package's on a small ALBERT (one shared block applied twice, f32), 4 peers,
one sign-flip attacker, 2 validators, 4 steps — the same peers banned at
the same steps for the same reasons, no honest peer accused, and the final
flat parameters within 1e-4; with the flagship, and with verified:mean and
compressed:butterfly_clip through --aggregator."""
import pytest
import dataclasses

import jax
import numpy as np

from repro.configs.albert_large import CONFIG as JCONFIG
from repro.core.btard_sgd import BTARDTrainer as JTrainer
from repro.core.btard_sgd import TrainerConfig as JTrainerConfig
from repro.core.protocol import AttackConfig as JAttack
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models.model import Model as JModel
from repro.optim import sgd as jsgd
from repro_torch.configs.albert_large import CONFIG as TCONFIG
from repro_torch.core.btard_sgd import BTARDTrainer as TTrainer
from repro_torch.core.btard_sgd import TrainerConfig as TTrainerConfig
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.data.pipeline import TokenPipeline as TPipeline
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel
from repro_torch.optim import sgd as tsgd

SMALL = dict(d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
             vocab_size=512, n_repeats=2, max_position=64, dtype="float32")
PEERS, BYZ, STEPS, SEQ, BATCH = 4, (3,), 4, 16, 2


def _setup(model, pipe):
    def loss_fn(params, batch):
        return model.loss_fn(params, batch)[0]

    def batch_fn(peer, step, flipped):
        return pipe.device_batch(step, peer)

    return loss_fn, batch_fn


def _config(cls, attack_cls, **kw):
    return cls(n_peers=PEERS, byzantine=BYZ,
               attack=attack_cls(kind="sign_flip", start_step=0, delay=5),
               tau=1.0, clip_iters=5, m_validators=2, **kw)


def _run_both(**kw):
    jm = JModel(dataclasses.replace(JCONFIG, **SMALL))
    jparams = jm.init_params(jax.random.key(0))
    jloss, jbatch = _setup(jm, JPipeline(512, SEQ, BATCH))
    jtr = JTrainer(jloss, jparams, jbatch,
                   _config(JTrainerConfig, JAttack, **kw),
                   optimizer=jsgd(0.05))
    jtr.run_scan(STEPS)

    tm = TModel(dataclasses.replace(TCONFIG, **SMALL))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    tloss, tbatch = _setup(tm, TPipeline(512, SEQ, BATCH))
    ttr = TTrainer(tloss, tparams, tbatch,
                   _config(TTrainerConfig, TAttack, device="cpu", **kw),
                   optimizer=tsgd(0.05))
    ttr.run_scan(STEPS)
    return jtr, ttr


def _assert_histories_equal(jtr, ttr):
    assert [r["banned_now"] for r in ttr.history] == \
        [r["banned_now"] for r in jtr.history]
    assert ttr.banned == jtr.banned == set(BYZ)
    for rec in ttr.history:
        assert not set(rec["accused_peers"]) - set(BYZ), rec
        assert np.isfinite(rec["grad_norm"])
    for t, j in zip(ttr.history, jtr.history):
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
        assert t["clip_iters_used"] == j["clip_iters_used"]
        assert t["accused_peers"] == j["accused_peers"], (t, j)
    assert ttr.validators == jtr.protocol.validators


def test_run_scan_bans_and_params_match_jax():
    jtr, ttr = _run_both()
    _assert_histories_equal(jtr, ttr)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("aggregator", ["verified:mean",
                                        "compressed:butterfly_clip"])
def test_run_scan_wrapped_specs_match_jax(aggregator):
    jtr, ttr = _run_both(aggregator=aggregator)
    _assert_histories_equal(jtr, ttr)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-4, atol=1e-4)


def test_run_scan_baseline_defense_matches_jax():
    """--defense coordinate_median: the non-verifiable baseline through the
    trainer — no validators set aside, no accusations, no bans, and the
    same grad norms and parameters as the JAX trainer."""
    jtr, ttr = _run_both(defense="coordinate_median")
    assert ttr.banned == jtr.protocol.banned == set()
    for t, j in zip(ttr.history, jtr.history):
        assert t["banned_now"] == j["banned_now"] == []
        assert t["accused_peers"] == j["accused_peers"] == []
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ttr.params.numpy(), np.asarray(jtr.params),
                               rtol=1e-4, atol=1e-4)
