"""The paper's §4.2 setup in the port (repro_torch.launch.albert_pretrain)
against the JAX package's examples/albert_pretrain.py at a tiny width (2
applications of one shared block, d_model 32, float32 storage, vocab 512;
the example's 16 peers, peers 9-15 sign-flipping from step 2, lamb(2e-3),
tau 2, clip_lambda 20, 40 CenteredClip iterations, one validator), the
JAX weights carried over by from_jax_params: 6 steps of the host loop
give exactly the same bans at the same steps, and parameters within 1e-4
of the JAX run's norm (the frameworks sum in different orders); then the
command's main on the CPU reaches its final line."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs.albert_large import CONFIG as JCONFIG
from repro.core import AttackConfig as JAttack
from repro.core import BTARDTrainer as JTrainer
from repro.core import TrainerConfig as JTrainerConfig
from repro.data import TokenPipeline as JPipeline
from repro.models.model import Model as JModel
from repro.optim import lamb as jlamb
from repro_torch.configs.albert_large import CONFIG as TCONFIG
from repro_torch.launch import albert_pretrain as ap
from repro_torch.models.convert import from_jax_params
from repro_torch.models.model import Model as TModel

TINY = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            vocab_size=512, n_repeats=2, max_position=64, dtype="float32")
STEPS, START = 6, 2


def _jax_run(jm, params):
    """The example's trainer, as examples/albert_pretrain.py builds it."""
    pipe = JPipeline(jm.cfg.vocab_size, 32, 4, noise=0.15)
    tcfg = JTrainerConfig(
        n_peers=16, byzantine=tuple(range(9, 16)),
        attack=JAttack(kind="sign_flip", start_step=START), defense="btard",
        tau=2.0, clip_lambda=20.0, m_validators=1, clip_iters=40)
    tr = JTrainer(lambda p, b: jm.loss_fn(p, b)[0], params,
                  lambda peer, step, flipped: pipe.batch(step, peer), tcfg,
                  optimizer=jlamb(2e-3))
    tr.run(STEPS)
    return tr


def _tiny(monkeypatch):
    monkeypatch.setattr(ap, "lm_model", lambda arch, reduced: TModel(
        dataclasses.replace(TCONFIG, **TINY)))


def test_section_4_2_run_equals_jax(monkeypatch):
    jm = JModel(dataclasses.replace(JCONFIG, **TINY))
    jparams = jm.init_params(jax.random.key(0))
    jtr = _jax_run(jm, jparams)
    _tiny(monkeypatch)
    args = ap.build_parser().parse_args(
        ["--device", "cpu", "--steps", str(STEPS), "--attack-start",
         str(START)])
    ttr, rec = ap.run(args, from_jax_params(jax.tree.map(np.asarray,
                                                         jparams)))
    assert ttr.d == jtr.d and len(rec["seconds"]) == STEPS
    assert [r["banned_now"] for r in ttr.history] == \
        [r.get("banned_now") for r in jtr.history]
    assert ttr.banned == jtr.banned and ttr.banned <= set(range(9, 16))
    assert ttr.banned, "no ban in the window: the comparison is empty"
    assert set(rec["accused"]) <= set(range(9, 16)), rec
    tp, jp = ttr.params.numpy(), np.asarray(jtr.params)
    assert np.linalg.norm(tp - jp) <= 1e-4 * np.linalg.norm(jp)
    assert all(np.isfinite(v) for v in rec["eval_losses"].values())
    assert np.isfinite(rec["final_loss"])


def test_main_reaches_its_final_line(monkeypatch, capsys):
    _tiny(monkeypatch)
    ap.main(["--device", "cpu", "--steps", "3", "--attack-start", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("ALBERT reduced (") and "uniform CE" in out[0]
    assert out[1].startswith("step    0  eval_loss=")
    assert out[-1].startswith("final eval loss ") and "banned=[" in out[-1]
    assert torch.isfinite(torch.tensor(float(out[-1].split()[3])))
