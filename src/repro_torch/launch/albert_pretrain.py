"""The paper's §4.2 setup on the CUDA device: ALBERT-large with LAMB and
BTARD-Clipped-SGD, 16 peers of which 7 are Byzantine (the Fig. 4 setup,
on the synthetic public-seed token stream instead of WikiText-103).

The counterpart of the JAX package's ``examples/albert_pretrain.py``, with
the same flags and printed lines, plus ``--device`` (default ``cuda``):
the vocabulary cut to 512 (also with ``--full``, which keeps ALBERT-large's
width 1024, d_ff 4096, 16 heads and 24 shared layers),
``TokenPipeline(vocab, 32, 4, noise=0.15)``, ``lamb(2e-3)``, tau 2,
``clip_lambda`` 20, 40 CenteredClip iterations, one validator, peers 9-15
attacking from ``--attack-start``, through the host loop
(``BTARDTrainer.run``).

  PYTHONPATH=src python -m repro_torch.launch.albert_pretrain --steps 40
  PYTHONPATH=src python -m repro_torch.launch.albert_pretrain --full \\
      --steps 300
  PYTHONPATH=src python -m repro_torch.launch.albert_pretrain \\
      --device cpu --steps 12 --attack-start 4
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.core import prng
from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
from repro_torch.core.protocol import AttackConfig
from repro_torch.data import TokenPipeline
from repro_torch.models.model import Model
from repro_torch.models.workload import lm_model
from repro_torch.optim import lamb

PEERS = 16
BYZANTINE = tuple(range(9, 16))


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--full", action="store_true", help="full ALBERT-large")
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--attack-start", type=int, default=10)
    ap.add_argument("--clip-lambda", type=float, default=20.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(args, params0=None):
    """The §4.2 run with the example's printed lines. ``params0`` replaces
    the initial parameters (the CPU tests carry the JAX package's).
    Returns (trainer, record): the record's ``eval_losses`` ({step: eval
    loss} of the printed steps), ``final_loss``, ``seconds`` (of each
    step) and ``accused`` (every peer accused in the run)."""
    m = lm_model("albert-large", reduced=not args.full)
    cfg = dataclasses.replace(m.cfg, vocab_size=min(m.cfg.vocab_size, 512))
    m = Model(cfg)
    pipe = TokenPipeline(cfg.vocab_size, 32, 4, noise=0.15,
                         device=args.device)

    def batch_fn(peer, step, flipped):
        return pipe.batch(step, peer)

    def loss_fn(params, batch):
        return m.loss_fn(params, batch)[0]

    tcfg = TrainerConfig(
        n_peers=PEERS,
        byzantine=BYZANTINE,
        attack=AttackConfig(kind=args.attack, start_step=args.attack_start),
        defense="btard",
        tau=2.0,
        clip_lambda=args.clip_lambda,  # => BTARD-Clipped-SGD (Alg. 9)
        m_validators=1,
        clip_iters=40,
        device=args.device,
    )
    if params0 is None:
        params0 = m.init_params(prng.key(0, device=args.device))
    tr = BTARDTrainer(loss_fn, params0, batch_fn, tcfg, optimizer=lamb(2e-3))
    del params0
    eval_batch = pipe.batch(10**6)
    uniform = float(math.log(cfg.vocab_size))
    print(f"ALBERT {'full' if args.full else 'reduced'} "
          f"({tr.d:,} params), uniform CE = {uniform:.3f}")

    def eval_loss():
        with torch.no_grad():
            return float(loss_fn(tr.unraveled_params(), eval_batch))

    losses = {}

    def log(rec):
        if rec["step"] % 5 == 0 or rec.get("banned_now"):
            losses[rec["step"]] = loss = eval_loss()
            extra = (f"  BANNED {rec['banned_now']}" if rec.get("banned_now")
                     else "")
            print(f"step {rec['step']:4d}  eval_loss={loss:.4f}  "
                  f"banned={len(tr.banned)}/{len(BYZANTINE)}{extra}",
                  flush=True)

    seconds, accused = [], set()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        tr.run(1, log=log)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        seconds.append(time.perf_counter() - t0)
        accused.update(tr.accused_now)
    final = eval_loss()
    print(f"\nfinal eval loss {final:.4f} (uniform {uniform:.4f}); "
          f"banned={sorted(tr.banned)}")
    return tr, {"eval_losses": losses, "final_loss": final,
                "seconds": seconds, "accused": sorted(accused)}


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
