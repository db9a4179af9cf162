"""The paper's §4.1-style controlled experiment on the CUDA device: the
counterpart of the JAX package's ``examples/train_byzantine.py``, with the
same flags and printed lines, plus ``--device`` (default ``cuda``).

Without ``--model`` it runs the toy gaussian-mixture classifier through
the host loop (``BTARDTrainer.run``): 16 peers, the last 7 Byzantine,
attack from step 10, ``sgd(0.3, momentum=0.9)``, 60 steps, printing the
accuracy and the bans. ``--model`` trains a zoo LM (``albert_large``, a
dense decoder: ``qwen3-1.7b``, ``chatglm3-6b``, ``qwen1.5-110b``, an
MoE decoder: ``deepseek-v2-lite-16b``, ``dbrx-132b``, or local attention
and the RG-LRU: ``gemma3-27b``, ``recurrentgemma-9b``) through the scanned
engine (``run_scan``, 4 peers, one attacker) and
prints one line per step and a ``SUMMARY {...}`` line; ``--full`` is the
published width, else the reduced smoke variant.

  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --attack sign_flip --defense btard
  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --defense krum --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --model albert_large --full --attack sign_flip --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --model qwen3-1.7b --full --attack sign_flip --steps 6

``--defense`` takes ``btard`` or any of the §4.1 baselines (``mean``,
``coordinate_median``, ``trimmed_mean``, ``geometric_median``, ``krum``,
``centered_clip``); ``--aggregator`` takes any spec
(``butterfly_clip[:...]``, ``verified:<base>``,
``compressed:<spec>[:codec=int8|bf16]``, or a baseline name) and
overrides it on the engine path.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
from repro_torch.core.protocol import AttackConfig
from repro_torch.models.workload import classification_setup, lm_setup
from repro_torch.optim import sgd


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attack", default="sign_flip",
                    choices=["none", "sign_flip", "random_direction",
                             "label_flip", "delayed_gradient", "ipm_01",
                             "ipm_06", "alie"])
    ap.add_argument("--defense", default="btard",
                    choices=["btard", "mean", "coordinate_median",
                             "geometric_median", "trimmed_mean", "krum",
                             "centered_clip"])
    ap.add_argument("--peers", type=int, default=None,
                    help="default: 16 (toy) / 4 (--model)")
    ap.add_argument("--byzantine", type=int, default=None,
                    help="default: 7 (toy) / 1 (--model)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 60 (toy) / 6 (--model)")
    ap.add_argument("--attack-start", type=int, default=None,
                    help="default: 10 (toy) / 0 (--model)")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--validators", type=int, default=2)
    ap.add_argument("--model", default=None, metavar="ARCH",
                    help="train the LM (albert_large, qwen3-1.7b, "
                         "chatglm3-6b, qwen1.5-110b, deepseek-v2-lite-16b, "
                         "dbrx-132b, gemma3-27b, recurrentgemma-9b) through "
                         "the scanned engine instead of the toy classifier")
    ap.add_argument("--aggregator", default=None,
                    help="AggregatorSpec string (overrides --defense), e.g. "
                         "butterfly_clip:warm_start=true,adaptive_tol=1e-4, "
                         "verified:trimmed_mean:trim_ratio=0.25 or "
                         "compressed:verified:mean:codec=bf16")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced smoke variant)")
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                    help="override param/activation storage dtype")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--clip-iters", type=int, default=None,
                    help="CenteredClip iteration budget (default 60 toy / "
                         "5 model)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run_model(args, attack=None, setup=None):
    """Scanned BTARD over a real LM; prints the per-step lines and the
    SUMMARY line. ``attack`` overrides the AttackConfig built from the
    flags (e.g. to switch the aggregator attack on); ``setup``, a function
    that makes the ``(loss_fn, params0, batch_fn, model)`` quadruple to
    train in place of the workload ``--model``, ``--full``, ``--dtype``,
    ``--seq`` and ``--batch`` name (e.g. a zoo config with its depth cut):
    called here, so that only this frame holds the initial parameters,
    which are dropped once flattened. Returns (trainer, summary, seconds
    of each step)."""
    peers = args.peers or 4
    n_byz = 1 if args.byzantine is None else args.byzantine
    steps = args.steps or 6
    loss_fn, params0, batch_fn, model = setup() if setup else lm_setup(
        args.model, seq_len=args.seq, batch_size=args.batch,
        reduced=not args.full, dtype=args.dtype, device=args.device)
    cfg = TrainerConfig(
        n_peers=peers,
        byzantine=tuple(range(peers - n_byz, peers)),
        attack=attack or AttackConfig(kind=args.attack,
                                      start_step=args.attack_start or 0,
                                      delay=5),
        defense=args.defense if args.aggregator is None else "btard",
        aggregator=args.aggregator,
        tau=args.tau,
        clip_iters=args.clip_iters or 5,
        m_validators=args.validators,
        device=args.device,
    )
    tr = BTARDTrainer(loss_fn, params0, batch_fn, cfg, optimizer=sgd(0.05))
    del params0
    aggregator = args.aggregator or args.defense
    print(f"model={model.cfg.name} d={tr.d} peers={peers} byz={n_byz} "
        f"aggregator={aggregator} dtype={model.cfg.dtype}")
    seconds = []
    for _ in range(steps):
        t0 = time.perf_counter()
        tr.run_scan(1)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        seconds.append(time.perf_counter() - t0)
    byz = set(cfg.byzantine)
    ban_steps, honest_accused = {}, set()
    for rec in tr.history:
        print(f"step {rec['step']:3d}  |g|={rec['grad_norm']:10.4f}  "
            f"banned={rec['n_banned']}"
            + (f"  BANNED {rec['banned_now']}" if rec["banned_now"] else ""))
        for p, _ in rec["banned_now"]:
            ban_steps.setdefault(p, rec["step"])
        honest_accused |= set(rec["accused_peers"]) - byz
    summary = {
        "model": model.cfg.name,
        "d": tr.d,
        "dtype": model.cfg.dtype,
        "aggregator": aggregator,
        "attack": args.attack,
        "steps": steps,
        "byzantine": sorted(byz),
        "banned": sorted(tr.banned),
        "ban_steps": ban_steps,
        "honest_accused": sorted(honest_accused),
        "final_grad_norm": tr.history[-1]["grad_norm"],
    }
    print("SUMMARY " + json.dumps(summary))
    return tr, summary, seconds


def run_toy(args):
    """The toy classifier through the host loop; prints the reference's
    lines (every 5th step and every ban step: accuracy and bans, then the
    final accuracy and the banned peers). Returns (trainer, accuracy fn,
    seconds of each step)."""
    peers = args.peers or 16
    n_byz = 7 if args.byzantine is None else args.byzantine
    loss_fn, params0, batch_fn, accuracy = classification_setup(
        device=args.device)
    cfg = TrainerConfig(
        n_peers=peers,
        byzantine=tuple(range(peers - n_byz, peers)),
        attack=AttackConfig(
            kind=args.attack,
            start_step=10 if args.attack_start is None else args.attack_start,
            delay=5),
        defense=args.defense,
        aggregator=args.aggregator,
        tau=args.tau,
        clip_iters=args.clip_iters or 60,
        m_validators=args.validators,
        device=args.device,
    )
    tr = BTARDTrainer(loss_fn, params0, batch_fn, cfg,
                      optimizer=sgd(0.3, momentum=0.9))

    def log(rec):
        if rec["step"] % 5 == 0 or rec.get("banned_now"):
            acc = accuracy(tr.unraveled_params())
            extra = (f" BANNED {rec['banned_now']}"
                     if rec.get("banned_now") else "")
            print(f"step {rec['step']:3d}  acc={acc:.3f}  "
                  f"banned={rec['n_banned']}/{n_byz}{extra}")

    seconds = []
    for _ in range(args.steps or 60):
        t0 = time.perf_counter()
        tr.run(1, log=log)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        seconds.append(time.perf_counter() - t0)
    print(f"\nfinal accuracy: {accuracy(tr.unraveled_params()):.3f}")
    print(f"banned peers  : {sorted(tr.banned)}")
    return tr, accuracy, seconds


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model:
        run_model(args)
    else:
        run_toy(args)


if __name__ == "__main__":
    main()
