"""Scanned BTARD-SGD over a real LM on the CUDA device: the counterpart of
``run_model`` in the JAX package's ``examples/train_byzantine.py``, with
the same flags, the same per-step lines and the same ``SUMMARY {...}``
line, plus ``--device`` (default ``cuda``).

  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --model albert_large --full --attack sign_flip --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train_byzantine \\
      --model albert_large --device cpu --steps 3

``--aggregator`` takes any ported spec (``butterfly_clip[:...]``,
``verified:mean``, ``verified:trimmed_mean``, ``verified:coordinate_median``,
``compressed:<spec>[:codec=int8|bf16]``) and overrides ``--defense``, which
takes ``btard`` or the baselines ``mean``, ``coordinate_median``,
``trimmed_mean``. Only the model path is ported: the toy classifier (no
``--model``) and the ``geometric_median``, ``krum`` and ``centered_clip``
defenses wait for ROADMAP queue 1, items 7 and 4.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core.btard_sgd import BTARDTrainer, TrainerConfig
from repro_torch.core.protocol import AttackConfig
from repro_torch.models.workload import lm_setup
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
    ap.add_argument("--peers", type=int, default=None, help="default: 4")
    ap.add_argument("--byzantine", type=int, default=None, help="default: 1")
    ap.add_argument("--steps", type=int, default=None, help="default: 6")
    ap.add_argument("--attack-start", type=int, default=None,
                    help="default: 0")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--validators", type=int, default=2)
    ap.add_argument("--model", default=None, metavar="ARCH",
                    help="the LM to train (albert_large)")
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
                    help="CenteredClip iteration budget (default 5)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def run_model(args, attack=None):
    """Scanned BTARD over a real LM; prints the per-step lines and the
    SUMMARY line. ``attack`` overrides the AttackConfig built from the
    flags (e.g. to switch the aggregator attack on). Returns (trainer,
    summary, seconds of each step)."""
    if args.model is None:
        raise SystemExit("the toy classifier is not ported yet; pass --model")
    peers = args.peers or 4
    n_byz = 1 if args.byzantine is None else args.byzantine
    steps = args.steps or 6
    loss_fn, params0, batch_fn, model = lm_setup(
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


def main(argv=None):
    run_model(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
