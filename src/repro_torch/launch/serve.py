"""Batched serving on one device: prefill a batch of prompts, then decode
greedily.

Counterpart of ``repro.launch.serve``, with its flags and its three lines
(the architecture, the prefill seconds and decode milliseconds a token,
the first two generated sequences), then the peak device memory and the
device (the card's name and power limit from ``nvidia-smi``). The prompts
are the public-seed pipeline's batch 0, the weights ``init_params`` of
seed 0 and an encoder model's ``memory_raw`` 0.02 times normals of key 1,
as in the reference. ``--device`` defaults to ``cuda`` and refuses to run
without a card unless ``--device cpu`` is given; ``--mesh`` takes only
``1x1`` (serving over a mesh is ROADMAP item 14's), and the JAX-only
``--host-devices`` is not ported.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --reduced --device cpu --batch 8 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --batch 8 --prompt-len 512 --gen 32          # whole, on the card
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import NOT_PORTED, parse_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.workload import lm_model


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only: serving over a mesh is not ported")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


class Served(NamedTuple):
    """What a run served. ``batch``: the prefill batch (the prompts, and
    ``memory_raw`` for an encoder model); ``tokens``: (B, gen) the tokens
    generated; ``logits``: the float32 (B, V) logits each token was the
    argmax of, the first from the prefill; ``peak_memory``: bytes on the
    card, from before the weights were made (None on the CPU)."""
    model: object
    params: dict
    batch: dict
    tokens: torch.Tensor
    logits: list
    prefill_s: float
    decode_ms: float
    peak_memory: int | None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(args) -> Served:
    """Prefill ``args.batch`` prompts of ``args.prompt_len`` tokens into a
    cache of prompt + gen positions, then decode ``args.gen - 1`` more
    tokens a row, each the argmax of its logits."""
    if parse_mesh(args.mesh).n_peers != 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: serving over more than one device is not "
            f"ported yet; {NOT_PORTED}")
    device = resolve_device(args.device)
    model = lm_model(args.arch, reduced=args.reduced)
    cfg, B, P = model.cfg, args.batch, args.prompt_len
    prefill_fn, decode_fn = make_prefill_step(model), make_decode_step(model)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = model.init_params(prng.key(0, device=device))
    pipe = TokenPipeline(cfg.vocab_size, P, B, device=device)
    batch = {"tokens": pipe.batch(0)["tokens"][:, :P]}
    if cfg.encoder_len:
        batch["memory_raw"] = prng.normal(
            prng.key(1, device=device),
            (B, cfg.encoder_len, cfg.encoder_dim)) * 0.02
    cache = model.init_cache(B, P + args.gen, device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, batch, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    toks, kept = [tok], [logits]
    for i in range(args.gen - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=device)
        logits, cache = decode_fn(params, cache, {"token": tok, "pos": pos})
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok)
        kept.append(logits)
    _sync(device)
    t2 = time.perf_counter()
    return Served(
        model, params, batch, torch.stack(toks, 1), kept, t1 - t0,
        (t2 - t1) / max(args.gen - 1, 1) * 1000,
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else None)


def device_line(device):
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)} (power limit not read)"


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = serve(args)
    print(f"arch={out.model.cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len}")
    print(f"prefill: {out.prefill_s:.2f}s; decode: {out.decode_ms:.1f} "
          "ms/token")
    print("first sequences:", out.tokens[:2].tolist())
    print("peak memory: " + ("not measured on the CPU"
                             if out.peak_memory is None else
                             f"{out.peak_memory / 1e9:.2f} GB"))
    print(f"device: {device_line(resolve_device(args.device))}")
    return out


if __name__ == "__main__":
    main()
