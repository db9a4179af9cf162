"""End-to-end distributed training launcher over a group of peer ranks.

Counterpart of ``repro.launch.train``: the BTARD (or baseline AR-SGD)
train step of ``launch.steps`` on ``--mesh DATAx1`` peers, with the same
flags and the same lines (``arch=...``, ``step N loss=... checksum=...``,
``banned peers -> [...]``, ``done: ...``, ``SUMMARY {...}``). Data comes
from the deterministic public-seed pipeline: one global batch per step,
its rows split over the peers; an encoder model's batch also carries
``memory_raw``, (B, encoder_len, encoder_dim) float32 stub frames or
patches from the pipeline's extras, split by rows with the tokens.

The peers are ranks of a ``launch.collectives`` group (``--backend``):

* ``local`` (default): DATA ranks as threads of this process on one
  device, which is how one GPU holds a peer group;
* ``dist``: this process is rank ``--rank`` of a ``torch.distributed``
  job of DATA processes (NCCL on one GPU per rank, gloo on the CPU), all
  started with the same flags and ``--dist-init tcp://host:port`` or
  ``file://path``.

It runs on the CUDA device unless ``--device cpu`` is given. There the
kernels' plain PyTorch versions run; on the card the CUDA kernels always
run, so ``--use-pallas`` is accepted and changes nothing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch albert-large \\
      --reduced --device cpu --mesh 4x1 --steps 4 --attack sign_flip \\
      --byzantine 3 --tau 1 --clip-iters 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch albert-large \\
      --mesh 4x1 --steps 4 --attack sign_flip --byzantine 3 \\
      --aggregator butterfly_clip:warm_start=true,adaptive_tol=1e-4

Crash recovery, with the JAX launcher's rules and lines: on the chunked
path (``--scan-steps``, or a warm-started spec) ``--checkpoint-dir DIR``
writes ``DIR/state.msgpack`` (params, optimizer state, the warm-start
carry) and ``DIR/membership.msgpack`` (the membership ledger) at every
chunk boundary, ``--resume`` continues from them bit for bit, and
``--halt-at STEP`` stops after the first boundary at or past STEP (the
crash drill). ``--checkpoint PATH`` writes the params and optimizer state
after the last step. The files are the JAX package's format
(``repro_torch.checkpoint``): params, optimizer state and membership
load in either package; the carry is stored as float32 leaves of the
params' shapes (the port's flat float32 carry, bit for bit).

  PYTHONPATH=src python -m repro_torch.launch.train --arch albert-large \\
      --reduced --device cpu --mesh 4x1 --steps 4 --scan-steps 2 \\
      --checkpoint-dir ck --halt-at 2   # then the same with --resume

Not ported yet: a model axis > 1, the pod axis and ``--seq-parallel``
(ROADMAP queue 1 item 14's remainder): each raises
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

def resolve_cli_aggregator(text, warm_start_clip=False, adaptive_clip=None):
    """Parse ``--aggregator NAME[:k=v,...]`` and fold the deprecated
    ``--warm-start-clip`` / ``--adaptive-clip TOL`` flags into the spec as
    aliases of the equivalent spec params."""
    from repro_torch.core.aggregators import AggregatorSpec

    spec = AggregatorSpec.parse(text)
    shims = {}
    if warm_start_clip:
        warnings.warn("--warm-start-clip is deprecated; use --aggregator "
                      "butterfly_clip:warm_start=true", DeprecationWarning,
                      stacklevel=2)
        shims["warm_start"] = True
    if adaptive_clip is not None:
        warnings.warn("--adaptive-clip is deprecated; use --aggregator "
                      f"butterfly_clip:adaptive_tol={adaptive_clip}",
                      DeprecationWarning, stacklevel=2)
        shims["adaptive_tol"] = adaptive_clip
    if shims:
        accepted = set(spec.definition.param_names)
        dropped = [k for k in shims if k not in accepted]
        if dropped:
            warnings.warn(f"aggregator {spec.name!r} takes no {dropped}; the "
                          "deprecated clip flags only apply to warm-startable/"
                          "adaptive specs and are ignored here", stacklevel=2)
        spec = spec.override(**{k: v for k, v in shims.items()
                                if k in accepted})
    return spec


def build_parser():
    ap = argparse.ArgumentParser(
        description="BTARD-SGD over a group of peer ranks (the port of "
                    "python -m repro.launch.train).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="accepted for the JAX launcher's command lines; "
                         "the peer count comes from --mesh")
    ap.add_argument("--mesh", default="4x1",
                    help="DATAx1: DATA peer ranks (a model axis > 1 and "
                         "PODxDATAxMODEL are not ported yet)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch rows per step, split over the peers")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--defense", default="btard", choices=["btard", "mean"])
    ap.add_argument("--tau", type=float, default=2.0)
    ap.add_argument("--clip-iters", type=int, default=20)
    ap.add_argument("--attack", default="none",
                    choices=["none", "sign_flip", "random_direction", "ipm"])
    ap.add_argument("--byzantine", default="", help="comma-separated peer idxs")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="not ported yet")
    ap.add_argument("--use-pallas", action="store_true",
                    help="accepted and changes nothing: on the card the CUDA "
                         "kernels always run, on the CPU their plain "
                         "PyTorch versions")
    ap.add_argument("--scan-steps", type=int, default=0,
                    help="BTARD rounds per chunk (0 = one round per call)")
    ap.add_argument("--aggregator", default="butterfly_clip",
                    metavar="NAME[:k=v,...]",
                    help="robust aggregator spec for the btard defense: "
                         "butterfly_clip (params tau, n_iters, warm_start, "
                         "adaptive_tol), mean, coordinate_median, "
                         "trimmed_mean[:trim_ratio=R], verified:BASE[:k=v] "
                         "for a coordinatewise BASE, compressed:SPEC"
                         "[:codec=int8|bf16]. --tau and --clip-iters fill "
                         "the spec's defaults; explicit spec params win.")
    ap.add_argument("--groups", type=int, default=0,
                    help="hierarchical butterfly: GROUPS groups of n/GROUPS "
                         "peers (verifiable specs only; 0 = flat)")
    ap.add_argument("--audit-k", type=int, default=0,
                    help="sampled-digest verification: K owner columns per "
                         "step broadcast their digests (0 = all)")
    ap.add_argument("--agg-attack", type=float, default=0.0, metavar="SCALE",
                    help="the lying aggregator: Byzantine owners shift their "
                         "partition aggregate by SCALE x rms (0 = off)")
    ap.add_argument("--warm-start-clip", action="store_true",
                    help="DEPRECATED alias for --aggregator "
                         "butterfly_clip:warm_start=true")
    ap.add_argument("--adaptive-clip", type=float, default=None,
                    metavar="TOL",
                    help="DEPRECATED alias for --aggregator "
                         "butterfly_clip:adaptive_tol=TOL")
    ap.add_argument("--host-data", action="store_true",
                    help="feed host-generated batches to the chunked step "
                         "instead of generating them on the device")
    ap.add_argument("--churn", default="", metavar="EVENTS",
                    help="membership events KIND@STEP:SLOT, comma-separated "
                         "(kind join|leave), e.g. 'leave@6:1,join@8:1'")
    ap.add_argument("--probation-steps", type=int, default=3)
    ap.add_argument("--checkpoint-dir", default="",
                    help="crash-recovery checkpoints: params, optimizer "
                         "state, the warm-start carry and the membership "
                         "ledger at every chunk boundary (atomic writes). "
                         "Requires the chunked path (--scan-steps)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the checkpoints in --checkpoint-dir "
                         "(same flags), bit for bit")
    ap.add_argument("--halt-at", type=int, default=None, metavar="STEP",
                    help="crash drill: stop after the first chunk-boundary "
                         "checkpoint at or past STEP (requires "
                         "--checkpoint-dir)")
    ap.add_argument("--checkpoint", default="", metavar="PATH",
                    help="write the params and optimizer state here after "
                         "the last step")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", default="local", choices=["local", "dist"],
                    help="local: the peer ranks are threads of this process "
                         "on one device; dist: this process is --rank of a "
                         "torch.distributed job")
    ap.add_argument("--dist-init", default="", metavar="URL",
                    help="rendezvous of --backend dist: tcp://host:port or "
                         "file://path")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank under --backend dist")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a rank waits at any collective")
    return ap


def _refuse_unported(args):
    if args.seq_parallel:
        from repro_torch.launch.mesh import NOT_PORTED

        raise NotImplementedError(
            f"--seq-parallel is not ported yet; {NOT_PORTED}")


def audit_offenders(verif, tol=1e-5):
    """Peers whose validator audit (gradient or partition-aggregation
    recompute) deviated from what they broadcast: honest audits are exact
    zeros, so any excess over float tolerance is a lie."""
    bad = set()
    for k in ("audit_grad_mismatch", "audit_agg_mismatch"):
        if k in verif:
            a = verif[k].cpu().double().numpy()
            if a.ndim > 1:  # a chunk: catch mid-chunk audits too
                a = a.max(0)
            bad |= {int(i) for i in np.nonzero(a > tol)[0]}
    return bad


def run(args, *, breakdown=False, on_steps_done=None, on_chunk_done=None,
        params0=None):
    """Run the launcher for parsed ``args``; prints as the JAX launcher
    does (from rank 0). Returns rank 0's record: ``summary`` (the SUMMARY
    line's object), ``losses`` (every step run here), ``ban_steps``
    ({slot: step}), ``seconds`` (host seconds of each step or chunk,
    device synchronized), ``clip_iters`` (every step's CenteredClip budget
    per peer), ``state`` (the final ``params``, ``opt`` state and flat
    ``v_prev`` carry), ``save_seconds`` and ``load_seconds`` (of each
    checkpoint written or read, on rank 0) and ``halted`` (the checkpointed
    step a ``--halt-at`` stopped at, else None).

    ``breakdown``: after the last step, run one more step with a
    :class:`~repro_torch.launch.steps.PartClock` and add its seconds by
    part as ``parts``; ``on_steps_done()`` is called once, on rank 0, when
    every rank has finished the main steps and before that extra step.
    ``on_chunk_done(next_step)`` is called on rank 0 after each chunk of
    the chunked path, when every rank has finished it. ``params0``: the
    initial parameter tree (default: the model's ``init_params`` from key
    0), e.g. weights carried from the JAX package."""
    from repro_torch import resolve_device
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import parse_mesh

    _refuse_unported(args)
    mesh = parse_mesh(args.mesh)
    agg_spec = resolve_cli_aggregator(args.aggregator, args.warm_start_clip,
                                      args.adaptive_clip)
    warm = bool(agg_spec.warm_startable and agg_spec.get("warm_start", False))
    n_scan = max(args.scan_steps, 1 if warm else 0)
    if (args.checkpoint_dir or args.resume) and not n_scan:
        build_parser().error("--checkpoint-dir/--resume require --scan-steps "
                             "(checkpoints are cut at scan-chunk boundaries)")
    if args.resume and not args.checkpoint_dir:
        build_parser().error("--resume reads the checkpoints in "
                             "--checkpoint-dir, so it requires it")
    if args.halt_at is not None and not args.checkpoint_dir:
        build_parser().error("--halt-at exits after a boundary checkpoint, so "
                             "it requires --checkpoint-dir")
    device = resolve_device(args.device)
    n = mesh.n_peers
    opts = dict(breakdown=breakdown, on_steps_done=on_steps_done,
                on_chunk_done=on_chunk_done, params0=params0)
    if args.backend == "local":
        results = collectives.run_local(
            n, lambda group: _rank_main(args, group, mesh, device, agg_spec,
                                        n_scan, **opts),
            device=device, timeout=args.timeout)
        return results[0]
    if not args.dist_init:
        raise SystemExit("--backend dist needs --dist-init URL")
    if device.type == "cuda":
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    group = collectives.init_dist(args.dist_init, n, args.rank,
                                  device=device, timeout=args.timeout)
    try:
        return _rank_main(args, group, mesh, device, agg_spec, n_scan, **opts)
    finally:
        torch.distributed.destroy_process_group()


def _rank_main(args, group, mesh, device, agg_spec, n_scan, *, breakdown,
               on_steps_done, on_chunk_done, params0):
    """One rank's whole run (every rank runs it; rank 0 prints and writes
    the checkpoints)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import butterfly as bf
    from repro_torch.core import prng
    from repro_torch.core.flatten import (
        FlatBoundary,
        tree_leaves,
        tree_unflatten,
    )
    from repro_torch.core.sybil import HostMembership, parse_churn
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import steps as lsteps
    from repro_torch.models.workload import lm_model
    from repro_torch.optim import sgd

    lead = group.rank == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    byz = set(int(x) for x in args.byzantine.split(",") if x)
    n_peers = mesh.n_peers
    model = lm_model(args.arch, reduced=args.reduced)
    opt = sgd(args.lr, momentum=0.9, nesterov=True)
    cfg = model.cfg
    # the chunked path generates its batches on the device by default; host
    # batches are generated on the CPU and copied (the same bits)
    device_data = bool(n_scan) and not args.host_data
    pipe = (TokenPipeline(cfg.vocab_size, args.seq, args.batch, device=device)
            if device_data else None)
    host_pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    # the encoder models' stub frames or patches ride along every batch
    extras = ({"memory_raw": ((cfg.encoder_len, cfg.encoder_dim),
                              torch.float32)} if cfg.encoder_len else None)

    def host_batch(s):
        return {k: v.to(device)
                for k, v in host_pipe.batch(s, extras=extras).items()}

    flat_cost = dict(groups=args.groups or None, audit_k=args.audit_k or None,
                     agg_attack=args.agg_attack or None)
    common = dict(tau=args.tau, clip_iters=args.clip_iters,
                  attack=args.attack, aggregator=agg_spec, **flat_cost)
    if args.defense == "btard" and n_scan:
        step_fn = lsteps.make_btard_scan_train_step(
            model, opt, mesh, n_scan, pipeline=pipe, extras=extras,
            **common)
    elif args.defense == "btard":
        step_fn = lsteps.make_btard_train_step(model, opt, mesh, **common)
    else:
        step_fn = lsteps.make_baseline_train_step(model, opt, mesh)

    if params0 is None:
        params = model.init_params(prng.key(0, device=device))
    else:  # shared read-only by the ranks: a step makes new tensors
        params = tree_unflatten(params0, [t.to(device)
                                          for t in tree_leaves(params0)])
    boundary = FlatBoundary(params)
    opt_state = opt.init(boundary.flatten(params))

    def f32_tree(flat):
        """A flat (d,) float32 vector as float32 views of the params'
        shapes: the JAX package's tree of the optimizer state (and here of
        the carry) in a file."""
        o = boundary.offsets
        return tree_unflatten(params, [
            flat[o[i]:o[i + 1]].view(shape)
            for i, shape in enumerate(boundary.shapes)])

    def file_state(params, opt_state, v_prev=None):
        tree = {"params": params, "opt": {"m": f32_tree(opt_state["m"])}}
        if v_prev is not None:
            tree["v_prev"] = f32_tree(v_prev)
        return tree

    byz_mask = torch.tensor([1.0 if i in byz else 0.0 for i in range(n_peers)],
                            device=device)
    # every peer starts active, the Byzantine ones too: bans come from the
    # verification outputs, never from out-of-band knowledge
    mem = HostMembership(n_peers, probation_steps=args.probation_steps,
                         events=parse_churn(args.churn) if args.churn
                         else None)

    def weights_now():
        return torch.tensor(mem.weights(), device=device)

    def apply_bans(step, *offender_sets):
        newly = mem.ban_slots({int(b) for s in offender_sets for b in s},
                              step)
        if newly:
            say(f"banned peers -> {mem.banned_slots()}")

    if args.churn and not n_scan:
        say("note: --churn granularity is per step in non-scan mode")
    say(f"arch={cfg.name} params={boundary.d:,} mesh={mesh.shape} "
        f"peers={n_peers} byz={sorted(byz)} "
        f"aggregator={agg_spec.canonical()} scan={n_scan or '-'} "
        f"data={'device' if device_data else 'host'} "
        f"backend={args.backend} device={device.type}")
    attacked = args.attack != "none" or args.agg_attack
    losses, seconds, clip_iters = [], [], []
    save_seconds, load_seconds = [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def seeds_of(idxs):
        # the public seed of each step, an int32 as in the JAX launcher
        return [(s * 7919 + 13 + 2**31) % 2**32 - 2**31 for s in idxs]

    def host_policy(verif, idxs):
        """The probation spot-checks of every round, then the bans from the
        LAST round's checksums (a violated partition checksum implicates
        its aggregating peer) and from any round's audits."""
        rounds = len(idxs)
        probes = verif["probe_mismatch"].cpu().double().numpy()
        for s, row in zip(idxs, probes.reshape(rounds, -1)):
            mem.observe_probe(row, s)
        bad = []
        if attacked:
            bad = bf.checksum_offender_peers(
                verif["checksum"].reshape(rounds, -1)[-1])
        apply_bans(idxs[-1], bad, audit_offenders(verif))
        clip_iters.extend(verif["clip_iters"].reshape(rounds, -1).tolist())

    def chunk_step(idxs, clock=None):
        nonlocal params, opt_state, v_prev
        for s in idxs:
            mem.apply_events(s)
        weights = weights_now()
        if device_data:
            params, opt_state, metrics, verif, v_prev = step_fn(
                group, params, opt_state, idxs, seeds_of(idxs), byz_mask,
                weights, v_prev, clock=clock)
        else:
            batches = [host_batch(s) for s in idxs]
            batches = {k: torch.stack([b[k] for b in batches])
                       for k in batches[0]}
            params, opt_state, metrics, verif, v_prev = step_fn(
                group, params, opt_state, batches, idxs, seeds_of(idxs),
                byz_mask, weights, v_prev, clock=clock)
        host_policy(verif, idxs)
        return metrics

    def one_step(step, clock=None):
        nonlocal params, opt_state
        mem.apply_events(step)
        weights = weights_now()
        batch = host_batch(step)
        lsteps._mark(clock, group, "batch")
        if args.defense == "btard":
            params, opt_state, metrics, verif = step_fn(
                group, params, opt_state, batch, step,
                seeds_of([step])[0], byz_mask, weights, clock=clock)
            extra = (f" checksum={float(metrics['checksum_max']):.2e}"
                     f" votes={float(metrics['votes_max']):.0f}")
            host_policy(verif, [step])
        else:
            params, opt_state, metrics = step_fn(group, params, opt_state,
                                                 batch, step, clock=clock)
            extra = ""
        return metrics, extra

    t0 = time.time()
    final_loss = float("nan")
    v_prev = torch.zeros((boundary.d,), device=device) if n_scan else None
    halted = None
    if args.defense == "btard" and n_scan:
        start_step = 0
        state_path = mem_path = ""
        if args.checkpoint_dir:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            state_path = os.path.join(args.checkpoint_dir, "state.msgpack")
            mem_path = os.path.join(args.checkpoint_dir, "membership.msgpack")
        if args.resume:  # every rank reads the pair
            t = time.perf_counter()
            state, start_step, ck_meta = load_checkpoint(
                state_path, file_state(params, opt_state, v_prev))
            params = state["params"]
            opt_state = {"m": boundary.flatten(state["opt"]["m"])}
            v_prev = boundary.flatten(state["v_prev"])
            mem_tree, mem_step, _ = load_checkpoint(mem_path)
            if mem_step != start_step:
                raise RuntimeError(
                    f"checkpoint pair out of sync: state@{start_step} vs "
                    f"membership@{mem_step}: a crash mid-save; rerun "
                    "without --resume or restore the previous pair")
            mem.restore_tree(mem_tree)
            if start_step % n_scan:
                raise RuntimeError(
                    f"resume step {start_step} is not a multiple of "
                    f"--scan-steps {n_scan}; use the original chunking")
            sync()
            load_seconds.append(time.perf_counter() - t)
            say(f"resumed at step {start_step} "
                f"(banned={mem.banned_slots()}, arch={ck_meta.get('arch')})")
        for chunk in range(start_step, args.steps, n_scan):
            idxs = list(range(chunk, min(chunk + n_scan, args.steps)))
            t = time.perf_counter()
            metrics = chunk_step(idxs)
            sync()
            seconds.append(time.perf_counter() - t)
            losses += [float(x) for x in metrics["loss"]]
            final_loss = losses[-1]
            if chunk % max(args.log_every, 1) == 0:
                say(f"step {idxs[-1]:4d} loss={final_loss:.4f}"
                    f" checksum={float(metrics['checksum_max'][-1]):.2e}")
            next_step = idxs[-1] + 1
            if state_path and lead:
                t = time.perf_counter()
                save_checkpoint(
                    state_path, file_state(params, opt_state, v_prev),
                    step=next_step,
                    meta={"arch": args.arch,
                          "aggregator": agg_spec.canonical()})
                save_checkpoint(mem_path, mem.to_tree(), step=next_step)
                save_seconds.append(time.perf_counter() - t)
            if on_chunk_done is not None:
                group.barrier()
                if lead:
                    on_chunk_done(next_step)
            if (state_path and args.halt_at is not None
                    and next_step >= args.halt_at):
                group.barrier()  # rank 0's pair is on disk
                halted = next_step
                break
    else:
        for step in range(args.steps):
            t = time.perf_counter()
            metrics, extra = one_step(step)
            sync()
            seconds.append(time.perf_counter() - t)
            final_loss = float(metrics["loss"])
            losses.append(final_loss)
            if step % args.log_every == 0:
                say(f"step {step:4d} loss={final_loss:.4f}{extra}")
    dt = time.time() - t0
    if halted is None:
        say(f"done: {args.steps} steps in {dt:.1f}s "
            f"({dt / max(args.steps, 1):.2f}s/step)")
    else:
        say(f"halt requested at step {args.halt_at}: checkpointed step "
            f"{halted}, exiting (resume with --resume)")
    summary = mem.summary()
    summary.update(byzantine=sorted(byz), final_loss=final_loss,
                   steps_done=int(args.steps if halted is None else halted))
    say("SUMMARY " + json.dumps(summary))
    if args.checkpoint and halted is None and lead:
        t = time.perf_counter()
        save_checkpoint(args.checkpoint, file_state(params, opt_state),
                        step=args.steps, meta={"arch": args.arch})
        save_seconds.append(time.perf_counter() - t)
        say("checkpoint saved:", args.checkpoint)
    record = {"summary": summary, "losses": losses, "seconds": seconds,
              "clip_iters": list(clip_iters), "halted": halted,
              "save_seconds": save_seconds, "load_seconds": load_seconds,
              "state": {"params": params, "opt": opt_state,
                        "v_prev": v_prev},
              "ban_steps": {s: mem.banned_identities[int(i)]
                            for s, i in enumerate(mem.slot_identity)
                            if int(i) in mem.banned_identities}}
    if halted is not None:
        return record
    group.barrier()
    if on_steps_done is not None and lead:
        sync()
        on_steps_done()
    group.barrier()
    if breakdown:
        clock = lsteps.PartClock(device)
        clock.mark(group)
        if args.defense == "btard" and n_scan:
            chunk_step([args.steps], clock=clock)
        else:
            one_step(args.steps, clock=clock)
        clock.mark(group, "host_ban_policy")
        record["parts"] = dict(clock.parts)
    return record


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
