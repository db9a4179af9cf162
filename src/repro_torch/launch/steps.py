"""The distributed train steps of the launch path, over a group of peer ranks.

Counterpart of the train half of ``repro.launch.steps``. The JAX package
runs its steps under ``shard_map`` on a ``"peers"`` mesh axis; here every
peer is a rank of a :class:`~repro_torch.launch.collectives.PeerGroup`
(threads on one GPU, or ``torch.distributed`` processes), every rank runs
the same step function on its own replica, and the collectives of
``jax.lax`` are the group's methods. Two step kinds:

* baseline train: each rank's gradient over its rows of the global batch,
  averaged by an all-reduce (the paper's All-Reduce comparison);
* BTARD train: stage 1 computes each peer's gradient over its rows of the
  global batch; stage 2 (:func:`aggregation_stage`) is the
  AggregatorSpec-dispatched robust all-reduce. Verifiable specs run the
  butterfly: all_to_all of the gradient partitions, the partition owner's
  aggregation (a CUDA kernel on the card, its plain version on the CPU),
  the O(n^2)-scalar verification tables, all_gather back. Non-verifiable
  specs all_gather the stack and apply the registry fn (trusted-PS model,
  zero tables).

A step returns, on every rank, the global view that the JAX step returns
to the host: the per-peer verification entries gathered into (n,) arrays
(:func:`global_verif`). The serving steps, :func:`make_prefill_step` and
:func:`make_decode_step`, run on one device (the JAX package's shard the
parameters and the cache over its mesh; a model axis is ROADMAP item 14).
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core import aggregators as agg_mod
from repro_torch.core import compression as comp_mod
from repro_torch.core import prng
from repro_torch.core import verification as verif_mod
from repro_torch.core.flatten import FlatBoundary, tree_leaves, tree_unflatten
from repro_torch.core.hierarchy import group_shape
from repro_torch.core.norms import vector_norm
from repro_torch.kernels import ops

# the per-peer entries of a step's verification dict, in packing order;
# the integer ones travel as float32 (exact at these sizes)
PEER_KEYS = ("checksum", "votes", "clip_iters", "audit_target",
             "audit_grad_mismatch", "audit_agg_mismatch", "probe_mismatch",
             "loss")
INT_KEYS = ("clip_iters", "audit_target")


class PartClock:
    """Seconds of the parts of a step across all ranks, for a breakdown:
    at each :meth:`mark` every rank waits at a barrier, then rank 0
    synchronizes the device and charges the time since the previous mark
    to the named part. Steps take ``clock=None`` (no barriers, no
    synchronization) unless a breakdown is asked for."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.parts: dict[str, float] = {}
        self._t = None

    def mark(self, group, name=None):
        group.barrier()
        if group.rank == 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            if name is not None:
                self.parts[name] = self.parts.get(name, 0.0) + now - self._t
            self._t = now
        group.barrier()


def _mark(clock, group, name):
    if clock is not None:
        clock.mark(group, name)


def _zeros1(device, dtype=torch.float32):
    return torch.zeros((1,), dtype=dtype, device=device)


# ===========================================================================
# Stage 2: the robust all-reduce of one rank's gradient vector
# ===========================================================================
def aggregation_stage(g_vec, group, n_peers, spec, weights, seed,
                      delta_max=None, v0_full=None, groups=None,
                      audit_k=None, agg_attack_scale=None, byz_mask=None,
                      audit_grad=None, clock=None):
    """One rank's robust all-reduce of its gradient vector ``g_vec (d,)``
    f32, dispatched by :class:`~repro_torch.core.aggregators.AggregatorSpec`
    (``repro.launch.steps.aggregation_stage``). ``seed`` is the step's
    public seed (an int); ``weights`` (n,) the active mask. Returns
    (aggregated vector (d,) f32, this rank's verification dict).

    Verifiable specs run the butterfly: ``g_vec`` splits into n_loc
    partitions, partition j goes to rank j (all_to_all), which aggregates
    the received (n_loc, part) stack and computes its tables against the
    unit direction z drawn from ``fold_in(key(seed), owner index)``:

    * ``butterfly_clip`` with ``adaptive_tol``: the early-exit loop (kernel
      #3, one launch per iteration) over the stack as one partition, then
      one table pass (#11, ``verify_tables``);
    * ``compressed:butterfly_clip``: the int8/bf16 wire payloads and their
      f32 scales travel in two all_to_alls, and the fused dequantizing
      kernel (#7) reads the wire stack as one partition;
    * fixed-budget ``butterfly_clip``: the fused clip + tables kernel
      (#10, ``centered_clip_fused``);
    * ``verified:*``: :func:`~repro_torch.core.verification.owner_aggregate`
      (#5 or #8 for the mean, #6 after the torch base fn otherwise).

    Then the lying-owner simulation (``agg_attack_scale`` with
    ``byz_mask``), the validator audit of the seed's owner column, the
    sampled-digest masking (``audit_k``) and the table broadcast. With
    ``groups=g`` the butterfly runs within each group of n/g ranks and the
    group aggregates are combined by an active-weight mean (a grouped
    psum). ``v0_full`` (d,) warm-starts a warm-startable spec.

    Non-verifiable specs all_gather the (n, d) stack and apply the
    registry fn; their tables are zeros.
    """
    spec = agg_mod.resolve_spec(spec)
    d = g_vec.shape[0]
    dev = g_vec.device
    if not spec.verifiable:
        stack = group.all_gather(g_vec)  # (n_peers, d) on every rank
        v0 = None
        if v0_full is not None and spec.warm_startable:
            v0 = v0_full.float()
        flat, info = spec.build(n_peers, d)(
            stack.float(), weights if spec.weighted else None, v0,
            prng.key(seed, device=dev))
        verif = {
            "checksum": _zeros1(dev),
            "votes": _zeros1(dev),
            "clip_iters": torch.tensor([int(info.iters)], dtype=torch.int32,
                                       device=dev),
            "s_table": torch.zeros((n_peers, n_peers), device=dev),
            "norm_table": torch.zeros((n_peers, n_peers), device=dev),
            # the trusted-PS model has no audit protocol
            "audit_target": _zeros1(dev, torch.int32),
            "audit_grad_mismatch": _zeros1(dev),
            "audit_agg_mismatch": _zeros1(dev),
        }
        return flat.float(), verif

    my_idx = group.rank
    hier = groups is not None and groups > 1
    if hier:
        n_groups, gs = group_shape(n_peers, groups)
        lvl1 = [[a * gs + c for c in range(gs)] for a in range(n_groups)]
        lvl2 = [[a * gs + c for a in range(n_groups)] for c in range(gs)]
        fold_idx = my_idx % gs  # member index == level-1 partition owner
        n_loc = gs
        # the owner aggregates its GROUP's payloads with the group's weights
        weights = weights.reshape(n_groups, gs)[my_idx // gs]
    else:
        lvl1 = lvl2 = None
        fold_idx = my_idx
        n_loc = n_peers

    part = -(-d // n_loc)
    pad = part * n_loc - d
    if pad:
        g_vec = torch.cat([g_vec, g_vec.new_zeros(pad)])
    x = g_vec.reshape(n_loc, part)
    comp_wire = None
    if comp_mod.is_wrapped(spec):
        # compressed:* — each (peer -> owner) payload crosses as int8/bf16
        # wire words plus one f32 scale in a second, scalar all_to_all;
        # every digest below runs over the dequantized wire values
        wire, scales = comp_mod.quantize(x, comp_mod.codec_of(spec))
        recv_w = group.all_to_all(wire, lvl1)
        recv_s = group.all_to_all(scales, lvl1)
        comp_wire = (recv_w, recv_s)
        recv = comp_mod.dequantize(recv_w, recv_s)
        spec = comp_mod.inner_spec(spec)  # dispatch below is by inner spec
    else:
        recv = group.all_to_all(x, lvl1)
    _mark(clock, group, "all_to_all")

    # z for the verification tables (Alg. 6), from the shared seed folded
    # by the partition owner's index (the member index in groups: z is
    # shared across groups)
    z = prng.normal(prng.fold_in(prng.key(seed, device=dev), fold_idx),
                    (part,))
    z = z / torch.clamp(vector_norm(z), min=1e-30)
    _mark(clock, group, "z_draw")

    if verif_mod.is_wrapped(spec):
        agg, s_local, norms_local, iters_used = verif_mod.owner_aggregate(
            spec, recv, z, weights, key=prng.key(seed, device=dev),
            wire=comp_wire)
        return _verify_audit_tail(
            group, g_vec, d, pad, recv, agg, s_local, norms_local,
            iters_used, weights, delta_max, z, seed, n_peers, n_loc,
            fold_idx, my_idx, 0.0, verif_mod.has_zero_checksum(spec), lvl1,
            lvl2, audit_k, agg_attack_scale, byz_mask, audit_grad)

    p = spec.param_dict()
    tau, clip_iters = float(p["tau"]), int(p["n_iters"])
    adaptive_tol = p["adaptive_tol"]
    v0 = None
    if v0_full is not None:
        if pad:
            v0_full = torch.cat([v0_full, v0_full.new_zeros(pad)])
        v0 = v0_full.reshape(n_loc, part)[fold_idx].float()

    iters_used = clip_iters
    if adaptive_tol is not None:
        # early-exit loop over the one-partition stack, then ONE table pass
        # against the final iterate
        agg_b, iters = ops.butterfly_clip_adaptive_op(
            recv, 1, tau, adaptive_tol, weights,
            v0=None if v0 is None else v0[None], max_iters=clip_iters)
        agg, iters_used = agg_b[0], int(iters[0])
        s_local, norms_local = ops.verify_tables_op(recv, agg, z, tau)
    elif comp_wire is not None:
        # the wire payloads stay int8/bf16 in memory: the fused dequantize +
        # clip + digest kernel reads them as one partition
        qs, qscales = comp_wire
        agg_b, s_b, n_b = ops.butterfly_clip_fused_dequant_op(
            qs, qscales[None], 1, tau, z[None], weights,
            v0=None if v0 is None else v0[None], n_iters=clip_iters)
        agg, s_local, norms_local = agg_b[0], s_b[:, 0], n_b[:, 0]
    else:
        agg, s_local, norms_local = ops.centered_clip_fused_op(
            recv, tau, z, weights, v0=v0, n_iters=clip_iters)
    return _verify_audit_tail(
        group, g_vec, d, pad, recv, agg, s_local, norms_local, iters_used,
        weights, delta_max, z, seed, n_peers, n_loc, fold_idx, my_idx, tau,
        True, lvl1, lvl2, audit_k, agg_attack_scale, byz_mask, audit_grad)


def _verify_audit_tail(group, g_vec, d, pad, recv, agg, s_local, norms_local,
                       iters_used, weights, delta_max, z, seed, n_peers,
                       n_loc, fold_idx, my_idx, tau_v, with_checksum, lvl1,
                       lvl2, audit_k, agg_attack_scale, byz_mask, audit_grad):
    """The verifiable paths' shared tail: the lying owner, the validator
    audit, the sampled-column masking, then :func:`_emit_tables`."""
    dev = agg.device
    agg_honest = agg
    if agg_attack_scale is not None and byz_mask is not None:
        # the lying owner corrupts its aggregate AFTER aggregating and
        # recomputes its digests against the corrupted value
        is_byz = byz_mask[my_idx] > 0
        rms = (vector_norm(agg)
               / math.sqrt(float(agg.shape[0])))
        agg = torch.where(is_byz, agg + agg_attack_scale * (rms + 1e-8), agg)
        diff = recv.float() - agg[None]
        n_att = vector_norm(diff, dim=1)
        dots = diff @ z.float()
        if tau_v > 0:
            s_att = torch.clamp(tau_v / torch.clamp(n_att, min=1e-30),
                                max=1.0) * dots
        else:
            s_att = dots
        s_local = torch.where(is_byz, s_att, s_local)
        norms_local = torch.where(is_byz, n_att, norms_local)

    # the validator audit: the shared seed elects one owner column, whose
    # aggregation the validators recompute (agg_honest IS that recompute);
    # the max deviation of the broadcast value, exact zero when honest
    t_col = seed % n_loc
    if fold_idx == t_col:
        audit_agg = (agg.float() - agg_honest.float()).abs().max()[None]
    else:
        audit_agg = _zeros1(dev)

    # sampled digests: only the audit_k owner columns of this step's
    # rotating window broadcast; the checksum and votes below are computed
    # from the zeroed digests, so unsampled columns never trip a ban
    if audit_k is not None:
        k_tot = min(int(audit_k), n_loc)
        if (fold_idx - seed) % n_loc >= k_tot:
            s_local = torch.zeros_like(s_local)
            norms_local = torch.zeros_like(norms_local)

    extra = {
        "audit_target": torch.tensor([seed % n_peers], dtype=torch.int32,
                                     device=dev),
        "audit_grad_mismatch": (_zeros1(dev) if audit_grad is None
                                else audit_grad.float().reshape(1)),
        "audit_agg_mismatch": audit_agg,
    }
    return _emit_tables(group, g_vec, d, pad, agg, s_local, norms_local,
                        iters_used, weights, delta_max, with_checksum, lvl1,
                        lvl2, extra)


def _emit_tables(group, g_vec, d, pad, agg, s_local, norms_local, iters_used,
                 weights, delta_max, with_checksum, lvl1, lvl2, extra):
    """The table broadcast: the checksum and Delta_max votes from the
    owner's local tables, the O(n^2) scalar table all_gathers and the
    aggregated-partition all_gather. ``with_checksum=False`` (nonlinear
    verified:* specs) reports a zero checksum. Hierarchical mode (``lvl1``
    set): each rank's table row leaves as its own, and the level-2 combine
    is the active-weight mean of the group aggregates (a grouped psum at
    fixed member index); each group rebuilds the full vector from its own
    level-1 gather."""
    dev = agg.device
    if with_checksum:
        checksum = (s_local * weights).sum().abs()
    else:
        checksum = torch.zeros((), device=dev)
    if delta_max is not None:
        votes = ((norms_local > delta_max) * weights).sum()
    else:
        votes = torch.zeros((), device=dev)
    if lvl1 is not None:
        s_table, norm_table = s_local[None], norms_local[None]
        w_grp = weights.sum()  # this group's active weight
        num = group.psum(w_grp * agg.float(), lvl2)
        den = group.psum(w_grp.reshape(1), lvl2)
        v2 = num / torch.clamp(den, min=1e-30)
        full = group.all_gather(v2.to(g_vec.dtype), lvl1, tiled=True).float()
    else:
        s_table = group.all_gather(s_local)  # (n_parts, n_peers)
        norm_table = group.all_gather(norms_local)
        full = group.all_gather(agg.to(g_vec.dtype), tiled=True).float()
    if pad:
        full = full[:d]
    verif = {
        "checksum": checksum.float().reshape(1),
        "votes": votes.float().reshape(1),
        "clip_iters": torch.tensor([int(iters_used)], dtype=torch.int32,
                                   device=dev),
        "s_table": s_table,
        "norm_table": norm_table,
    }
    verif.update(extra)
    return full, verif


def global_verif(group, verif, hier=False):
    """This rank's verification dict -> the global one every rank holds,
    as the JAX step's out specs give it to the host: each per-peer entry
    (:data:`PEER_KEYS`) gathered into an (n,) array, the flat (n, n)
    tables as they are (already broadcast), the hierarchical (1, gs) table
    rows gathered into (n, gs). One all_gather of one packed f32 row."""
    keys = [k for k in PEER_KEYS if k in verif]
    cols = [verif[k].float().reshape(1) for k in keys]
    if hier:
        gs = verif["s_table"].shape[1]
        cols += [verif["s_table"].reshape(gs), verif["norm_table"].reshape(gs)]
    rows = group.all_gather(torch.cat(cols))  # (n, len(keys) [+ 2 gs])
    out = {}
    for i, k in enumerate(keys):
        col = rows[:, i]
        out[k] = col.to(torch.int32) if k in INT_KEYS else col
    if hier:
        k = len(keys)
        out["s_table"] = rows[:, k:k + gs]
        out["norm_table"] = rows[:, k + gs:]
    else:
        out["s_table"], out["norm_table"] = verif["s_table"], verif["norm_table"]
    return out


def device_attack(grads_vec, byz_mask, group, kind, key, lam=100.0):
    """The Byzantine simulation on this rank's gradient vector
    (``repro.launch.steps.device_attack``): a rank whose ``byz_mask`` entry
    is set sends ``-lam g`` (sign_flip), a common random direction of norm
    ``lam |g|`` (random_direction), or ``-0.6`` times the honest ranks' mean
    (ipm, a psum)."""
    is_byz = byz_mask[group.rank] > 0
    if kind == "none":
        return grads_vec
    if kind == "sign_flip":
        return torch.where(is_byz, -lam * grads_vec, grads_vec)
    if kind == "random_direction":
        v = prng.normal(key, tuple(grads_vec.shape))
        v = v / torch.clamp(vector_norm(v), min=1e-30)
        scale = lam * vector_norm(grads_vec)
        return torch.where(is_byz, scale * v, grads_vec)
    if kind == "ipm":
        n_honest = torch.clamp((1.0 - byz_mask).sum(), min=1.0)
        honest_sum = group.psum(
            torch.where(is_byz, 0.0, 1.0) * grads_vec)
        mu = honest_sum / n_honest
        return torch.where(is_byz, -0.6 * mu, grads_vec)
    raise ValueError(kind)


# ===========================================================================
# Stage 1 and the train steps
# ===========================================================================
def peer_rows(batch, group):
    """This rank's rows of the global batch (the JAX step's peer-sharded
    leading batch dim): rows [r B/n, (r+1) B/n)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % group.n:
            raise ValueError(f"global batch {b} is not divisible by the "
                             f"{group.n} peers")
        c = b // group.n
        out[k] = v[group.rank * c:(group.rank + 1) * c]
    return out


def peer_grads(model, params, rows):
    """Stage 1 on one rank: (loss, gradient leaves in the params' dtypes)
    of ``model.loss_fn`` over this rank's rows."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = model.loss_fn(tree_unflatten(params, leaves), rows)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach().float(), grads


def _apply(optimizer, boundary, params, opt_state, agg_leaves, step):
    """The optimizer over the flat f32 view: the aggregate read as its
    leaves' values, each updated leaf cast back to its dtype
    (``apply_updates``: (p.f32 + u).astype(p.dtype))."""
    agg = boundary.flatten_leaves(agg_leaves)
    flat = boundary.flatten(params)
    updates, opt_state = optimizer.update(agg, opt_state, flat, step)
    return boundary.unflatten(flat + updates), opt_state


def _build_btard_step(model, optimizer, mesh, tau=1.0, clip_iters=20,
                      attack="none", delta_max=1e9, warm_start=False,
                      adaptive_tol=None, aggregator=None, groups=None,
                      audit_k=None, agg_attack=None):
    """Shared construction of the single-step and chunked BTARD steps.
    ``aggregator``: AggregatorSpec / ``"name[:k=v,...]"`` / None (the
    flagship); the legacy knobs fill the spec's declared params as
    defaults. Returns step_core(group, params, opt_state, batch, step,
    seed, byz_mask, weights, v_prev=None, clock=None) -> (params,
    opt_state, metrics, verif, agg) with ``agg`` the flat f32 aggregate as
    the optimizer read it (the warm-start carry)."""
    spec = agg_mod.resolve_spec(aggregator).with_defaults(
        tau=tau, n_iters=clip_iters, max_iters=clip_iters,
        adaptive_tol=adaptive_tol, warm_start=warm_start)
    carry_v0 = spec.warm_startable and bool(spec.get("warm_start", False))
    n_peers = mesh.n_peers
    hier = bool(groups and groups > 1 and spec.verifiable)
    if hier:
        group_shape(n_peers, groups)  # validates g | n and gs >= 2

    def step_core(group, params, opt_state, batch, step, seed, byz_mask,
                  weights, v_prev=None, clock=None):
        if group.n != n_peers:
            raise ValueError(f"the step is built for {n_peers} peers, the "
                             f"group has {group.n}")
        loss, grads = peer_grads(model, params, peer_rows(batch, group))
        boundary = FlatBoundary(params)
        vec = boundary.flatten_leaves(grads)
        vec_honest = vec
        # the attack key folds the public (seed, step) pair
        key = prng.fold_in(prng.key(seed, device=vec.device), step)
        vec = device_attack(vec, byz_mask, group, attack, key)
        # each peer's deviation from its public-seed recompute (vec_honest
        # IS that recompute): exact zero for honest peers
        probe = (vec - vec_honest).abs().max()
        audit_grad = None
        if spec.verifiable:
            # the gradient-recompute audit of the seed's elected peer
            audit_grad = (probe if group.rank == seed % n_peers
                          else torch.zeros((), device=vec.device))
        _mark(clock, group, "grads")
        agg_vec, verif = aggregation_stage(
            vec, group, n_peers, spec, weights, seed, delta_max=delta_max,
            v0_full=v_prev if carry_v0 else None,
            groups=groups if hier else None,
            audit_k=audit_k if spec.verifiable else None,
            agg_attack_scale=agg_attack, byz_mask=byz_mask,
            audit_grad=audit_grad, clock=clock)
        _mark(clock, group, "aggregation_and_tables")
        verif["probe_mismatch"] = probe.reshape(1)
        verif["loss"] = loss.reshape(1)
        verif = global_verif(group, verif, hier)
        # the aggregate as the gradient leaves' dtypes hold it
        agg_leaves = boundary.unflatten_leaves(agg_vec)
        params, opt_state = _apply(optimizer, boundary, params, opt_state,
                                   agg_leaves, step)
        metrics = {
            "loss": verif.pop("loss").mean(),
            "checksum_max": verif["checksum"].max(),
            "votes_max": verif["votes"].max(),
            "clip_iters_max": verif["clip_iters"].max(),
        }
        _mark(clock, group, "optimizer")
        return (params, opt_state, metrics, verif,
                boundary.flatten_leaves(agg_leaves))

    return step_core


def make_btard_train_step(model, optimizer, mesh, tau=1.0, clip_iters=20,
                          attack="none", delta_max=1e9, adaptive_tol=None,
                          aggregator=None, groups=None, audit_k=None,
                          agg_attack=None):
    """step(group, params, opt_state, batch, step, seed, byz_mask, weights,
    clock=None) -> (params, opt_state, metrics, verif), run by every rank
    of the group on its replica. The single-step API carries no previous
    aggregate, so a spec's ``warm_start`` is forced off here (use
    :func:`make_btard_scan_train_step`)."""
    spec = agg_mod.resolve_spec(aggregator)
    if "warm_start" in spec.definition.param_names:
        spec = spec.override(warm_start=False)
    step_core = _build_btard_step(
        model, optimizer, mesh, tau=tau, clip_iters=clip_iters,
        attack=attack, delta_max=delta_max, adaptive_tol=adaptive_tol,
        aggregator=spec, groups=groups, audit_k=audit_k,
        agg_attack=agg_attack)

    def train_step(group, params, opt_state, batch, step, seed, byz_mask,
                   weights, clock=None):
        params, opt_state, metrics, verif, _ = step_core(
            group, params, opt_state, batch, step, seed, byz_mask, weights,
            clock=clock)
        return params, opt_state, metrics, verif

    return train_step


def _stack(records):
    return {k: torch.stack([r[k] for r in records]) for k in records[0]}


def make_btard_scan_train_step(model, optimizer, mesh, n_scan_steps,
                               tau=1.0, clip_iters=20, attack="none",
                               delta_max=1e9, warm_start=False,
                               adaptive_tol=None, aggregator=None,
                               pipeline=None, extras=None, groups=None,
                               audit_k=None, agg_attack=None):
    """The BTARD step over a chunk of up to ``n_scan_steps`` rounds (the JAX
    package's ``lax.scan``; here a loop), with the aggregate carried from
    round to round (the warm start of a warm-startable spec).

    Device-data mode (``pipeline`` a ``TokenPipeline`` on the device):
      step(group, params, opt_state, steps, seeds, byz_mask, weights,
      v_prev, clock=None); each round's global batch is generated on the
      device from the public seed chain, the same bits as the host path,
      with the ``extras`` streams (``TokenPipeline.device_batch``'s, e.g.
      the encoder models' ``memory_raw``).
    Host-data mode (pipeline None):
      step(group, params, opt_state, batches, steps, seeds, byz_mask,
      weights, v_prev, clock=None); ``batches`` holds the rounds' batches
      stacked along a leading dim.

    Returns (params, opt_state, metrics, verif, v_last): metrics and verif
    gain a leading round dim; ``v_prev``/``v_last`` are flat f32 (d,)
    aggregates (zeros to start)."""
    step_core = _build_btard_step(
        model, optimizer, mesh, tau=tau, clip_iters=clip_iters,
        attack=attack, delta_max=delta_max, warm_start=warm_start,
        adaptive_tol=adaptive_tol, aggregator=aggregator, groups=groups,
        audit_k=audit_k, agg_attack=agg_attack)

    def run(group, params, opt_state, batch_for, steps, seeds, byz_mask,
            weights, v_prev, clock):
        if len(steps) > n_scan_steps or len(steps) != len(seeds):
            raise ValueError(f"a chunk holds at most {n_scan_steps} rounds "
                             f"with one seed each, got {len(steps)} steps "
                             f"and {len(seeds)} seeds")
        metrics, verifs = [], []
        for i, (step, seed) in enumerate(zip(steps, seeds)):
            batch = batch_for(i, step)
            _mark(clock, group, "batch")
            params, opt_state, m, v, v_prev = step_core(
                group, params, opt_state, batch, step, seed, byz_mask,
                weights, v_prev=v_prev, clock=clock)
            metrics.append(m)
            verifs.append(v)
        return params, opt_state, _stack(metrics), _stack(verifs), v_prev

    if pipeline is not None:
        def scan_step(group, params, opt_state, steps, seeds, byz_mask,
                      weights, v_prev, clock=None):
            return run(group, params, opt_state,
                       lambda i, step: pipeline.device_batch(
                           step, extras=extras), steps,
                       seeds, byz_mask, weights, v_prev, clock)
    else:
        def scan_step(group, params, opt_state, batches, steps, seeds,
                      byz_mask, weights, v_prev, clock=None):
            return run(group, params, opt_state,
                       lambda i, step: {k: v[i] for k, v in batches.items()},
                       steps, seeds, byz_mask, weights, v_prev, clock)
    return scan_step


def make_baseline_train_step(model, optimizer, mesh):
    """The All-Reduce baseline: step(group, params, opt_state, batch, step,
    clock=None) -> (params, opt_state, metrics); each rank's gradient over
    its rows, averaged over the ranks by an all-reduce (a psum in rank
    order), the optimizer on every replica."""
    n_peers = mesh.n_peers

    def train_step(group, params, opt_state, batch, step, clock=None):
        loss, grads = peer_grads(model, params, peer_rows(batch, group))
        boundary = FlatBoundary(params)
        _mark(clock, group, "grads")
        mean = group.psum(boundary.flatten_leaves(grads)) / n_peers
        _mark(clock, group, "all_reduce")
        params, opt_state = _apply(optimizer, boundary, params, opt_state,
                                   boundary.unflatten_leaves(mean), step)
        losses = group.all_gather(loss.reshape(1))
        _mark(clock, group, "optimizer")
        return params, opt_state, {"loss": losses.mean()}

    return train_step


# ===========================================================================
# Serving steps
# ===========================================================================
def make_prefill_step(model):
    """``prefill(params, batch, cache) -> (logits, cache)``: the model's
    prefill under ``torch.inference_mode``, the cache written in place."""
    def prefill(params, batch, cache):
        with torch.inference_mode():
            return model.prefill(params, batch, cache)
    return prefill


def make_decode_step(model):
    """``decode(params, cache, batch) -> (logits, cache)``, the JAX
    package's argument order: one token a row under
    ``torch.inference_mode``, the cache updated in place."""
    def decode(params, cache, batch):
        with torch.inference_mode():
            return model.decode_step(params, batch, cache)
    return decode
