"""The BTARD protocol engine (paper Alg. 1-7), one step at a time.

Counterpart of the main-path half of ``repro.core.engine``: the same
state machine as functions over an explicit :class:`ProtocolState`, with
the JAX package's phase functions and PRNG chain, so that the same inputs
give the same bans, accusations and validators:

    attack -> MPRNG seed -> unit directions z -> per-partition CenteredClip
    + Alg. 6 tables -> aggregator attack / misreport -> V1-V3 checks and
    validator audits -> accuse/ban -> next validators

Where the JAX package runs N steps under ``lax.scan``, this is a Python
loop (:func:`scan_protocol`); ``state.step`` is a Python int, so the
attack window and the per-step key folds are host decisions.

The verifiable branches run any verifiable spec (``butterfly_clip``,
``verified:*``, ``compressed:*``); for a ``compressed:*`` spec the
commitment compares, the table recompute and the checksum tolerance run
over the wire projection of the gradients. Non-verifiable specs (the
coordinatewise baselines) aggregate with no tables, accusations or bans.
The flat-cost verification of ``core.hierarchy`` is here too: with
``audit_k`` only the sampled digest columns are computed (one pass of the
sampled partitions) and the ``col_checked`` ledger tracks each column's
audit age; with ``groups`` the hierarchical butterfly (:func:`phase_hier`)
replaces the flat aggregation and verification.

Elastic membership (``n_events > 0``, ``core.sybil``): the peer axis is a
capacity of slots, each vacant, in probation, active or banned. A
join/leave schedule (:func:`encode_events`) fires before each round
(:func:`phase_membership`); a probation row is attacked and spot-checked
against its public-seed recompute but zeroed before the aggregate, banned
(``BAN_SYBIL``) on one mismatch and promoted after ``probation_steps``
clean checks; the ``id_*`` ledgers are keyed by identity, so churn never
launders a ban. The schedule is a host tensor, since which events fire at
``state.step`` is a host decision; whether a fired event applies (a leave
of a vacant slot, a join onto an occupied one) is decided on the device.
With ``n_events == 0`` none of it runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aggregators as agg_mod
from repro_torch.core import attacks as attacks_mod
from repro_torch.core import butterfly as bf
from repro_torch.core import compression as comp_mod
from repro_torch.core import hierarchy as hier_mod
from repro_torch.core import prng
from repro_torch.core import sybil as sybil_mod
from repro_torch.core import verification as verif_mod
from repro_torch.core.norms import vector_norm
from repro_torch.core.sybil import (  # noqa: F401 (the lifecycle codes)
    SLOT_ACTIVE,
    SLOT_BANNED,
    SLOT_PROBATION,
    SLOT_VACANT,
)

BAN_NONE = 0
BAN_CHEATER = 1  # accused and the recompute proved it (ACCUSE, Alg. 4)
BAN_COVERUP = 2  # misreported s for a banned peer's partition
BAN_FALSE_ACCUSER = 3  # slandered an honest peer (Hammurabi rule, Alg. 3)
BAN_MPRNG = 4  # aborted / mismatched the MPRNG commit-reveal (App. A.2)
BAN_SYBIL = 5  # failed a probation spot-check (Sybil gate, §3.3 / App. F)

BAN_REASON_NAMES = {
    BAN_NONE: "",
    BAN_CHEATER: "accusation verified (ACCUSE)",
    BAN_COVERUP: "covered up a banned peer (s mismatch)",
    BAN_FALSE_ACCUSER: "false accusation",
    BAN_MPRNG: "mprng abort/mismatch",
    BAN_SYBIL: "probation spot-check failed (sybil gate)",
}

# Membership event codes (ProtocolState.events rows: [step, kind, slot, id])
EVENT_NONE = 0
EVENT_JOIN = 1
EVENT_LEAVE = 2


class ProtocolState(NamedTuple):
    """One run's per-step carry. Every draw is a fold of (key, step,
    phase), so a step's randomness is a function of the state alone."""

    step: int  # t
    key: torch.Tensor  # (2,) base key of the per-step chain
    active: torch.Tensor  # (n,) f32, 1 = active
    validator: torch.Tensor  # (n,) f32, this step's validators
    prev_agg: torch.Tensor  # (n_parts, part) f32, last clean aggregate
    ban_step: torch.Tensor  # (n,) i32, -1 while active
    ban_reason: torch.Tensor  # (n,) i32, BAN_* code
    accused_count: torch.Tensor  # (n,) i32, cumulative accusations
    last_checked: torch.Tensor  # (n,) i32, step last audited
    col_checked: torch.Tensor  # (n,) i32, step each column was checked
    delay_buf: torch.Tensor | None  # (D, n, d), delayed_gradient only
    # elastic membership (core.sybil)
    lifecycle: torch.Tensor  # (n,) i32, SLOT_* code per slot
    slot_identity: torch.Tensor  # (n,) i32, the occupant's identity, -1
    probation_clean: torch.Tensor  # (n,) i32, consecutive clean checks
    events: torch.Tensor  # (n_events, 4) i32 on the host: [step, kind,
    # slot, identity]
    id_ban_step: torch.Tensor  # (n_ids,) i32, identity ban ledger, -1
    id_ban_reason: torch.Tensor  # (n_ids,) i32, BAN_* per identity
    id_accused: torch.Tensor  # (n_ids,) i32, per-identity accusations


class StepOutputs(NamedTuple):
    g_hat: torch.Tensor  # (d,) the robust aggregate
    seed: torch.Tensor  # () the step's MPRNG output
    banned_now: torch.Tensor  # (n,) bool
    ban_reason_now: torch.Tensor  # (n,) i32
    accuse_mat: torch.Tensor  # (n, n) bool, accuser x target
    sys_accuse: torch.Tensor  # (n,) bool, checksum / Delta_max
    cheated: torch.Tensor  # (n,) bool, recompute verdict per peer
    checksum_violations: torch.Tensor  # () i32
    check_averaging: torch.Tensor  # () i32
    n_active: torch.Tensor  # () i32, active count at step start
    validators: torch.Tensor  # (n,) f32, this step's validator mask
    clip_iters_used: int  # largest CenteredClip budget any partition ran
    sampled_parts: torch.Tensor  # (n,) bool, digest columns broadcast this
    # step (all True when sampled-digest audits are off)
    lifecycle: torch.Tensor  # (n,) i32, post-step SLOT_* code per slot


@dataclass(frozen=True)
class EngineConfig:
    """Static protocol configuration (the JAX package's fields)."""

    n: int
    d: int
    tau: float = 1.0
    clip_iters: int = 60
    m_validators: int = 1
    delta_max: float | None = None
    clip_lambda: float | None = None
    attack: str = "none"
    start_step: int = 0
    end_step: int = 10**9
    lam: float = 1000.0
    delay: int = 1000
    aggregator_attack: bool = False
    aggregator_scale: float = 0.0
    misreport_s: bool = True
    false_accuse: bool = False
    mprng_abort: bool = False
    warm_start: bool = False
    adaptive_tol: float | None = None
    aggregator: object = None
    audit_k: int | None = None
    groups: int | None = None
    # elastic membership: capacity of the join/leave event table, 0 = a
    # fixed peer set (no membership machinery runs)
    n_events: int = 0
    # consecutive clean spot-checks before probation -> active (App. F)
    probation_steps: int = 4
    # identity-ledger capacity; 0 = n + n_events
    max_identities: int = 0

    def __post_init__(self):
        if self.audit_k is not None and self.audit_k < 1:
            raise ValueError("audit_k must be >= 1 (None = full tables)")
        if self.hierarchical:
            hier_mod.group_shape(self.n, self.groups)  # validates n % g
        if self.n_events < 0 or self.probation_steps < 1:
            raise ValueError("n_events >= 0 and probation_steps >= 1")

    def agg_spec(self) -> agg_mod.AggregatorSpec:
        """The resolved spec, the legacy knobs filled in as defaults."""
        return agg_mod.resolve_spec(self.aggregator).with_defaults(
            tau=self.tau, n_iters=self.clip_iters, max_iters=self.clip_iters,
            adaptive_tol=self.adaptive_tol, warm_start=self.warm_start)

    @property
    def hierarchical(self) -> bool:
        return self.groups is not None and self.groups > 1

    @property
    def elastic(self) -> bool:
        return self.n_events > 0

    @property
    def n_ids(self) -> int:
        return max(self.max_identities, self.n + self.n_events)

    @property
    def n_parts(self) -> int:
        return self.n

    @property
    def part(self) -> int:
        return bf.pad_to_parts(self.d, self.n) // self.n

    @property
    def has_gradient_attack(self) -> bool:
        return self.attack not in ("none", "label_flip")

    @property
    def has_any_attack(self) -> bool:
        return (self.attack != "none" or self.aggregator_attack
                or self.false_accuse or self.mprng_abort)

    @property
    def delay_depth(self) -> int:
        return max(1, self.delay) if self.attack == "delayed_gradient" else 1


def config_from_attack(n, d, attack, **kw) -> EngineConfig:
    """An EngineConfig from an AttackConfig plus the protocol kwargs."""
    return EngineConfig(
        n=n, d=d, attack=attack.kind, start_step=attack.start_step,
        end_step=attack.end_step, lam=attack.lam, delay=attack.delay,
        aggregator_attack=attack.aggregator_attack,
        aggregator_scale=attack.aggregator_scale,
        misreport_s=attack.misreport_s, false_accuse=attack.false_accuse,
        mprng_abort=attack.mprng_abort, **kw)


def encode_events(cfg: EngineConfig, schedule) -> torch.Tensor:
    """A churn schedule -> the ``(cfg.n_events, 4)`` int32 event table
    (on the host) that :class:`ProtocolState` carries.

    ``schedule``: ``(step, kind, slot)`` / ``(step, kind, slot, identity)``
    tuples (kind ``"join"``/``"leave"`` or an EVENT_* code) or
    :class:`core.sybil.MembershipEvent`. A join WITHOUT an identity gets a
    fresh one (``n``, ``n+1``, ... in schedule order): the rejoin under a
    new key; the identity of a banned peer is the same-key rejoin,
    re-banned at admission from the identity ledger. Rows sort by (step,
    leaves first), so a leave and a join on one slot at one step are a
    handoff; unused rows are inert (step -1 never fires)."""
    kind_codes = {"join": EVENT_JOIN, "leave": EVENT_LEAVE,
                  EVENT_JOIN: EVENT_JOIN, EVENT_LEAVE: EVENT_LEAVE}
    rows, next_id = [], cfg.n
    for ev in schedule:
        if isinstance(ev, sybil_mod.MembershipEvent):
            ev = (ev.step, ev.kind, ev.slot)
        step, kind, slot = ev[0], kind_codes[ev[1]], ev[2]
        if not 0 <= slot < cfg.n:
            raise ValueError(f"event slot {slot} outside [0, {cfg.n})")
        if kind == EVENT_JOIN:
            ident = ev[3] if len(ev) > 3 else next_id
            next_id = max(next_id, ident + 1)
            if not 0 <= ident < cfg.n_ids:
                raise ValueError(
                    f"identity {ident} outside [0, {cfg.n_ids}); raise "
                    "EngineConfig.max_identities")
        else:
            ident = -1
        rows.append((int(step), int(kind), int(slot), int(ident)))
    if len(rows) > cfg.n_events:
        raise ValueError(
            f"{len(rows)} events > EngineConfig.n_events={cfg.n_events}")
    rows.sort(key=lambda r: (r[0], 0 if r[1] == EVENT_LEAVE else 1))
    rows += [(-1, EVENT_NONE, 0, -1)] * (cfg.n_events - len(rows))
    return torch.tensor(rows, dtype=torch.int32).reshape(cfg.n_events, 4)


def init_state(cfg: EngineConfig, seed: int = 0, events=None, vacant=(),
               device=None) -> ProtocolState:
    """The initial state, on the CUDA device unless ``device`` says
    otherwise (the event table stays on the host). ``events``: a churn
    schedule (anything :func:`encode_events` takes) or an encoded
    (n_events, 4) table; ``vacant``: slots that start unoccupied. The
    delayed-gradient ring buffer exists only for that attack (the JAX
    package carries a dense (1, n, d) one always)."""
    device = resolve_device(device)
    n = cfg.n
    if cfg.attack == "delayed_gradient" and cfg.delay_depth * n * cfg.d > 2**28:
        raise ValueError(
            f"delayed_gradient ring buffer would be (delay={cfg.delay}, n={n},"
            f" d={cfg.d}); set AttackConfig.delay to the delay you want")
    i32 = dict(dtype=torch.int32, device=device)
    lifecycle = torch.full((n,), SLOT_ACTIVE, **i32)
    slot_identity = torch.arange(n, **i32)
    for s in vacant:
        lifecycle[int(s)] = SLOT_VACANT
        slot_identity[int(s)] = -1
    if events is None:
        ev = torch.full((cfg.n_events, 4), -1, dtype=torch.int32)
    elif getattr(events, "ndim", 0) == 2:
        ev = torch.as_tensor(np.asarray(events), dtype=torch.int32)
        if tuple(ev.shape) != (cfg.n_events, 4):
            raise ValueError(
                f"events shape {tuple(ev.shape)} != ({cfg.n_events}, 4)")
    else:
        ev = encode_events(cfg, events)
    key = prng.key(seed, device=device)
    active0 = (lifecycle == SLOT_ACTIVE).to(torch.float32)
    validator = _elect(cfg, prng.fold_in(key, 2**31 - 1), active0)
    delay_buf = None
    if cfg.attack == "delayed_gradient":
        delay_buf = torch.zeros(
            (cfg.delay_depth, n, cfg.d),
            dtype=torch.bfloat16 if cfg.delay_depth > 1 else torch.float32,
            device=device)
    return ProtocolState(
        step=0, key=key, active=active0, validator=validator,
        prev_agg=torch.zeros((cfg.n_parts, cfg.part), dtype=torch.float32,
                             device=device),
        ban_step=torch.full((n,), -1, **i32),
        ban_reason=torch.zeros((n,), **i32),
        accused_count=torch.zeros((n,), **i32),
        last_checked=torch.full((n,), -1, **i32),
        col_checked=torch.full((n,), -1, **i32),
        delay_buf=delay_buf,
        lifecycle=lifecycle,
        slot_identity=slot_identity,
        probation_clean=torch.zeros((n,), **i32),
        events=ev,
        id_ban_step=torch.full((cfg.n_ids,), -1, **i32),
        id_ban_reason=torch.zeros((cfg.n_ids,), **i32),
        id_accused=torch.zeros((cfg.n_ids,), **i32),
    )


def state_to_tree(cfg: EngineConfig, state: ProtocolState) -> ProtocolState:
    """``state`` in the JAX package's layout, the tree its checkpoints hold
    (``checkpoint.save_checkpoint``): ``step`` an int32 0-d array, ``key``
    the two words as uint32 (``jax.random.PRNGKey``), and ``delay_buf`` the
    reference's float32 ``(1, n, d)`` zeros where the port holds ``None``
    (no delayed-gradient attack). The other leaves are the state's own."""
    delay_buf = state.delay_buf
    if delay_buf is None:
        delay_buf = np.zeros((cfg.delay_depth, cfg.n, cfg.d), np.float32)
    return state._replace(
        step=np.asarray(state.step, np.int32),
        key=state.key.to("cpu").numpy().astype(np.uint32),
        delay_buf=delay_buf)


def state_from_tree(cfg: EngineConfig, tree, device=None) -> ProtocolState:
    """The inverse of :func:`state_to_tree`: a tree of the JAX package's
    layout (e.g. ``load_checkpoint(path, state_to_tree(cfg, example))``)
    as the port's state on ``device`` (CUDA unless told otherwise; the
    event table stays on the host). ``delay_buf`` is dropped unless
    ``cfg`` has the delayed-gradient attack."""
    device = resolve_device(device)

    def dev(x):
        return torch.as_tensor(x).to(device)

    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.asarray(x)

    key = host(tree.key).astype(np.uint32).astype(np.int64)
    return ProtocolState(**{
        f: dev(getattr(tree, f)) for f in ProtocolState._fields
        if f not in ("step", "key", "delay_buf", "events")},
        step=int(host(tree.step)),
        key=torch.from_numpy(key).to(device),
        delay_buf=(dev(tree.delay_buf)
                   if cfg.attack == "delayed_gradient" else None),
        events=torch.as_tensor(tree.events).to("cpu"))


# ---------------------------------------------------------------------------
# Phase functions
# ---------------------------------------------------------------------------
def _attacking(cfg: EngineConfig, t: int) -> bool:
    return cfg.has_any_attack and cfg.start_step <= t < cfg.end_step


def _phase_key(state: ProtocolState, phase: int):
    return prng.fold_in(prng.fold_in(state.key, state.step), phase)


def flip_mask(cfg: EngineConfig, state: ProtocolState, byz_mask):
    """Peers whose gradients are computed with flipped labels this step.
    Probation rows flip too: their public-seed work is what the Sybil gate
    spot-checks, so the attack must be allowed to land there."""
    byz = torch.as_tensor(byz_mask, device=state.active.device) > 0
    if cfg.attack != "label_flip" or not _attacking(cfg, state.step):
        return torch.zeros_like(byz)
    return byz & ((state.active > 0) | (state.lifecycle == SLOT_PROBATION))


def phase_membership(cfg: EngineConfig, state: ProtocolState) -> ProtocolState:
    """Fire this step's join/leave events before the round runs, in row
    order (leaves first at a step).

    Leave: the slot goes vacant, and the SLOT ledgers (ban_step,
    ban_reason, accused_count, probation_clean) reset with its occupant,
    whose history lives on in the identity ledgers. Join: only onto a
    vacant slot; the incoming identity's history comes back from the
    identity ledgers: a banned identity (same-key rejoin) lands in BANNED
    with its ban step and reason, anyone else starts PROBATION at zero
    clean checks. ``col_checked`` and ``last_checked`` describe the
    topology, not the occupant, and stay. An event whose precondition
    fails is a no-op: each write is masked to the one slot where it
    applies, never clamped into another."""
    if not cfg.elastic:
        return state
    n = cfg.n
    lifecycle, slot_identity = state.lifecycle, state.slot_identity
    clean, accused = state.probation_clean, state.accused_count
    ban_step, ban_reason = state.ban_step, state.ban_reason
    slots = torch.arange(n, device=lifecycle.device)

    def put(mask, value, into):
        return torch.where(mask, torch.as_tensor(value, dtype=into.dtype,
                                                 device=into.device), into)

    for step, kind, slot, ident in state.events.tolist():
        if step != state.step:
            continue
        at = slots == min(max(slot, 0), n - 1)
        if kind == EVENT_LEAVE:
            do = at & (lifecycle != SLOT_VACANT)
            lifecycle = put(do, SLOT_VACANT, lifecycle)
            slot_identity = put(do, -1, slot_identity)
            clean = put(do, 0, clean)
            accused = put(do, 0, accused)
            ban_step = put(do, -1, ban_step)
            ban_reason = put(do, BAN_NONE, ban_reason)
        elif kind == EVENT_JOIN:
            ident = min(max(ident, 0), cfg.n_ids - 1)
            do = at & (lifecycle == SLOT_VACANT)
            id_ban = state.id_ban_step[ident]
            pre_banned = id_ban >= 0
            lifecycle = put(do, torch.where(pre_banned, SLOT_BANNED,
                                            SLOT_PROBATION), lifecycle)
            slot_identity = put(do, ident, slot_identity)
            clean = put(do, 0, clean)
            accused = put(do, state.id_accused[ident], accused)
            ban_step = put(do, torch.where(pre_banned, id_ban, -1), ban_step)
            ban_reason = put(do, torch.where(
                pre_banned, state.id_ban_reason[ident], BAN_NONE), ban_reason)
    active = (lifecycle == SLOT_ACTIVE).to(torch.float32)
    return state._replace(
        lifecycle=lifecycle, slot_identity=slot_identity,
        probation_clean=clean, accused_count=accused, ban_step=ban_step,
        ban_reason=ban_reason, active=active,
        validator=state.validator * active)


def phase_attack(cfg, state, G, honest_G, byz, engage_b=None):
    """Byzantine rows swap in their attack vectors; the delay ring buffer
    rotates; honest peers optionally self-clip (Alg. 9). ``engage_b``
    widens the attacked rows beyond the active set (the elastic path adds
    the probation rows, so the Sybil spot-check sees the attack)."""
    t = state.step
    active_b = state.active > 0 if engage_b is None else engage_b
    delay_buf = state.delay_buf
    if cfg.has_gradient_attack and _attacking(cfg, t):
        delayed = None
        if delay_buf is not None:
            delayed = delay_buf[t % cfg.delay_depth].to(torch.float32)
        G = attacks_mod.apply_attack(
            attacks_mod.attack_index(cfg.attack), G, byz & active_b,
            key=_phase_key(state, 1), lam=cfg.lam, delayed=delayed,
            hon_mask=~byz & active_b)
    if cfg.attack == "delayed_gradient":
        delay_buf = delay_buf.clone()
        delay_buf[t % cfg.delay_depth] = torch.where(
            (byz & active_b)[:, None], honest_G, 0.0).to(delay_buf.dtype)
    if cfg.clip_lambda is not None:
        nrm = vector_norm(G, dim=1)
        scale = torch.clamp(cfg.clip_lambda / torch.clamp(nrm, min=1e-30),
                            max=1.0)
        clip_rows = (~byz)[:, None]
        G = torch.where(clip_rows, G * scale[:, None], G)
        honest_G = torch.where(clip_rows, G, honest_G)
    return G, honest_G, delay_buf


def _in_place_covers(cfg, G) -> bool:
    """Whether :func:`_attack_in_place` covers this step's configuration:
    a float32 stack, an attack that replaces each attacked row from that
    row alone (or none), and nothing that reads the honest copy beyond
    the row mismatch (no delay buffer, self-clip, probation gate or wire
    projection)."""
    return (G.dtype == torch.float32 and not cfg.elastic
            and cfg.clip_lambda is None
            and not comp_mod.is_wrapped(cfg.agg_spec())
            and cfg.attack in ("none", "sign_flip", "label_flip"))


def _attack_in_place(cfg, state, G, attacked):
    """:func:`phase_attack` on a stack that is its own honest copy, in
    place, one row at a time (a (d,) temporary, never a second stack):
    the sign flip's rows get ``attacks.sign_flipped``, the bits of
    ``attacks.sign_flip``. Returns (n,) bool, what ``torch.any(G !=
    honest_G, dim=1)`` gives after the copying attack: an attacked row
    against its honest values, any other row against itself."""
    flip = cfg.attack == "sign_flip" and _attacking(cfg, state.step)
    rows = set(torch.nonzero(attacked).flatten().tolist()) if flip else ()
    mismatch = []
    for i in range(G.shape[0]):
        row = G[i]
        if i in rows:
            mal = attacks_mod.sign_flipped(row, cfg.lam)
            mismatch.append(torch.any(mal != row))
            row.copy_(mal)
            del mal
        else:
            mismatch.append(torch.any(row != row))
    return torch.stack(mismatch)


def phase_mprng(cfg, state, byz):
    """The shared seed plus the abort-ban outcome (App. A.2)."""
    seed = prng.randint(_phase_key(state, 0), (), 0, 2**31 - 1)
    mprng_ban = torch.zeros_like(byz)
    if cfg.mprng_abort and _attacking(cfg, state.step):
        mprng_ban = (seed % 2 == 1) & byz & (state.active > 0)
    return seed, mprng_ban


def _scatter_cols(values, idx, n, n_cols):
    """(n, k) sampled-column tables -> zero (n, n_cols) tables with column
    idx[j] = values[:, j]. Unsampled columns are zero on both the reported
    and the recomputed side, so every mismatch, checksum and vote term is
    silent there."""
    out = torch.zeros((n, n_cols), dtype=torch.float32, device=values.device)
    out[:, idx.long()] = values
    return out


def _sampled_tables(cfg, grads, agg, z, samp_idx):
    """The tables of the sampled columns only (one pass of the sampled
    partitions of ``grads``) against ``agg``, scattered into zero
    (n, n_parts) tables. Returns (s_tbl, norm_tbl)."""
    s_r, n_r = verif_mod.digest_tables_rows(cfg.agg_spec(), grads, agg, z,
                                            samp_idx)
    return (_scatter_cols(s_r, samp_idx, cfg.n, cfg.n_parts),
            _scatter_cols(n_r, samp_idx, cfg.n, cfg.n_parts))


def phase_aggregation(cfg, state, G, weights, seed, samp_idx=None,
                      G_cmp=None):
    """Spec-dispatched robust aggregation. Verifiable specs run
    ``verification.spec_aggregate`` with the tables (unless the aggregator
    attack needs them recomputed against the corrupted value); under
    sampled-digest audits (``samp_idx``) they aggregate without tables and
    then digest only the sampled columns of ``G_cmp`` (the wire values for
    a compressed spec), scattered into zero tables. The non-verifiable
    baselines run their flat fn, with no tables (z, s_tbl, norm_tbl come
    back None). Returns (agg, z, s_tbl, norm_tbl, iters_used)."""
    spec = cfg.agg_spec()
    if not spec.verifiable:
        flat, info = spec.build(cfg.n, cfg.d)(
            G, weights if spec.weighted else None, None, None)
        agg = bf.split_parts(flat.to(torch.float32)[None, :],
                             cfg.n_parts)[0]
        return agg, None, None, None, info.iters
    z = bf.get_random_directions(seed, cfg.n_parts, cfg.part)
    v0 = None
    if spec.warm_startable and spec.get("warm_start", False):
        v0 = (state.prev_agg if state.step > 0
              else torch.zeros_like(state.prev_agg))
    attacking_agg = cfg.aggregator_attack and cfg.aggregator_scale > 0
    if attacking_agg or samp_idx is not None:
        # no fused tables: the aggregator attack recomputes them against
        # the corrupted value, sampled audits digest the sampled columns
        agg, _s, _n, iters = verif_mod.spec_aggregate(
            spec, G, z=None, weights=weights, v0=v0)
        if attacking_agg:
            return agg, z, None, None, iters
        return (agg, z, *_sampled_tables(cfg, G_cmp, agg, z, samp_idx),
                iters)
    agg, s_tbl, norm_tbl, iters = verif_mod.spec_aggregate(
        spec, G, z=z, weights=weights, v0=v0)
    return agg, z, s_tbl, norm_tbl, iters


def phase_aggregator_attack(cfg, state, agg, G, z, byz, weights,
                            samp_idx=None):
    """Byzantine aggregators corrupt their partitions; every peer then
    reports tables against the value it received (over the wire values
    ``G`` for a compressed spec). Under sampled-digest audits only the
    sampled columns exist, so a corrupted unsampled column goes unseen
    until its turn, within the staleness bound."""
    honest_agg = agg
    corrupt = torch.zeros((cfg.n_parts,), dtype=torch.bool, device=agg.device)
    if not (cfg.aggregator_attack and cfg.aggregator_scale > 0):
        return agg, honest_agg, corrupt, None, None
    if _attacking(cfg, state.step):
        corrupt = byz & (state.active > 0)
        agg = attacks_mod.aggregator_shift_all(
            agg, corrupt, _phase_key(state, 3), cfg.aggregator_scale)
    if samp_idx is not None:
        s_tbl, norm_tbl = _sampled_tables(cfg, G, agg, z, samp_idx)
    else:
        s_tbl, norm_tbl = verif_mod.spec_tables(cfg.agg_spec(), G, agg, z)
    return agg, honest_agg, corrupt, s_tbl, norm_tbl


def phase_misreport(cfg, s_tbl, corrupt, byz, active, weights):
    """The first active colluder cancels sum_i w_i s_i^j for each
    corrupted partition j."""
    if not (cfg.aggregator_attack and cfg.misreport_s):
        return s_tbl
    is_liar_cand = byz & (active > 0)
    liar = int(torch.argmax(is_liar_cand.to(torch.int32)))
    has_liar = is_liar_cand.any()
    w_liar = weights[liar]
    col_sums = (s_tbl * weights[:, None]).sum(0)
    others = col_sums - w_liar * s_tbl[liar]
    lie = -others / torch.clamp(w_liar, min=1e-30)
    new_row = torch.where(corrupt & has_liar & (w_liar > 0), lie, s_tbl[liar])
    s_tbl = s_tbl.clone()
    s_tbl[liar] = new_row
    return s_tbl


def _choose_targets(cfg, state, active_b):
    """Audit-age-weighted CHOOSETARGET: validator v audits target[v], the
    m highest (age + U(0,1)) candidates. Returns (target, valid_audit,
    is_validator, target_hot (n, n) bool, audited (n,) bool)."""
    n = cfg.n
    cand = active_b & (state.validator <= 0)
    n_cand = cand.sum()
    u = prng.uniform(_phase_key(state, 5), (n,))
    age = (state.step - state.last_checked).to(torch.float32)
    score = torch.where(cand, age + u, torch.full_like(u, -torch.inf))
    order = torch.argsort(-score, stable=True)
    is_validator = (state.validator > 0) & active_b
    val_ord = torch.clamp(torch.cumsum(is_validator.to(torch.int64), 0) - 1,
                          0, n - 1)
    target = order[val_ord]
    valid_audit = is_validator & (val_ord < n_cand)
    target_hot = torch.nn.functional.one_hot(target, n).to(torch.bool)
    audited = (target_hot & valid_audit[:, None]).any(0)
    return target, valid_audit, is_validator, target_hot, audited


def phase_verify(cfg, state, G, grad_mismatch, agg, honest_agg, s_tbl,
                 true_s, norm_tbl, true_norm, byz, weights):
    """Verifications 1-3 and the validator spot checks -> accusations.
    ``grad_mismatch`` (n,): the rows of G that differ from their honest
    recompute."""
    active_b = state.active > 0
    mismatch_norm = (norm_tbl - true_norm).abs() > 1e-4 * (1.0 + true_norm)
    mismatch_s = (s_tbl - true_s).abs() > 1e-4 * (1.0 + true_s.abs())

    # V1 + V2a: honest aggregator j accuses any i misreporting for column j
    agg_ok = active_b & ~byz
    accuse = agg_ok[:, None] & (mismatch_norm | mismatch_s).T

    # V2b: the zero checksum per partition (system accusation on the owner)
    if verif_mod.has_zero_checksum(cfg.agg_spec()):
        cs_tol = bf.checksum_tolerance(agg, G)
        sums = (s_tbl * weights[:, None]).sum(0)
        sys_accuse = sums.abs() > cs_tol
    else:
        sys_accuse = torch.zeros_like(active_b)
    checksum_violations = sys_accuse.sum().to(torch.int32)

    # V3: Delta_max majority vote -> CHECKAVERAGING(j)
    check_averaging = torch.zeros((), dtype=torch.int32, device=G.device)
    if cfg.delta_max is not None:
        votes = ((true_norm > cfg.delta_max) * weights[:, None]).sum(0)
        v3 = votes > weights.sum() / 2.0
        check_averaging = v3.sum().to(torch.int32)
        sys_accuse = sys_accuse | v3

    target, valid_audit, is_validator, target_hot, audited = _choose_targets(
        cfg, state, active_b)
    row_tol = 1e-4 * (1.0 + true_s.abs().amax(dim=1))
    s_row_mismatch = (s_tbl - true_s).abs().amax(dim=1) > row_tol
    agg_mismatch = torch.any(agg != honest_agg, dim=1)
    caught = (grad_mismatch[target] | s_row_mismatch[target]
              | agg_mismatch[target])
    val_accuse = is_validator & ~byz & caught & valid_audit
    if cfg.false_accuse and _attacking(cfg, state.step):
        val_accuse = val_accuse | (is_validator & byz & valid_audit)
    accuse = accuse | (target_hot & val_accuse[:, None])
    last_checked = torch.where(
        audited, torch.full_like(state.last_checked, state.step),
        state.last_checked)

    accuse = accuse & active_b[:, None] & active_b[None, :]
    sys_accuse = sys_accuse & active_b
    return (accuse, sys_accuse, mismatch_s, checksum_violations,
            check_averaging, last_checked)


def phase_accuse_ban(cfg, state, accuse, sys_accuse, mismatch_s, mprng_ban,
                     grad_mismatch, agg, honest_agg, s_tbl, true_s, norm_tbl,
                     true_norm):
    """ACCUSE resolution (Alg. 4): the accused peer's work is recomputed
    (``grad_mismatch``: its gradient row differs from the recompute);
    the target is guilty if the accusation holds (and so is everyone who
    covered for it), else the accuser is."""
    active_b = state.active > 0
    cheated = (
        grad_mismatch
        | torch.any((s_tbl - true_s).abs() > 1e-5 + 1e-3 * true_s.abs(), dim=1)
        | torch.any((norm_tbl - true_norm).abs()
                    > 1e-5 + 1e-3 * true_norm.abs(), dim=1)
        | torch.any(agg != honest_agg, dim=1)
    )
    accused = sys_accuse | accuse.any(dim=0)
    ban_cheater = accused & cheated & active_b
    ban_coverup = (mismatch_s & ban_cheater[None, :]).any(dim=1) & active_b
    ban_false = (accuse & ~cheated[None, :]).any(dim=1) & active_b
    banned_now = ban_cheater | ban_coverup | ban_false | (mprng_ban & active_b)

    def code(c):
        return torch.full_like(state.ban_reason, c)

    reason = torch.where(
        ban_cheater, code(BAN_CHEATER),
        torch.where(ban_coverup, code(BAN_COVERUP),
                    torch.where(ban_false, code(BAN_FALSE_ACCUSER),
                                torch.where(mprng_ban, code(BAN_MPRNG),
                                            code(BAN_NONE)))))
    reason = torch.where(banned_now, reason, code(BAN_NONE))
    new_active = state.active * (~banned_now).to(torch.float32)
    return new_active, banned_now, reason, cheated, accused.to(torch.int32)


def _block_diag(blocks):
    """(g, gs, gs) blocks -> the (n, n) matrix with block a at rows and
    columns a*gs .. (a+1)*gs, zero (False) elsewhere."""
    g, gs = blocks.shape[0], blocks.shape[1]
    out = torch.zeros((g * gs, g * gs), dtype=blocks.dtype,
                      device=blocks.device)
    for a in range(g):
        out[a * gs:(a + 1) * gs, a * gs:(a + 1) * gs] = blocks[a]
    return out


def phase_hier(cfg, state, byz, weights, seed, G, G_cmp, grad_mismatch,
               samp_mask, mprng_ban):
    """The hierarchical butterfly-of-butterflies: aggregation, aggregator
    attack, misreport, verification and accuse/ban in the two-level
    topology (``core.hierarchy``).

    Level 1: each group of gs = n/groups peers runs the spec over its own
    butterfly, with gs x gs tables per group. Level 2: the linear leader
    combine with its always-on zero-sum checksum; a violated
    super-partition implicates its group's leader. Accusations stay
    (n, n): the level-1 blocks go on the diagonal, so
    :func:`phase_accuse_ban` runs unchanged. ``samp_mask`` (n,) composes
    sampled-digest audits in: global cell a*gs + c guards column c of group
    a's tables.

    Returns the tail the flat verifiable branch produces, plus the global
    aggregate in the (n_parts, part) layout and the iteration budget.
    """
    n = cfg.n
    g, gs = hier_mod.group_shape(n, cfg.groups)
    active = state.active
    active_b = active > 0
    att = _attacking(cfg, state.step)
    spec = cfg.agg_spec()

    attacking_agg = bool(cfg.aggregator_attack and cfg.aggregator_scale > 0)
    v0_flat = None
    if spec.warm_startable and spec.get("warm_start", False):
        v0_flat = (bf.merge_parts(state.prev_agg, cfg.d) if state.step > 0
                   else torch.zeros((cfg.d,), device=G.device))
    h = hier_mod.hier_aggregate(spec, G, weights, seed, cfg.groups,
                                v0_flat=v0_flat,
                                with_tables=not attacking_agg)
    u, s1, norms1 = h.u, h.s1, h.norms1
    part1 = u.shape[-1]
    corrupt = torch.zeros((n,), dtype=torch.bool, device=G.device)
    if attacking_agg:
        # cell (a, r) of the level-1 aggregate is owned by peer a*gs + r,
        # so the flat (n,)-masked shift applies to the (n, part1) reshape
        if att:
            corrupt = byz & active_b
            u = attacks_mod.aggregator_shift_all(
                u.reshape(n, part1), corrupt, _phase_key(state, 3),
                cfg.aggregator_scale).reshape(u.shape)
        s1, norms1 = hier_mod.hier_tables(spec, G_cmp, u, h.z1)

    wg = weights.reshape(g, gs)
    if samp_mask is not None:
        samp_h = samp_mask.reshape(g, gs)[:, None, :]
        s1 = torch.where(samp_h, s1, 0.0)
        norms1 = torch.where(samp_h, norms1, 0.0)
    true_s1, true_norm1 = s1, norms1
    # per group: its first active colluder cancels its group's checksum
    # for the corrupted columns
    s1 = torch.stack([
        phase_misreport(cfg, s1[a], corrupt.reshape(g, gs)[a],
                        byz.reshape(g, gs)[a], active.reshape(g, gs)[a],
                        wg[a])
        for a in range(g)])

    # level 2: honest leaders relay faithfully, so reported == recomputed
    # and the linear checksum is the alarm for a group-level corruption
    lvl2 = hier_mod.level2_combine(u, h.group_w, cfg.d, seed)
    v_flat = bf.merge_parts(lvl2.v2, cfg.d)
    agg_std = bf.split_parts(v_flat[None, :], cfg.n_parts)[0]

    # ---- V1/V2/V3 per group, the level-2 checksum, validator audits ----
    mm_norm = (norms1 - true_norm1).abs() > 1e-4 * (1.0 + true_norm1)
    mm_s = (s1 - true_s1).abs() > 1e-4 * (1.0 + true_s1.abs())
    agg_ok_g = (active_b & ~byz).reshape(g, gs)
    accuse = _block_diag(agg_ok_g[:, :, None]
                         & (mm_norm | mm_s).transpose(1, 2))
    mismatch_s = _block_diag(mm_s)

    if verif_mod.has_zero_checksum(spec):
        cs_tol = torch.stack([
            bf.checksum_tolerance(u[a], G_cmp[a * gs:(a + 1) * gs])
            for a in range(g)])
        sums1 = (s1 * wg[:, :, None]).sum(1)  # (g, gs) per group column
        sys_accuse = (sums1.abs() > cs_tol[:, None]).reshape(n)
    else:
        sys_accuse = torch.zeros_like(active_b)
    cs2_tol = bf.checksum_tolerance(lvl2.v2, lvl2.u_flat)
    sums2 = (lvl2.s2 * h.group_w[:, None]).sum(0)  # (g,)
    leader_accuse = torch.zeros_like(active_b)
    leader_accuse[torch.arange(g, device=G.device) * gs] = \
        sums2.abs() > cs2_tol
    sys_accuse = sys_accuse | leader_accuse
    checksum_violations = sys_accuse.sum().to(torch.int32)

    check_averaging = torch.zeros((), dtype=torch.int32, device=G.device)
    if cfg.delta_max is not None:
        # group-majority Delta_max vote over the group's weight mass
        votes = ((true_norm1 > cfg.delta_max) * wg[:, :, None]).sum(1)
        v3 = (votes > wg.sum(dim=1, keepdim=True) / 2.0).reshape(n)
        check_averaging = v3.sum().to(torch.int32)
        sys_accuse = sys_accuse | v3

    # validator CHOOSETARGET audit: a full-peer recompute, independent of
    # the digest sampling and of the topology
    target, valid_audit, is_validator, target_hot, audited = _choose_targets(
        cfg, state, active_b)
    s_h, true_s_h = s1.reshape(n, gs), true_s1.reshape(n, gs)
    row_tol = 1e-4 * (1.0 + true_s_h.abs().amax(dim=1))
    s_row_mismatch = (s_h - true_s_h).abs().amax(dim=1) > row_tol
    u_n, honest_u_n = u.reshape(n, part1), h.u.reshape(n, part1)
    agg_mismatch = torch.any(u_n != honest_u_n, dim=1)
    caught = (grad_mismatch[target] | s_row_mismatch[target]
              | agg_mismatch[target])
    val_accuse = is_validator & ~byz & caught & valid_audit
    if cfg.false_accuse and att:
        val_accuse = val_accuse | (is_validator & byz & valid_audit)
    accuse = accuse | (target_hot & val_accuse[:, None])
    last_checked = torch.where(
        audited, torch.full_like(state.last_checked, state.step),
        state.last_checked)

    accuse = accuse & active_b[:, None] & active_b[None, :]
    sys_accuse = sys_accuse & active_b

    (new_active, banned_now, reason, cheated,
     accused_inc) = phase_accuse_ban(
        cfg, state, accuse, sys_accuse, mismatch_s, mprng_ban,
        grad_mismatch, u_n, honest_u_n, s_h, true_s_h,
        norms1.reshape(n, gs), true_norm1.reshape(n, gs))
    return (new_active, banned_now, reason, cheated, accused_inc, accuse,
            sys_accuse, checksum_violations, check_averaging, last_checked,
            agg_std, h.iters)


def _elect(cfg: EngineConfig, key, active):
    """Next step's validators: m uniform draws without replacement over the
    active peers, never all of them (Alg. 1 L19)."""
    u = prng.uniform(key, (cfg.n,))
    score = torch.where(active > 0, u, torch.full_like(u, -torch.inf))
    rank = torch.argsort(torch.argsort(-score, stable=True), stable=True)
    m_eff = torch.clamp(torch.clamp(active.sum() - 1, min=0),
                        max=cfg.m_validators)
    return ((rank < m_eff) & (active > 0)).to(torch.float32)


# ---------------------------------------------------------------------------
# One full protocol step
# ---------------------------------------------------------------------------
def protocol_step(cfg: EngineConfig, state: ProtocolState, byz_mask, G,
                  honest_G, donate: bool = False):
    """One BTARD-SGD aggregation round: the membership events, then the
    hierarchical, the flat verifiable or the non-verifiable branch.

    G / honest_G: (n, d) — honest_G is what a validator recomputing from
    the public seed obtains (the same tensor as G unless labels were
    flipped). Rows of slots neither active nor in probation are zeroed
    here, probation rows after the attack and their spot-check. With
    ``donate`` (the caller drops G after the call, as ``jax.jit``'s
    donated buffers) a float32 G that is its own honest copy is zeroed
    and attacked in place where :func:`_attack_in_place` can: no second
    stack, the same bits. Returns (new_state, outputs).
    """
    spec = cfg.agg_spec()
    device = state.active.device
    byz = torch.as_tensor(byz_mask, device=device) > 0
    state = phase_membership(cfg, state)
    active = state.active
    active_b = active > 0
    validator = state.validator * active
    if spec.verifiable:
        weights = active * (1.0 - validator)  # Alg. 1 L19: validators sit out
    else:
        weights = active  # nothing to audit: every active peer contributes

    same = honest_G is G
    # probation rows keep their payloads through the attack (the Sybil gate
    # must see what they broadcast), are spot-checked every step, and are
    # zeroed before the aggregate and the accusations
    engaged = active_b
    if cfg.elastic:
        prob_b = state.lifecycle == SLOT_PROBATION
        engaged = active_b | prob_b
    grad_mismatch = None
    if donate and same and _in_place_covers(cfg, G):
        G.masked_fill_(~engaged[:, None], 0.0)
        grad_mismatch = _attack_in_place(cfg, state, G, byz & engaged)
        honest_G, delay_buf = None, state.delay_buf
    else:
        G = torch.where(engaged[:, None], G.to(torch.float32), 0.0)
        honest_G = G if same else torch.where(
            engaged[:, None], honest_G.to(torch.float32), 0.0)
        G, honest_G, delay_buf = phase_attack(cfg, state, G, honest_G, byz,
                                              engage_b=engaged)
    promote = sybil_ban = None
    probation_clean = state.probation_clean
    if cfg.elastic:
        probation_clean, promote, sybil_ban = sybil_mod.probation_step(
            prob_b, sybil_mod.probation_check(G, honest_G, prob_b),
            probation_clean, cfg.probation_steps)
        same = honest_G is G
        G = torch.where(active_b[:, None], G, 0.0)
        honest_G = G if same else torch.where(active_b[:, None], honest_G,
                                              0.0)
    seed, mprng_ban = phase_mprng(cfg, state, byz)

    # the sampled digest columns, a public fold of the step key; cell ==
    # column == owner peer id, flat and hierarchical (hier cell (a, c) is
    # peer a*gs + c), so one (n,) ledger serves both
    sampling = spec.verifiable and cfg.audit_k is not None
    samp_idx = samp_mask = None
    if sampling:
        samp_idx, samp_mask = hier_mod.sample_audit_cells(
            _phase_key(state, 6), state.step, state.col_checked,
            cfg.m_validators, cfg.audit_k, cfg.n)
        col_checked = torch.where(
            samp_mask, torch.full_like(state.col_checked, state.step),
            state.col_checked)
    else:
        col_checked = torch.full_like(state.col_checked, state.step)

    if spec.verifiable:
        # compressed:* specs: peers commit to (and validators recompute)
        # the WIRE payloads, so every compare below runs over the wire
        # projection of both sides; its partitions are the butterfly's,
        # gs per group in the hierarchical one
        G_cmp, honest_G_cmp = G, honest_G
        if comp_mod.is_wrapped(spec):
            codec = comp_mod.codec_of(spec)
            n_wire = (hier_mod.group_shape(cfg.n, cfg.groups)[1]
                      if cfg.hierarchical else cfg.n_parts)
            G_cmp = comp_mod.wire_grads(G, codec, n_wire)
            honest_G_cmp = (G_cmp if honest_G is G else
                            comp_mod.wire_grads(honest_G, codec, n_wire))
        # the rows a validator's recompute would not reproduce
        if grad_mismatch is None:
            grad_mismatch = torch.any(G_cmp != honest_G_cmp, dim=1)
        honest_G = honest_G_cmp = None  # nothing below reads them

    if spec.verifiable and cfg.hierarchical:
        (new_active, banned_now, reason, cheated, accused_inc, accuse,
         sys_accuse, cs_viol, chk_avg, last_checked, agg,
         iters_used) = phase_hier(cfg, state, byz, weights, seed, G, G_cmp,
                                  grad_mismatch, samp_mask, mprng_ban)
    elif spec.verifiable:
        agg, z, s_tbl, norm_tbl, iters_used = phase_aggregation(
            cfg, state, G, weights, seed, samp_idx, G_cmp)
        agg, honest_agg, corrupt, s2, n2 = phase_aggregator_attack(
            cfg, state, agg, G_cmp, z, byz, weights, samp_idx)
        if s_tbl is None:
            s_tbl, norm_tbl = s2, n2
        true_s, true_norm = s_tbl, norm_tbl
        s_tbl = phase_misreport(cfg, s_tbl, corrupt, byz, active, weights)

        (accuse, sys_accuse, mismatch_s, cs_viol, chk_avg,
         last_checked) = phase_verify(
            cfg, state, G_cmp, grad_mismatch, agg, honest_agg, s_tbl,
            true_s, norm_tbl, true_norm, byz, weights)
        (new_active, banned_now, reason, cheated,
         accused_inc) = phase_accuse_ban(
            cfg, state, accuse, sys_accuse, mismatch_s, mprng_ban,
            grad_mismatch, agg, honest_agg, s_tbl, true_s, norm_tbl,
            true_norm)
    else:
        agg, z, s_tbl, norm_tbl, iters_used = phase_aggregation(
            cfg, state, G, weights, seed)
        # no tables -> no verification, no accusations, no bans (the MPRNG
        # abort rule included): the attack lands in the aggregate
        n = cfg.n
        accuse = torch.zeros((n, n), dtype=torch.bool, device=device)
        sys_accuse = torch.zeros((n,), dtype=torch.bool, device=device)
        cheated = torch.zeros_like(sys_accuse)
        banned_now = torch.zeros_like(sys_accuse)
        cs_viol = torch.zeros((), dtype=torch.int32, device=device)
        chk_avg = torch.zeros_like(cs_viol)
        last_checked = state.last_checked
        reason = torch.zeros_like(state.ban_reason)
        accused_inc = torch.zeros_like(state.accused_count)
        new_active = active

    # lifecycle: protocol bans (active rows) and Sybil bans (probation
    # rows) are disjoint; promotions are clean probation rows. With a fixed
    # peer set the new active mask is active * (1 - banned_now) exactly.
    if sybil_ban is not None:
        banned_now = banned_now | sybil_ban
        reason = torch.where(sybil_ban, torch.full_like(reason, BAN_SYBIL),
                             reason)
        lifecycle = torch.where(
            promote, torch.full_like(state.lifecycle, SLOT_ACTIVE),
            state.lifecycle)
    else:
        lifecycle = state.lifecycle
    new_lifecycle = torch.where(
        banned_now, torch.full_like(lifecycle, SLOT_BANNED), lifecycle)
    new_active = (new_lifecycle == SLOT_ACTIVE).to(torch.float32)
    id_ban_step, id_ban_reason, id_accused = _identity_ledgers(
        cfg, state, banned_now, reason, accused_inc)

    next_validator = _elect(cfg, _phase_key(state, 4), new_active)
    g_hat = bf.merge_parts(agg, cfg.d)
    # warm-start hygiene: carry the aggregate forward only after a step
    # whose public misbehaviour signals were clean
    clean = ~banned_now.any() & (chk_avg == 0)
    new_state = ProtocolState(
        step=state.step + 1,
        key=state.key,
        active=new_active,
        validator=next_validator,
        prev_agg=torch.where(clean, agg.to(torch.float32), 0.0),
        ban_step=torch.where(banned_now,
                             torch.full_like(state.ban_step, state.step),
                             state.ban_step),
        ban_reason=torch.where(banned_now, reason, state.ban_reason),
        accused_count=state.accused_count + accused_inc,
        last_checked=last_checked,
        col_checked=col_checked,
        delay_buf=delay_buf,
        lifecycle=new_lifecycle,
        slot_identity=state.slot_identity,
        probation_clean=probation_clean,
        events=state.events,
        id_ban_step=id_ban_step,
        id_ban_reason=id_ban_reason,
        id_accused=id_accused,
    )
    out = StepOutputs(
        g_hat=g_hat, seed=seed, banned_now=banned_now, ban_reason_now=reason,
        accuse_mat=accuse, sys_accuse=sys_accuse, cheated=cheated,
        checksum_violations=cs_viol, check_averaging=chk_avg,
        n_active=active.sum().to(torch.int32), validators=validator,
        clip_iters_used=int(iters_used),
        sampled_parts=(samp_mask if sampling else
                       torch.ones((cfg.n,), dtype=torch.bool, device=device)),
        lifecycle=new_lifecycle)
    return new_state, out


def _identity_ledgers(cfg, state, banned_now, reason, accused_inc):
    """The identity ledgers after a step: an identity's first ban writes
    its step and reason once, and every occupied slot's accusations add
    to its identity's count. Writes go through one spare entry past the
    ledger, where every masked-out row lands, so no row is written into
    another identity. Returns (id_ban_step, id_ban_reason, id_accused)."""
    ident = state.slot_identity
    idc = torch.clamp(ident, 0, cfg.n_ids - 1).long()
    occupied = ident >= 0
    first_ban = banned_now & occupied & (state.id_ban_step[idc] < 0)
    spare = torch.full_like(idc, cfg.n_ids)

    def scatter(ledger, mask, values, add=False):
        buf = torch.cat([ledger, ledger[:1]])
        index = torch.where(mask, idc, spare)
        if add:
            buf.scatter_add_(0, index, values.to(buf.dtype))
        else:
            buf.scatter_(0, index, values.to(buf.dtype))
        return buf[:-1]

    steps = torch.full_like(state.ban_step, state.step)
    return (scatter(state.id_ban_step, first_ban, steps),
            scatter(state.id_ban_reason, first_ban, reason),
            scatter(state.id_accused, occupied, accused_inc, add=True))


# ---------------------------------------------------------------------------
# Data phase and the multi-step runner
# ---------------------------------------------------------------------------
def device_data_grads_fn(n: int, batch_fn: Callable, grad_fn: Callable,
                         label_flip: bool = False):
    """grads_fn(params, t, flips) -> (G, honest_G) over all n peers, each
    row the gradient on that peer's public-seed batch. With ``label_flip``
    the flipped rows of G carry the flipped-label gradient while honest_G
    keeps the recompute; otherwise honest_G is G itself.
    grad_fn(params, batch, out=None) returns the flat gradient, or writes
    it into ``out``: the first row sizes one (n, d) stack, and every later
    row is written straight into it, no row held beside the stack."""

    def grads_fn(params, t, flips):
        row = grad_fn(params, batch_fn(0, t, False))
        G = row.new_empty((n, *row.shape))
        G[0] = row
        del row
        for i in range(1, n):
            grad_fn(params, batch_fn(i, t, False), out=G[i])
        if not label_flip:
            return G, G
        flipped = G.clone()
        for i in torch.nonzero(flips).flatten().tolist():
            grad_fn(params, batch_fn(i, t, True), out=flipped[i])
        return flipped, G

    return grads_fn


def scan_protocol(cfg: EngineConfig, state: ProtocolState, byz_mask, params,
                  grads_fn: Callable, n_steps: int, update_fn=None):
    """Run ``n_steps`` rounds. grads_fn(params, t, flips) -> (G, honest_G);
    update_fn(params, g_hat, t) -> params. Returns (state, params, outs)."""
    outs = []
    for _ in range(n_steps):
        flips = flip_mask(cfg, state, byz_mask)
        G, honest_G = grads_fn(params, state.step, flips)
        state, out = protocol_step(cfg, state, byz_mask, G, honest_G)
        if update_fn is not None:
            params = update_fn(params, out.g_hat, state.step - 1)
        outs.append(out)
    return state, params, outs
