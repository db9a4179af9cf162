"""Sybil-gated admission and the slot lifecycle of elastic membership
(paper §3.3 / App. F).

Counterpart of ``repro.core.sybil``, with its three call surfaces:

* the engine's probation gate (:func:`probation_check`,
  :func:`probation_step`), called from ``core.engine.protocol_step``: a
  joining peer's public-seed work is spot-checked every step and never
  enters the aggregate; one mismatch bans the identity, a clean window of
  ``probation_steps`` checks promotes the slot;
* :class:`HostMembership`, the launch path's ledger (churn events between
  dispatches, probation spot-checks from the probe observations,
  identity-keyed bans) and :func:`parse_churn`; ``launch.train`` keeps
  one next to its weights vector, with or without ``--churn``;
* :class:`SybilGate`, the host simulation of App. F's probation
  economics, with the JAX package's numpy draws in the same order.

    vacant --join--> probation --clean window--> active
       ^                 |                          |
       +------leave------+-------leave--------------+
                         v                          v
                      banned <--accuse/checksum/audit
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Slot lifecycle codes (ProtocolState.lifecycle / HostMembership.lifecycle)
SLOT_VACANT = 0
SLOT_PROBATION = 1
SLOT_ACTIVE = 2
SLOT_BANNED = 3

LIFECYCLE_NAMES = {
    SLOT_VACANT: "vacant",
    SLOT_PROBATION: "probation",
    SLOT_ACTIVE: "active",
    SLOT_BANNED: "banned",
}


# ---------------------------------------------------------------------------
# The engine's probation gate
# ---------------------------------------------------------------------------
def probation_check(G, honest_G, probation_b):
    """Validator spot-check of the probation rows' public-seed work: ``G``
    is what each probation peer broadcast this step, ``honest_G`` what a
    validator recomputing from the same public seed obtains. Commitment
    equality is array equality, so a row that differs in any coordinate
    fails; probation rows never enter the aggregate, so the compare is
    over the raw payload, not the wire projection. Returns (n,) bool: the
    probation rows caught this step."""
    return torch.any(G != honest_G, dim=1) & probation_b


def probation_step(probation_b, mismatch, clean, probation_steps: int):
    """Advance the probation window one step. The clean counter resets on
    a mismatch, adds one on a clean check, and is 0 outside probation.
    Returns (new_clean, promote, sybil_ban): the counter; the probation
    rows whose window of ``probation_steps`` clean checks completed this
    step (active from the next round on); the probation rows banned now
    (one strike)."""
    ok = probation_b & ~mismatch
    new_clean = torch.where(ok, clean + 1, torch.zeros_like(clean))
    promote = ok & (new_clean >= probation_steps)
    sybil_ban = mismatch & probation_b
    return new_clean, promote, sybil_ban


# ---------------------------------------------------------------------------
# Host-side membership ledger (launch path)
# ---------------------------------------------------------------------------
@dataclass
class MembershipEvent:
    step: int
    kind: str  # "join" | "leave"
    slot: int


class HostMembership:
    """The slot lifecycle state machine on the host, for the launch path.

    ``launch.train`` keeps one of these next to its weights vector: events
    from the ``--churn`` schedule toggle slots between scan dispatches, the
    in-program probe observations (``verif["probe_mismatch"]`` — each
    peer's max deviation from its public-seed recompute) drive the
    probation window, and ban observations (checksum / audit offenders)
    feed the identity ledger. Identities are allocated monotonically: a
    slot reclaimed after a leave gets a FRESH identity (the new-key rejoin
    adversary), so the banned set never shrinks — bans survive churn by
    construction.

    The whole state round-trips through :meth:`to_tree` /
    :meth:`restore_tree` for checkpointed recovery (``--checkpoint-dir`` /
    ``--resume``).
    """

    def __init__(self, n_slots: int, probation_steps: int = 3,
                 events: list[MembershipEvent] | None = None,
                 start_vacant: tuple[int, ...] = ()):
        self.n = int(n_slots)
        self.probation_steps = int(probation_steps)
        self.events = sorted(events or [], key=lambda e: e.step)
        self.lifecycle = np.full((self.n,), SLOT_ACTIVE, np.int32)
        self.slot_identity = np.arange(self.n, dtype=np.int32)
        self.clean = np.zeros((self.n,), np.int32)
        for s in start_vacant:
            self.lifecycle[s] = SLOT_VACANT
            self.slot_identity[s] = -1
        self.next_identity = int(self.n)
        self.banned_identities: dict[int, int] = {}  # identity -> ban step
        self.log: list[str] = []

    # -- views ------------------------------------------------------------
    def weights(self) -> np.ndarray:
        return (self.lifecycle == SLOT_ACTIVE).astype(np.float32)

    def probation_mask(self) -> np.ndarray:
        return self.lifecycle == SLOT_PROBATION

    def banned_slots(self) -> list[int]:
        return sorted(np.nonzero(self.lifecycle == SLOT_BANNED)[0].tolist())

    # -- transitions ------------------------------------------------------
    def apply_events(self, step: int):
        """Fire every scheduled join/leave with event.step == step."""
        for ev in self.events:
            if ev.step != step:
                continue
            if ev.kind == "leave":
                if self.lifecycle[ev.slot] == SLOT_VACANT:
                    continue
                self.log.append(
                    f"step {step}: slot {ev.slot} "
                    f"(identity {self.slot_identity[ev.slot]}) left"
                )
                self.lifecycle[ev.slot] = SLOT_VACANT
                self.slot_identity[ev.slot] = -1
                self.clean[ev.slot] = 0
            elif ev.kind == "join":
                if self.lifecycle[ev.slot] != SLOT_VACANT:
                    continue  # join onto an occupied slot is a no-op
                ident = self.next_identity
                self.next_identity += 1
                self.slot_identity[ev.slot] = ident
                self.clean[ev.slot] = 0
                # a fresh identity can never be pre-banned; same-key rejoin
                # (identity reuse) would short-circuit here
                if ident in self.banned_identities:
                    self.lifecycle[ev.slot] = SLOT_BANNED
                else:
                    self.lifecycle[ev.slot] = SLOT_PROBATION
                self.log.append(
                    f"step {step}: identity {ident} joined at slot "
                    f"{ev.slot} (probation)"
                )
            else:
                raise ValueError(f"unknown membership event kind {ev.kind!r}")

    def ban_slots(self, slots, step: int):
        """Ban the current OCCUPANTS of ``slots`` (identity-keyed)."""
        newly = []
        for s in sorted(set(int(x) for x in slots)):
            ident = int(self.slot_identity[s])
            if ident < 0 or self.lifecycle[s] == SLOT_BANNED:
                continue
            self.lifecycle[s] = SLOT_BANNED
            self.banned_identities.setdefault(ident, int(step))
            newly.append((s, ident))
        if newly:
            self.log.append(
                f"step {step}: banned " +
                ", ".join(f"slot {s} (identity {i})" for s, i in newly)
            )
        return [s for s, _ in newly]

    def observe_probe(self, probe_row, step: int, tol: float = 1e-6):
        """One step's probation spot-check results: ``probe_row`` is the
        per-slot max deviation between the broadcast payload and the
        public-seed recompute (exact zero for honest peers). Any excess
        over float tolerance during probation bans the identity; a clean
        window of ``probation_steps`` checks promotes the slot."""
        probe_row = np.asarray(probe_row, np.float64)
        for s in range(self.n):
            if self.lifecycle[s] != SLOT_PROBATION:
                continue
            if probe_row[s] > tol:
                ident = int(self.slot_identity[s])
                self.lifecycle[s] = SLOT_BANNED
                self.banned_identities.setdefault(ident, int(step))
                self.log.append(
                    f"step {step}: probation spot-check failed — banned "
                    f"slot {s} (identity {ident})"
                )
            else:
                self.clean[s] += 1
                if self.clean[s] >= self.probation_steps:
                    self.lifecycle[s] = SLOT_ACTIVE
                    self.log.append(
                        f"step {step}: identity "
                        f"{int(self.slot_identity[s])} admitted at slot {s}"
                    )

    # -- checkpoint round-trip -------------------------------------------
    def to_tree(self) -> dict:
        ids = sorted(self.banned_identities)
        return {
            "lifecycle": self.lifecycle.copy(),
            "slot_identity": self.slot_identity.copy(),
            "clean": self.clean.copy(),
            "next_identity": np.asarray(self.next_identity, np.int32),
            "banned_ids": np.asarray(ids, np.int32),
            "banned_steps": np.asarray(
                [self.banned_identities[i] for i in ids], np.int32
            ),
        }

    def restore_tree(self, tree: dict):
        self.lifecycle = np.asarray(tree["lifecycle"], np.int32).copy()
        self.slot_identity = np.asarray(
            tree["slot_identity"], np.int32
        ).copy()
        self.clean = np.asarray(tree["clean"], np.int32).copy()
        self.next_identity = int(tree["next_identity"])
        self.banned_identities = {
            int(i): int(s)
            for i, s in zip(tree["banned_ids"], tree["banned_steps"])
        }
        return self

    def summary(self) -> dict:
        return {
            "lifecycle": self.lifecycle.tolist(),
            "slot_identity": self.slot_identity.tolist(),
            "weights": self.weights().tolist(),
            "banned_slots": self.banned_slots(),
            "banned_identities": sorted(self.banned_identities),
            "next_identity": self.next_identity,
        }


def parse_churn(spec: str) -> list[MembershipEvent]:
    """Parse ``--churn "leave@6:1,join@8:1"`` into membership events:
    ``KIND@STEP:SLOT`` comma-separated, kind in {join, leave}. A join always
    allocates a FRESH identity for the slot (the new-key rejoin model)."""
    events = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        try:
            kind, rest = item.split("@", 1)
            step, slot = rest.split(":", 1)
        except ValueError:
            raise ValueError(
                f"bad churn event {item!r}: expected KIND@STEP:SLOT"
            ) from None
        if kind not in ("join", "leave"):
            raise ValueError(f"bad churn kind {kind!r} (join|leave)")
        events.append(MembershipEvent(int(step), kind, int(slot)))
    return events


# ---------------------------------------------------------------------------
# App. F probation-economics simulation (host side)
# ---------------------------------------------------------------------------
@dataclass
class JoinRequest:
    peer_id: int
    joined_at: int
    clean_steps: int = 0
    dishonest: bool = False  # simulation: does this identity compute?


class SybilGate:
    """The host simulation of App. F probation: pending identities submit
    gradient commitments, spot-checked with probability ``check_prob``;
    the probabilistic-economics model (expected probation cost ~ honest
    work) beside the engine's every-step gate above. ``grad_fn(pid, t,
    params, flipped)`` gives an identity's honest gradient (anything
    numpy reads); the draws come from ``np.random.default_rng(seed)`` in
    the JAX package's order, so the same seed admits and rejects the same
    identities."""

    def __init__(self, grad_fn, probation_steps: int = 20,
                 check_prob: float = 0.5, seed: int = 0):
        self.grad_fn = grad_fn
        self.probation = probation_steps
        self.check_prob = check_prob
        self.rng = np.random.default_rng(seed)
        self.pending: dict[int, JoinRequest] = {}
        self.admitted: list[int] = []
        self.rejected: list[int] = []

    def request_join(self, peer_id: int, step: int, dishonest: bool = False):
        self.pending[peer_id] = JoinRequest(peer_id, step, dishonest=dishonest)

    def step(self, params, t):
        """One probation round: each pending peer submits a gradient
        commitment; admitted once ``probation`` clean (spot-checked)
        rounds accumulate. Returns (admitted, rejected) so far."""
        done = []
        for pid, req in self.pending.items():
            honest = np.asarray(self.grad_fn(pid, t, params, False),
                                np.float32)
            if req.dishonest:
                # a Sybil identity with no compute behind it sends garbage
                submitted = self.rng.normal(size=honest.shape).astype(
                    np.float32)
            else:
                submitted = honest
            if self.rng.random() < self.check_prob:
                caught = bool(probation_check(
                    torch.from_numpy(submitted)[None],
                    torch.from_numpy(honest)[None],
                    torch.ones((1,), dtype=torch.bool))[0])
                if caught:
                    self.rejected.append(pid)
                    done.append(pid)
                    continue
            req.clean_steps += 1
            if req.clean_steps >= self.probation:
                self.admitted.append(pid)
                done.append(pid)
        for pid in done:
            self.pending.pop(pid, None)
        return list(self.admitted), list(self.rejected)
