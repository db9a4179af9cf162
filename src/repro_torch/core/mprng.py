"""Multi-party random number generator (paper App. A.2, Blum 1983).

Commit–reveal over a simulated broadcast channel:
  1. each peer draws k random bits x_i and salt s_i,
  2. broadcasts commitment h(i || x_i || s_i)          (sha256),
  3. after ALL commitments arrive, broadcasts (x_i, s_i),
  4. everyone verifies reveals against commitments,
  5. output = XOR of all x_i.

A peer that aborts or reveals a mismatch is banned and the protocol restarts
without it — eliminating the 'learn-early-and-abort' bias (App. A.2, last
paragraph). Communication: O(1) scalars per peer per round, i.e. O(n) data —
independent of the model size d.

Counterpart of ``repro.core.mprng``: the same pure-Python module, kept in
the port because importing that one imports jax through ``repro.core``.
The engine models its outcome (``engine.phase_mprng``); this is the
transcript itself.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass


def _h(i: int, x: int, salt: bytes) -> bytes:
    return hashlib.sha256(f"{i}|{x}|".encode() + salt).digest()


@dataclass
class MPRNGPeer:
    """Honest behaviour; subclass hooks model Byzantine deviations."""

    peer_id: int
    bits: int = 63

    def draw(self, rng):
        self._x = int(rng.integers(0, 2**self.bits))
        self._salt = rng.bytes(32)

    def commit(self) -> bytes:
        return _h(self.peer_id, self._x, self._salt)

    def reveal(self, seen_reveals):
        """seen_reveals: reveals broadcast so far (rushing adversary sees
        them). Honest peers ignore them. Return None to abort."""
        return (self._x, self._salt)


@dataclass
class AbortingPeer(MPRNGPeer):
    """Byzantine: learns the XOR of everyone else first (rushing), aborts if
    the resulting output is not to its liking (here: if output would be odd).
    The protocol response is ban + restart, killing the bias."""

    def reveal(self, seen_reveals):
        others = 0
        for x, _ in seen_reveals.values():
            others ^= x
        candidate = others ^ self._x
        if candidate % 2 == 1:
            return None  # abort to force a re-roll
        return (self._x, self._salt)


@dataclass
class LyingPeer(MPRNGPeer):
    """Byzantine: reveals a different x than committed."""

    def reveal(self, seen_reveals):
        return (self._x ^ 1, self._salt)


def run_mprng(peers, rng, max_rounds: int = 10):
    """Returns (value, banned_ids, rounds). Peers are banned on abort or
    commitment mismatch; protocol restarts without them."""
    active = list(peers)
    banned = []
    for rnd in range(max_rounds):
        for p in active:
            p.draw(rng)
        commitments = {p.peer_id: p.commit() for p in active}
        reveals = {}
        bad = []
        # rushing order: byzantine peers reveal LAST and see honest reveals
        ordered = sorted(active, key=lambda p: isinstance(p, (AbortingPeer, LyingPeer)))
        for p in ordered:
            r = p.reveal(dict(reveals))
            if r is None:
                bad.append(p.peer_id)
                continue
            x, salt = r
            if _h(p.peer_id, x, salt) != commitments[p.peer_id]:
                bad.append(p.peer_id)
                continue
            reveals[p.peer_id] = (x, salt)
        if bad:
            banned.extend(bad)
            active = [p for p in active if p.peer_id not in bad]
            continue  # restart without the banned peers
        out = 0
        for x, _ in reveals.values():
            out ^= x
        return out, banned, rnd + 1
    raise RuntimeError("MPRNG failed to converge (too many byzantine aborts)")
