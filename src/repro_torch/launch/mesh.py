"""The launch path's mesh: ``--mesh DATAxMODEL`` as a group of peer ranks.

Counterpart of ``repro.launch.mesh``. The JAX package lays the peers out
on a ``("data", "model")`` (or ``("pod", "data", "model")``) device mesh;
the port has no tensor parallelism yet, so a mesh here is DATA peer ranks
with MODEL = 1, each rank a full replica (``launch.collectives``).
"""
from __future__ import annotations

from typing import NamedTuple

NOT_PORTED = ("ROADMAP queue 1 item 14 (its remainder: the model axis, "
              "the pod axis and sequence parallelism, with "
              "sharding/specs.py)")


class PeerMesh(NamedTuple):
    n_data: int
    n_model: int = 1

    @property
    def n_peers(self) -> int:
        return self.n_data

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape`` prints them."""
        return {"data": self.n_data, "model": self.n_model}


def parse_mesh(text: str) -> PeerMesh:
    """``DATAxMODEL`` -> :class:`PeerMesh`. Raises NotImplementedError for
    MODEL > 1 and for a ``PODxDATAxMODEL`` mesh (not ported yet)."""
    try:
        dims = [int(x) for x in text.lower().split("x")]
    except ValueError:
        raise ValueError(f"bad --mesh {text!r}: expected DATAxMODEL") \
            from None
    if len(dims) == 3:
        raise NotImplementedError(
            f"--mesh {text}: a pod axis is not ported yet; {NOT_PORTED}")
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"bad --mesh {text!r}: expected DATAxMODEL")
    if dims[1] != 1:
        raise NotImplementedError(
            f"--mesh {text}: a model axis > 1 (tensor parallelism) is not "
            f"ported yet; {NOT_PORTED}")
    return PeerMesh(dims[0], 1)
