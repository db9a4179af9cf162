"""Msgpack tree checkpoints (params, optimizer state, step, metadata).

Counterpart of ``repro.checkpoint.checkpoint``, format version 2, and the
same files: for the same tree both packages write the same bytes, and each
loads the other's. The payload is the map ``{"format_version", "step",
"meta", "arrays"}``; ``arrays`` maps each leaf's path to ``{"dtype",
"shape", "data"}`` (dtype by numpy name, the shape as a list, the raw
little-endian bytes). Paths are the JAX package's: dict keys by name in
sorted order, list and tuple items by index, NamedTuple fields as
``.field``, joined with ``/``; ``None`` holds no leaf.

Dtypes round-trip through their own byte width: bfloat16 as its 16 bits
(an ``int16`` view; no ``ml_dtypes``), int8, uint32 (the JAX package's
PRNG keys), bool. Writes are atomic (``.tmp``, then ``os.replace``) and
stream each array's bytes to the file; a checkpoint of another format
version is refused with a ``ValueError`` that names it; restored arrays are
writable copies.

Leaves are tensors (any device), numpy arrays and Python scalars (which
save as numpy makes them: int64, float64, bool).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_lite

# Bump whenever the on-disk layout changes meaning (the JAX package's own
# generation count: v1 = the unversioned seed format; v2 adds the version
# field and the elastic-membership state in ProtocolState).
FORMAT_VERSION = 2

_TORCH_DTYPES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
}
_BY_NAME = {v: k for k, v in _TORCH_DTYPES.items()}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_paths(tree, prefix=""):
    """``[(path, leaf)]`` in the JAX package's flatten order, paths as its
    checkpoints spell them."""
    def join(key):
        return f"{prefix}/{key}" if prefix else key

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_paths(tree[k], join(str(k)))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in tree_paths(getattr(tree, f), join("." + f))]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in tree_paths(t, join(str(i)))]
    return [(prefix, tree)]


def _to_numpy(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, a C-contiguous host array holding the leaf's bytes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = _TORCH_DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    arr = np.asarray(leaf, order="C")  # 0-d stays 0-d
    return str(arr.dtype), arr


def _entry(leaf) -> dict:
    name, arr = _to_numpy(leaf)
    return {"dtype": name, "shape": list(arr.shape),
            "data": memoryview(arr.reshape(-1).view(np.uint8))}


def save_checkpoint(path: str, tree, step: int = 0, meta: dict | None = None):
    """Write ``tree`` to ``path`` (atomically) with ``step`` and ``meta``."""
    payload = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "meta": meta or {},
        "arrays": {key: _entry(leaf) for key, leaf in tree_paths(tree)},
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        msgpack_lite.dump(payload, f)
    os.replace(tmp, path)


def _decode(key: str, entry: dict) -> torch.Tensor:
    """A stored array as a CPU tensor of its own dtype (a writable copy)."""
    name = entry["dtype"]
    if name not in _BY_NAME:
        raise ValueError(f"checkpoint array {key!r} has dtype {name!r}, "
                         "which this package does not read")
    np_dtype = np.int16 if name == "bfloat16" else np.dtype(name)
    arr = np.frombuffer(entry["data"], dtype=np_dtype)
    t = torch.from_numpy(arr.reshape(entry["shape"]).copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _restore(stored: torch.Tensor, leaf):
    """``stored`` in ``leaf``'s place: its shape, on its device, cast to
    its dtype only where the dtypes differ (a value restore, not a bit
    restore). A tensor leaf gives a tensor, any other a numpy array."""
    if isinstance(leaf, torch.Tensor):
        out = stored if stored.dtype == leaf.dtype else stored.to(leaf.dtype)
        return out.reshape(leaf.shape).to(leaf.device)
    want = np.asarray(leaf).dtype
    if stored.dtype == torch.bfloat16:
        stored = stored.to(torch.float32)
    arr = stored.numpy()
    if arr.dtype != want:
        arr = arr.astype(want)
    return arr.reshape(np.shape(leaf))


def _rebuild(example, leaves):
    """``example``'s structure around ``leaves`` (in :func:`tree_paths`
    order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(example)


def load_checkpoint(path: str, example_tree=None):
    """Returns ``(tree, step, meta)``. With ``example_tree`` the stored
    arrays are put back into its structure (see :func:`_restore`); without
    it, a flat ``{path: tensor}`` dict on the CPU is returned. Raises
    ``ValueError`` on a checkpoint of another format version and
    ``KeyError`` naming an array the example has and the file lacks."""
    with open(path, "rb") as f:
        payload = msgpack_lite.unpackb(f.read())
    version = payload.get("format_version", 1)
    if version != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format_version={version}, this build "
            f"reads format_version={FORMAT_VERSION}: the saved tree layout "
            "is incompatible; re-save from a matching build instead of "
            "restoring it here")
    entries = payload["arrays"]
    if example_tree is None:
        arrays = {k: _decode(k, v) for k, v in entries.items()}
        return arrays, payload["step"], payload["meta"]
    leaves = []
    for key, leaf in tree_paths(example_tree):
        if key not in entries:
            raise KeyError(f"checkpoint missing array {key!r}")
        leaves.append(_restore(_decode(key, entries[key]), leaf))
    return (_rebuild(example_tree, leaves), payload["step"],
            payload["meta"])
