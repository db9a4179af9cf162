"""The ravel boundary: parameter/gradient trees <-> one flat float32 vector.

Counterpart of ``repro.core.flatten``. Everything in the BTARD engine works
on the ``(n, d)`` float32 contract; models live on the other side as nested
dicts (and lists) of bf16/f32 tensors. The flat layout is the JAX
package's leaf order — dict keys sorted, lists in order — so a flat vector
means the same thing in both packages.

* ``flatten``  : tree -> (d,) f32, leaves widened (bf16 -> f32 is exact).
* ``unflatten``: (d,) f32 -> tree with the template's shapes and dtypes
  (f32 -> bf16 rounds to nearest even, as jax's ``astype``).
"""
from __future__ import annotations

import torch


def tree_leaves(tree):
    """Leaves of a nested dict/list tree in the JAX package's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves):
    """Rebuild ``template``'s structure from leaves in ``tree_leaves`` order.

    A module-level recursion: a nested function that calls itself would
    hold its own closure cell, a reference cycle through the leaves, so
    every call's leaves (a model's weights, once a gradient) would outlive
    it until the cyclic collector ran."""
    return _build(template, iter(leaves))


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


class FlatBoundary:
    """Bidirectional tree <-> (d,) f32 map fixed by a template tree."""

    def __init__(self, template):
        leaves = tree_leaves(template)
        # the structure alone: holding the template's tensors would keep
        # the initial weights alive beside the flat vector
        self.template = tree_unflatten(template, [None] * len(leaves))
        self.shapes = tuple(tuple(t.shape) for t in leaves)
        self.dtypes = tuple(t.dtype for t in leaves)
        for dt, shape in zip(self.dtypes, self.shapes):
            if not dt.is_floating_point:
                raise TypeError(
                    f"FlatBoundary: non-float leaf {dt} {shape} cannot cross "
                    "the f32 ravel boundary bitwise")
        sizes = [int(torch.Size(s).numel()) for s in self.shapes]
        offsets = [0]
        for s in sizes:
            offsets.append(offsets[-1] + s)
        self.offsets = tuple(offsets)
        self.d = self.offsets[-1]

    def flatten(self, tree):
        """tree (the template's structure) -> (d,) f32."""
        return self.flatten_leaves(tree_leaves(tree))

    def flatten_leaves(self, leaves, out=None):
        """Leaves -> (d,) f32; into ``out`` (a (d,) f32 tensor, e.g. a row
        of the peers' stack) leaf by leaf when given, with no f32 copy of
        the leaves on the way."""
        if out is None:
            return torch.cat([t.reshape(-1).to(torch.float32)
                              for t in leaves])
        for i, t in enumerate(leaves):
            out[self.offsets[i]:self.offsets[i + 1]].copy_(t.reshape(-1))
        return out

    def unflatten_leaves(self, flat):
        """(d,) f32 -> leaves with the template's shapes and dtypes."""
        return [
            flat[self.offsets[i]:self.offsets[i + 1]]
            .reshape(self.shapes[i]).to(self.dtypes[i])
            for i in range(len(self.shapes))
        ]

    def unflatten(self, flat):
        """(d,) f32 -> tree with the template's shapes and dtypes."""
        return tree_unflatten(self.template, self.unflatten_leaves(flat))
