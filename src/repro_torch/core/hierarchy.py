"""Flat-cost verification: sampled-digest audits and the hierarchical
butterfly-of-butterflies.

Counterpart of ``repro.core.hierarchy``. Alg. 6 broadcasts O(n^2) digest
scalars per step; two composable axes shrink them:

* **Sampled-digest audits** (``EngineConfig.audit_k``): the m validators
  jointly audit only ``k_tot = m * audit_k`` digest columns (partitions)
  per step. The set is drawn from the step's key with CHOOSETARGET's age +
  U(0,1) priority rule (:func:`sample_audit_cells`), so it is unpredictable
  before the seed reveal, recomputable by every peer after it, and every
  column's audit age stays below :func:`staleness_bound`. On the card the
  sampled tables are one pass of the k sampled partitions
  (``verification.digest_tables_rows``, kernel ``digest_tables_rows``).
* **Hierarchical butterfly** (``EngineConfig.groups``): n peers split into
  g groups of gs = n/g. Level 1 runs the verifiable spec inside each group
  (:func:`hier_aggregate`: gs x gs tables per group); level 2 combines the
  group aggregates by their active-weight mean and digests each group's
  contribution against it (:func:`level2_combine`), a g x g exchange whose
  zero-sum checksum is exact because the combine is linear.

Both compose: sampling then masks the level-1 tables' columns. The wire
model of the tables is :func:`table_scalars`.

As elsewhere in the port, functions take the stacked gradients ``G (n, d)``
(or their wire values) and return no padded ``parts`` stacks: group a's
peers are the row slice ``G[a*gs:(a+1)*gs]``, a view the kernels read in
place. Where the JAX package vmaps the level-1 aggregation over the groups
(and so never reaches a kernel), this loops over them and runs the spec's
kernel once per group.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import aggregators as agg_mod
from repro_torch.core import butterfly as bf
from repro_torch.core import prng
from repro_torch.core import verification as verif_mod


# ---------------------------------------------------------------------------
# Shapes and the sampling coverage rule
# ---------------------------------------------------------------------------
def group_shape(n: int, groups: int | None) -> tuple[int, int]:
    """(g, gs) for the hierarchical topology; (1, n) when flat."""
    if groups is None or groups <= 1:
        return 1, n
    if n % groups:
        raise ValueError(
            f"groups={groups} must divide the peer count n={n} evenly")
    gs = n // groups
    if gs < 2:
        raise ValueError(
            f"groups={groups} leaves group size {gs} < 2: nothing to "
            "aggregate inside a group")
    return groups, gs


def sampled_k(n_cells: int, m_validators: int, audit_k: int) -> int:
    """Digest columns audited per step: m validators x k columns each,
    capped at the column count."""
    return int(min(max(1, m_validators) * max(1, audit_k), n_cells))


def staleness_bound(n_cells: int, m_validators: int, audit_k: int) -> int:
    """Upper bound on any digest column's audit age under the
    top-k_tot-by-(age + U(0,1)) rule: a column of age a outranks every
    column of age <= a - 2, so by pigeonhole it waits at most
    ceil(n_cells / k_tot) + 2 steps."""
    k_tot = sampled_k(n_cells, m_validators, audit_k)
    return math.ceil(n_cells / k_tot) + 2


def sample_audit_cells(key, step, col_checked, m_validators: int,
                       audit_k: int, n_cells: int):
    """The step's public sampled digest-column set: the top k_tot columns
    by audit age (steps since last sampled, from the ``col_checked``
    ledger) plus U(0,1) jitter from ``key``, ties in index order (the JAX
    package's stable argsort). Returns (idx (k_tot,) int32 column ids,
    mask (n_cells,) bool)."""
    k_tot = sampled_k(n_cells, m_validators, audit_k)
    u = prng.uniform(key, (n_cells,))
    age = (step - col_checked).to(torch.float32)
    order = torch.argsort(-(age + u), stable=True)
    idx = order[:k_tot].to(torch.int32)
    mask = torch.zeros((n_cells,), dtype=torch.bool, device=u.device)
    mask[idx.long()] = True
    return idx, mask


# ---------------------------------------------------------------------------
# The analytic per-peer table wire model
# ---------------------------------------------------------------------------
def table_scalars(n: int, *, m_validators: int = 1,
                  audit_k: int | None = None,
                  groups: int | None = None) -> int:
    """Verification-table scalars received per peer per step: 2 n^2 + 3 n
    for full Alg. 6 tables (n rows x n columns of (s, norm) plus three
    sidecar scalars per owner); sampling shrinks the columns to k_tot, the
    hierarchy the row/column space to the gs-peer group and adds the
    leader's level-2 exchange, 2 g^2 + 3 g."""
    g, gs = group_shape(n, groups)
    k_tot = None if audit_k is None else sampled_k(n, m_validators, audit_k)
    cols = gs if k_tot is None else min(k_tot, gs)
    scalars = 2 * gs * cols + 3 * gs
    if g > 1:
        scalars += 2 * g * g + 3 * g
    return scalars


def table_bytes(n: int, *, m_validators: int = 1, audit_k: int | None = None,
                groups: int | None = None, bytes_per: int = 4) -> int:
    """Per-peer verification-table bytes per step (f32 scalars by default)."""
    return table_scalars(n, m_validators=m_validators, audit_k=audit_k,
                         groups=groups) * bytes_per


# ---------------------------------------------------------------------------
# Two-level aggregation (engine path)
# ---------------------------------------------------------------------------
class HierAggregate(NamedTuple):
    """Level-1 (within-group) aggregation results. The JAX package also
    carries the padded (g, gs, gs, part1) contributions; here they are the
    row slices of the gradients the caller already holds."""

    u: torch.Tensor  # (g, gs, part1) per-group aggregates, butterfly layout
    z1: torch.Tensor  # (gs, part1) level-1 directions (shared by the groups)
    s1: torch.Tensor | None  # (g, gs, gs) level-1 digest tables
    norms1: torch.Tensor | None  # (g, gs, gs)
    group_w: torch.Tensor  # (g,) level-2 combine weights (active mass)
    iters: int  # largest level-1 iteration budget over the groups


class Level2(NamedTuple):
    """Level-2 (leader butterfly) combine and digest exchange. ``u_flat``
    stands in for the JAX package's (g, g, part2) ``parts2``: the group
    aggregates read as g partitions."""

    v2: torch.Tensor  # (g, part2) global aggregate in the leader layout
    u_flat: torch.Tensor  # (g, d) group aggregates, flat
    z2: torch.Tensor  # (g, part2)
    s2: torch.Tensor  # (g, g) level-2 digests
    norms2: torch.Tensor  # (g, g)


def _group_rows(grads, a: int, gs: int):
    """Group a's peers: rows a*gs .. (a+1)*gs of ``grads``, a view."""
    return grads[a * gs:(a + 1) * gs]


def hier_aggregate(spec, grads, weights, seed, groups: int, v0_flat=None,
                   with_tables: bool = True) -> HierAggregate:
    """Level 1: each group of gs peers runs the verifiable spec over its own
    butterfly (gs partitions of the whole d), one
    ``verification.spec_aggregate`` call per group on its row slice.

    grads (n, d); weights (n,), already validator/ban masked; seed the
    step's MPRNG output; v0_flat an optional (d,) warm start shared by
    every group. ``with_tables=False`` skips the digests (the aggregator
    attack recomputes them against the corrupted aggregate through
    :func:`hier_tables`)."""
    spec = agg_mod.resolve_spec(spec)
    n, d = grads.shape
    g, gs = group_shape(n, groups)
    part1 = bf.pad_to_parts(d, gs) // gs
    z1 = bf.get_random_directions(seed, gs, part1)
    v0_1 = None if v0_flat is None else bf.split_parts(v0_flat[None, :],
                                                       gs)[0]
    us, ss, norms, iters = [], [], [], 0
    for a in range(g):
        u_a, s_a, n_a, it = verif_mod.spec_aggregate(
            spec, _group_rows(grads, a, gs), z=z1 if with_tables else None,
            weights=_group_rows(weights, a, gs), v0=v0_1)
        us.append(u_a)
        ss.append(s_a)
        norms.append(n_a)
        iters = max(iters, int(it))
    return HierAggregate(
        u=torch.stack(us), z1=z1,
        s1=torch.stack(ss) if with_tables else None,
        norms1=torch.stack(norms) if with_tables else None,
        group_w=weights.reshape(g, gs).sum(dim=1), iters=iters)


def hier_tables(spec, grads, u, z1):
    """Level-1 tables against GIVEN (possibly corrupted) group aggregates,
    the hierarchical sibling of ``verification.spec_tables``. grads (n, d)
    (the wire values for a compressed spec); u (g, gs, part1). Returns
    (s1, norms1), both (g, gs, gs)."""
    spec = agg_mod.resolve_spec(spec)
    g, gs = u.shape[0], u.shape[1]
    tables = [verif_mod.spec_tables(spec, _group_rows(grads, a, gs), u[a], z1)
              for a in range(g)]
    return (torch.stack([s for s, _ in tables]),
            torch.stack([nm for _, nm in tables]))


def level2_combine(u, group_w, d: int, seed) -> Level2:
    """The leader butterfly: combine the g group aggregates by their
    active-weight mean and digest every group's contribution against it.
    The combine is linear whatever aggregated level 1, so the level-2
    zero-sum checksum holds exactly; z2 comes from ``seed + 1``."""
    g = u.shape[0]
    u_flat = torch.stack([bf.merge_parts(u[a], d) for a in range(g)])
    parts2 = bf.split_parts(u_flat, g)  # (g, g, part2)
    w = torch.clamp(group_w.to(torch.float32), min=0.0)
    v2 = ((parts2 * w[:, None, None]).sum(0)
          / torch.clamp(w.sum(), min=1e-30))
    z2 = bf.get_random_directions(seed + 1, g, parts2.shape[-1])
    s2, norms2 = verif_mod.digest_tables(u_flat, v2, z2)
    return Level2(v2=v2, u_flat=u_flat, z2=z2, s2=s2, norms2=norms2)
