"""The collectives of the launch path's peer axis.

The JAX package runs its distributed step under ``shard_map`` over a
``"peers"`` mesh axis and gets its collectives from ``jax.lax``:
``axis_index``, tiled ``all_to_all`` and ``all_gather`` (with
``axis_index_groups``), ``psum`` (with groups) and ``pmax``. Here the peer
axis is a :class:`PeerGroup` of ranks, with the same collectives as
methods. Every rank runs the same program (SPMD), and a collective returns
to each rank what ``jax.lax`` returns to that peer:

* ``all_to_all(x, groups)``: ``x`` is cut along dim 0 into one chunk per
  member of the rank's group; member j receives chunk j; the result is the
  chunks received, in member order (``tiled=True``, split and concat on
  axis 0);
* ``all_gather(x, groups, tiled)``: every member's ``x``, stacked along a
  new dim 0 (or concatenated along dim 0 when ``tiled``);
* ``psum(x, groups)``: the sum over the members, added in member order;
* ``pmax(x)``: the elementwise max over all ranks.

``groups`` is a partition of the ranks into lists (``axis_index_groups``);
None is one group of all ranks.

Two implementations:

* :class:`LocalGroup` runs n ranks as threads of one process, on one
  device (:func:`run_local`). This is how one GPU holds a peer group:
  NCCL refuses two ranks on one device. Every collective is a rendezvous
  on a ``threading.Barrier`` with a timeout, so a rank that fails or never
  arrives raises ``BrokenBarrierError`` in every other rank instead of
  hanging them. The ranks share the device's default stream, so a tensor
  enqueued by one rank before the rendezvous is complete for a kernel that
  another rank enqueues after it, and no collective synchronises the host
  with the device.
* :class:`DistGroup` is the same interface over ``torch.distributed``
  (``all_to_all_single``, ``all_gather_into_tensor``, ``all_reduce``, and
  ``new_subgroups_by_enumeration`` for the index groups): NCCL at one rank
  per GPU, or gloo on the CPU. The caller initialises the process group
  (:func:`init_dist`), with its address, world size and rank.
"""
from __future__ import annotations

import threading
from datetime import timedelta

import torch


def _members(rank: int, n: int, groups) -> list[int]:
    """The members of ``rank``'s group (all ranks when ``groups`` is None),
    after checking that ``groups`` partitions range(n) into equal sizes."""
    if groups is None:
        return list(range(n))
    flat = sorted(r for g in groups for r in g)
    if flat != list(range(n)) or len({len(g) for g in groups}) != 1:
        raise ValueError(f"groups {groups} do not partition {n} ranks into "
                         "groups of one size")
    for g in groups:
        if rank in g:
            return list(g)
    raise AssertionError("unreachable")


class PeerGroup:
    """The peer axis as seen from one rank: ``n`` ranks, this one
    ``rank``. Subclasses implement the collectives."""

    n: int
    rank: int

    def axis_index(self) -> int:
        return self.rank

    def all_to_all(self, x, groups=None):
        raise NotImplementedError

    def all_gather(self, x, groups=None, tiled=False):
        raise NotImplementedError

    def psum(self, x, groups=None):
        raise NotImplementedError

    def pmax(self, x):
        raise NotImplementedError

    def barrier(self):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Ranks as threads of one process
# ---------------------------------------------------------------------------
class _LocalWorld:
    """State shared by the ranks of one :func:`run_local` call: one slot
    per rank for the value it contributes to the current collective."""

    def __init__(self, n: int, timeout: float):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n


class LocalGroup(PeerGroup):
    """One rank of a group of threads (made by :func:`run_local`)."""

    def __init__(self, world: _LocalWorld, rank: int):
        self.world, self.n, self.rank = world, world.n, rank

    def _exchange(self, value, combine):
        """Post ``value``, wait for every rank, compute this rank's result
        from all posted values with ``combine(slots)``, and wait again, so
        no rank posts its next value (or changes this one in place) while
        another still reads."""
        w = self.world
        w.slots[self.rank] = value
        w.barrier.wait()
        try:
            out = combine(w.slots)
        except BaseException:
            w.barrier.abort()
            raise
        w.barrier.wait()
        return out

    def all_to_all(self, x, groups=None):
        members = _members(self.rank, self.n, groups)
        me = members.index(self.rank)
        k = len(members)
        if x.shape[0] % k:
            raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) is not a "
                             f"multiple of the group size {k}")
        c = x.shape[0] // k
        return self._exchange(x, lambda s: torch.cat(
            [s[m][me * c:(me + 1) * c] for m in members]))

    def all_gather(self, x, groups=None, tiled=False):
        members = _members(self.rank, self.n, groups)
        join = torch.cat if tiled else torch.stack
        return self._exchange(x, lambda s: join([s[m] for m in members]))

    def psum(self, x, groups=None):
        members = _members(self.rank, self.n, groups)

        def add(s):
            out = s[members[0]].clone()
            for m in members[1:]:
                out = out + s[m]
            return out

        return self._exchange(x, add)

    def pmax(self, x):
        return self._exchange(x, lambda s: torch.stack(list(s)).amax(0))

    def barrier(self):
        self._exchange(None, lambda s: None)


def run_local(n: int, fn, *, device=None, timeout: float = 300.0,
              cpu_threads: int | None = 1):
    """Run ``fn(group)`` on ``n`` ranks, each a thread holding its
    :class:`LocalGroup`, and return the ranks' results in rank order.

    ``timeout`` bounds every rendezvous in seconds. An exception in any
    rank aborts the rendezvous, so the others stop at their next
    collective; every thread is joined, and then the first rank's own
    error is raised again (a ``BrokenBarrierError`` only when no rank
    failed otherwise, i.e. a rank timed out). On the CPU each rank bounds
    torch's intra-op threads to ``cpu_threads`` (None leaves them), so n
    ranks do not oversubscribe the cores; on a CUDA device each rank
    selects it."""
    world = _LocalWorld(n, timeout)
    results, errors = [None] * n, [None] * n
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda" and device.index is None:
        # the caller's current card; set_device wants an index
        device = torch.device("cuda", torch.cuda.current_device())

    def target(rank):
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            elif cpu_threads is not None:
                torch.set_num_threads(cpu_threads)
            results[rank] = fn(LocalGroup(world, rank))
        except BaseException as err:  # noqa: BLE001 - re-raised below
            errors[rank] = err
            world.barrier.abort()

    threads = [threading.Thread(target=target, args=(r,), name=f"rank{r}",
                                daemon=True) for r in range(n)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            if t.ident is not None:
                t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        own = [e for e in failed
               if not isinstance(e, threading.BrokenBarrierError)]
        raise (own or failed)[0]
    return results


# ---------------------------------------------------------------------------
# Ranks as processes: torch.distributed
# ---------------------------------------------------------------------------
def init_dist(init_method: str, world_size: int, rank: int, *,
              device=None, timeout: float = 300.0):
    """Initialise the default process group: NCCL for a CUDA device (one
    rank per GPU: ``device``'s card, or card ``rank`` mod the card count
    when it has no index), gloo for the CPU. ``device`` defaults to the
    card (``resolve_device``: raises without one; pass ``"cpu"`` for
    gloo). ``init_method`` is a ``tcp://host:port`` or ``file://path``
    rendezvous. Returns a :class:`DistGroup`."""
    import torch.distributed as dist

    from repro_torch import resolve_device

    device = resolve_device(device)
    backend = "gloo"
    if device.type == "cuda":
        backend = "nccl"
        # NCCL's communicators (and its barrier) use the current card
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return DistGroup()


class DistGroup(PeerGroup):
    """This process's rank of the default ``torch.distributed`` group."""

    def __init__(self):
        import torch.distributed as dist

        self._dist = dist
        self.n, self.rank = dist.get_world_size(), dist.get_rank()
        self._subgroups = {}

    def _group(self, groups):
        """(process group or None, members) of this rank's index group.
        Every rank creates the same subgroups in the same order."""
        members = _members(self.rank, self.n, groups)
        if groups is None:
            return None, members
        key = tuple(tuple(g) for g in groups)
        if key not in self._subgroups:
            pg, _ = self._dist.new_subgroups_by_enumeration(
                [list(g) for g in groups])
            self._subgroups[key] = pg
        return self._subgroups[key], members

    def all_to_all(self, x, groups=None):
        pg, members = self._group(groups)
        if x.shape[0] % len(members):
            raise ValueError(f"all_to_all: dim 0 ({x.shape[0]}) is not a "
                             f"multiple of the group size {len(members)}")
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x.contiguous(), group=pg)
        return out

    def all_gather(self, x, groups=None, tiled=False):
        pg, members = self._group(groups)
        shape = tuple(x.shape)
        # the concatenated output form, the one every backend takes; newer
        # torch names the call all_gather_single
        gather = (getattr(self._dist, "all_gather_single", None)
                  or self._dist.all_gather_into_tensor)
        out = torch.empty((len(members),) + shape, dtype=x.dtype,
                          device=x.device)
        gather(out, x.reshape((1,) + shape).contiguous(), group=pg)
        return out.reshape((-1,) + shape[1:]) if tiled else out

    def psum(self, x, groups=None):
        pg, _ = self._group(groups)
        out = x.clone()
        self._dist.all_reduce(out, self._dist.ReduceOp.SUM, group=pg)
        return out

    def pmax(self, x):
        out = x.clone()
        self._dist.all_reduce(out, self._dist.ReduceOp.MAX)
        return out

    def barrier(self):
        self._dist.barrier()
