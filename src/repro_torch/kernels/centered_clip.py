"""Python wrappers of the CUDA CenteredClip and digest kernels
(``csrc/centered_clip.cu``, ``csrc/wire.cu``).

Each wrapper takes the peer stack as an ``(n, d)`` matrix plus a partition
count: partition p of peer i is ``x[i, p*part:(p+1)*part]`` with
``part = ceil(d / n_parts)``, the butterfly layout (``stacked`` below,
and the JAX package's ``split_parts``) read in place: the ragged tail reads
as zero. The matrix is the float32 gradient stack, or for the ``*_dequant``
wrappers the int8/bf16 wire payloads of ``core.compression`` with their
(n_parts, n) f32 scales. A CUDA tensor goes to the kernel; a CPU tensor
goes to the plain version in ``kernels/ref.py``, which is also exported
(``*_plain``) so the kernels can be held against it on the card. Nothing
falls back: a failed build or launch raises.

Counterparts of ``repro.kernels.centered_clip`` (Pallas, TPU):

================================  =========================================
wrapper                           replaces
================================  =========================================
``butterfly_clip_fused``          ``butterfly_clip_fused_pallas``
``verify_tables_batched``         ``verify_tables_batched_pallas``
``butterfly_clip_adaptive``       ``adaptive_clip_step_pallas`` under the
                                  ``butterfly_clip_adaptive_pallas`` loop
``butterfly_clip``                ``butterfly_clip_pallas``
``mean_digest_fused``             ``mean_digest_fused_pallas``
``digest_tables_batched``         ``digest_tables_batched_pallas``
``butterfly_clip_fused_dequant``  ``butterfly_clip_fused_dequant_pallas``
``mean_digest_fused_dequant``     ``mean_digest_fused_dequant_pallas``
``digest_tables_rows``            ``digest_tables_rows_pallas``
``centered_clip_fused``           ``centered_clip_fused_pallas``
``verify_tables``                 ``verify_tables_pallas``
``centered_clip``                 ``centered_clip_pallas``
================================  =========================================

The last three are single-partition kernels: one owner's received
``(n, part)`` stack on the launch path, and ``core.centered_clip``'s
``(n, d)`` stack (float32 or bfloat16). They run the passes of the
batched kernels (#1, #2 and #4) at ``n_parts = 1`` (the stack is then the
matrix itself), under their own wrappers, launch counts and plain versions.

Any peer count n >= 1 is taken: above 32 peers the passes walk the peers
in tiles of 32 (``csrc/centered_clip.cuh``, "Peer tiles").

Every pass sums over ``chunk_grid(n, d, n_parts)``: chunks of CHUNK
columns, a constant, so the reduction order and every bit follow from
(n, d, n_parts) and not from the card the kernels run on (the two-phase
clip's passes over ``clip_grid``, the same chunks with groups of 4 up to
32 peers). A pass loads 4 columns of a peer at once (16 bytes of float32)
where every row start of the stack and of the float32 vectors is aligned,
and column by column, in the same order, where not: the same stack gives
the same bits at any storage offset or row stride. Up to 32 peers the
two-phase clip copies its rows into shared memory first where every row
start is 16-byte aligned; so do every norm, update and dot pass and
verified:mean's one pass (#5, #8) up to 8 peers. The fixed budgets (#1,
#4, #7, #10, #12) and the adaptive loop (#3) read v0 in place and have
their first update write v.

``LAUNCHES`` counts kernel launches on the card: one per wrapper call, and
for the adaptive loop one per step it enqueues (its step kernel: every
iteration in which some partition stepped, and the frozen no-ops enqueued
before the host saw the last partition converge). The
launch path runs its peer ranks as threads of one process, so every count
goes through ``_count``, which holds a lock.
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

LAUNCHES = {
    "butterfly_clip_fused": 0,
    "verify_tables_batched": 0,
    "adaptive_clip_step": 0,
    "butterfly_clip": 0,
    "mean_digest_fused": 0,
    "digest_tables_batched": 0,
    "butterfly_clip_fused_dequant": 0,
    "mean_digest_fused_dequant": 0,
    "digest_tables_rows": 0,
    "centered_clip_fused": 0,
    "verify_tables": 0,
    "centered_clip": 0,
}
_COUNT_LOCK = threading.Lock()
# element type of a wire payload -> the kernels' dtype code (csrc/wire.cu)
WIRE_DTYPES = {torch.int8: 1, torch.bfloat16: 2}
# peers a register tile holds (csrc: cc::kTile); above it the update that
# carries the next norms needs a (P, part) scratch vector
TILE = 32
# columns a thread takes at a time up to 8 peers, one 16-byte load of
# float32 per peer where the stack allows it (csrc: cc::group_cols); 1
# above 8 peers. The two-phase clip's passes take groups of 4 up to TILE
# peers (``clip_grid``).
GROUP = 4
# columns of a logical chunk, each the source of one (n,) row of partial
# sums: a constant, not derived from the card's SM count, so the reduction
# order (and hence every bit) is the same on any card. A multiple of GROUP.
CHUNK = 4096
# a pass's `vec` (csrc): 0 column by column, 1 the 16-byte loads, STAGED the
# staged body of the norm, update and dot passes (rows copied into shared
# memory, up to 8 peers)
STAGED = 2
# slots of the adaptive loop's pinned ring of d2 readings (#3): iteration j
# lands in slot j % slots, which the host reads only before it enqueues
# iteration j + slots (the next write to that slot)
ADAPTIVE_RING = 32
# rings of d2 readings whose last finish may still be queued on the card,
# each with the iteration of that finish: a ring's pinned block goes back
# to torch's host cache only once that finish has landed (``_hold_ring``)
_HELD_RINGS: list = []
_HELD_LOCK = threading.Lock()


class Geometry(NamedTuple):
    """The logical chunk grid of a pass: partition p of length ``part`` is
    cut into C chunks of ``cs`` columns, [c*cs, min(part, (c+1)*cs)), and a
    thread sums ``group`` consecutive columns at a time."""

    part: int
    cs: int
    C: int
    group: int


def chunk_grid(n: int, d: int, n_parts: int) -> Geometry:
    """The chunk grid of every pass over an (n, d) stack read as n_parts
    partitions: a function of (n, d, n_parts) alone. The kernels sum each
    chunk in a fixed order and the finish sums the C chunk partials in a
    fixed tree, so the bits follow from this grid; the number of CTAs that
    walk it (the card's SM count times the resident CTAs) does not enter."""
    part = part_len(d, n_parts)
    return Geometry(part, CHUNK, -(-part // CHUNK), GROUP if n <= 8 else 1)


def clip_grid(n: int, d: int, n_parts: int) -> Geometry:
    """The chunk grid of the two-phase clip's passes (#4, #12): that of
    ``chunk_grid``, with groups of 4 columns up to TILE peers (thread t
    takes columns 4t .. 4t + 3 of each 1024-column sub-tile of its chunk)
    and of one above (the peer-tiled passes)."""
    return chunk_grid(n, d, n_parts)._replace(
        group=GROUP if n <= TILE else 1)


def reset_launch_counts():
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str, times: int = 1):
    """``times`` more launches of kernel ``name`` (safe under concurrent
    ranks)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += times


def part_len(d: int, n_parts: int) -> int:
    return -(-d // n_parts)


def stacked(grads, n_parts):
    """(n, d) -> the (n_parts, n, part) stack, zero-padded: the plain
    versions' input layout (a view, or a padded copy when d is ragged; the
    kernels read ``grads`` in place). Any dtype: wire payloads pad with
    wire zeros."""
    n, d = grads.shape
    part = part_len(d, n_parts)
    if n_parts * part != d:
        grads = F.pad(grads, (0, n_parts * part - d))
    return grads.reshape(n, n_parts, part).transpose(0, 1)


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------
def butterfly_clip_fused_plain(grads, n_parts, taus, z, tau_v=None,
                               weights=None, v0=None):
    return ref.centered_clip_fused_ref(stacked(grads, n_parts), taus, z,
                                       tau_v=tau_v, weights=weights, v0=v0)


def verify_tables_batched_plain(grads, n_parts, agg, z, tau):
    return ref.verify_tables_ref(stacked(grads, n_parts), agg, z, tau)


def butterfly_clip_plain(grads, n_parts, taus, weights=None, v0=None):
    return ref.centered_clip_ref(stacked(grads, n_parts), taus, weights, v0)


def digest_tables_batched_plain(grads, n_parts, agg, z):
    return ref.digest_tables_ref(stacked(grads, n_parts), agg, z)


def digest_tables_rows_plain(grads, n_parts, agg, z, rows, tau):
    return ref.digest_tables_rows_ref(stacked(grads, n_parts), agg, z,
                                      _rows(rows, n_parts, grads.device),
                                      tau)


def mean_digest_fused_plain(grads, n_parts, z, weights=None):
    return ref.mean_digest_fused_ref(stacked(grads, n_parts), z, weights)


def butterfly_clip_fused_dequant_plain(qs, scales, n_parts, taus, z,
                                       tau_v=None, weights=None, v0=None):
    return ref.centered_clip_fused_dequant_ref(
        stacked(qs, n_parts), scales, taus, z, tau_v=tau_v, weights=weights,
        v0=v0)


def mean_digest_fused_dequant_plain(qs, scales, n_parts, z, weights=None):
    return ref.mean_digest_fused_dequant_ref(stacked(qs, n_parts), scales, z,
                                             weights)


def centered_clip_fused_plain(xs, taus, z, tau_v=None, weights=None,
                              v0=None):
    v, s, norms = ref.centered_clip_fused_ref(
        xs[None], taus, z[None], tau_v=tau_v, weights=weights,
        v0=None if v0 is None else v0[None])
    return v[0], s[0], norms[0]


def verify_tables_plain(xs, v, z, tau):
    s, norms = ref.verify_tables_ref(xs[None], v[None], z[None], tau)
    return s[0], norms[0]


def centered_clip_plain(xs, taus, weights=None, v0=None):
    return ref.centered_clip_ref(xs[None], taus, weights,
                                 None if v0 is None else v0[None])[0]


def butterfly_clip_adaptive_plain(grads, n_parts, tau, tol, max_iters,
                                  weights=None, v0=None):
    """The early-exit loop over ``adaptive_step_ref``: converged
    partitions freeze by select; stops when every partition's last update
    has ||dv|| <= tol, or after ``max_iters``. Returns (agg, iters (P,))."""
    xs = stacked(grads, n_parts)
    v = (torch.zeros((n_parts, xs.shape[-1]), dtype=torch.float32,
                     device=xs.device)
         if v0 is None else v0.to(torch.float32))

    def step(v, sq):
        v_new, sq_new = ref.adaptive_step_ref(xs, v, sq, tau, weights)
        return v_new, ((v_new - v) ** 2).sum(-1), sq_new

    return ref.freeze_by_select(step, v, ref.sq_norms(xs, v), tol,
                                max_iters)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------
def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


class _Stack:
    """Validated kernel arguments for the (n, d) stack read as n_parts
    partitions, plus the pass geometry (``chunk_grid``: chunk length cs, C
    chunks a partition). A float32 stack runs the passes of
    ``csrc/centered_clip.cu``; an int8/bf16 wire stack, with its
    (n_parts, n) f32 ``scales``, those of ``csrc/wire.cu``. The finishing
    kernels read only partial sums, (rows, n, C), and are the float32
    library's either way."""

    @staticmethod
    def check(grads, scales=None):
        """Raise ValueError for a stack the kernels do not take: not 2-D,
        not float32 (or int8/bf16 with scales), a column stride other than
        1, or no peer. Any peer count n >= 1 is taken."""
        wire = WIRE_DTYPES.get(grads.dtype)
        if grads.dim() != 2 or (wire is None) != (grads.dtype == torch.float32):
            raise ValueError(f"the stack must be (n, d) float32, int8 or "
                             f"bfloat16, got {tuple(grads.shape)} "
                             f"{grads.dtype}")
        if (wire is None) != (scales is None):
            raise ValueError("scales go with an int8/bf16 wire stack and "
                             "only with one")
        if grads.stride(1) != 1:
            raise ValueError("the stack must have unit column stride")
        if grads.shape[0] < 1:
            raise ValueError("the stack needs at least one peer")
        return wire

    def __init__(self, grads, n_parts, scales=None):
        from repro_torch.kernels import build

        wire = self.check(grads, scales)
        self.n, self.d = grads.shape
        self.P = int(n_parts)
        self._scratch = None
        self.part, self.cs, self.C, group = chunk_grid(self.n, self.d, self.P)
        self.device = grads.device
        self.grads = grads
        ld, es = grads.stride(0), grads.element_size()

        def rows_aligned(nbytes):
            return (ld * es % nbytes == 0 and self.part * es % nbytes == 0
                    and grads.data_ptr() % nbytes == 0)

        # 16-byte loads: every (peer, partition) row start aligned to a
        # group of 4 elements (16 bytes of float32, 4 of int8, 8 of bf16)
        self.vec = group == GROUP and rows_aligned(GROUP * es)
        # the two-phase clip up to TILE peers copies whole 16-byte units of
        # its rows into shared memory: every row start on 16 bytes
        self.clip_vec = self.n <= TILE and rows_aligned(16)
        # so does the staged body of every norm, update and dot pass and of
        # verified:mean's pass, with groups of 4 (up to 8 peers)
        self.stage = group == GROUP and rows_aligned(16)
        self.lib = build.load("centered_clip")
        self.stream = _stream(self.device)
        stack = (ld, self.part, self.d, self.n, self.P, self.cs, self.C)
        if wire is None:
            self.passes, self.prefix = self.lib, "cc_"
            self.args = (grads.data_ptr(), *stack)
        else:
            self.scales = self.f32(scales, (self.P, self.n), "scales")
            self.passes, self.prefix = build.load("wire"), "wire_"
            self.args = (wire, grads.data_ptr(), self.scales.data_ptr(),
                         *stack)

    @property
    def body(self):
        """The ``vec`` of the norm, update and dot passes and of
        verified:mean's pass."""
        return STAGED if self.stage else int(self.vec)

    def _call(self, what, fn, *args):
        _check(fn(*args, self.stream), what)

    def _pass(self, name, vectors, *args, vec=None):
        """Launch pass ``name`` with the body the stack allows (``vec``, by
        default ``self.vec``: 16-byte loads; STAGED the staged body), or
        column by column where a float32 vector it reads or writes
        (``vectors``; None for a zero vector that is not read) does not
        start 16-byte aligned."""
        aligned = all(t is None or t.data_ptr() % 16 == 0 for t in vectors)
        mode = int(self.vec if vec is None else vec) if aligned else 0
        self._call(f"{name} ({self.prefix})",
                   getattr(self.passes, self.prefix + name), *self.args,
                   mode, *args)

    def f32(self, t, shape, name):
        t = t.to(device=self.device, dtype=torch.float32).contiguous()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        return t

    def empty(self, *shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.device)

    def partials(self, rows=None):
        """A (rows, n, C) buffer of per-chunk partial sums (rows = P)."""
        return self.empty(self.P if rows is None else rows, self.n, self.C)

    def weights(self, weights):
        if weights is None:
            return torch.ones((self.n,), dtype=torch.float32,
                              device=self.device)
        return self.f32(weights, (self.n,), "weights")

    def vector(self, v, name="v0"):
        """None, or ``v`` checked as a (P, part) float32 vector, read in
        place (the passes that take it do not write it)."""
        return None if v is None else self.f32(v, (self.P, self.part), name)

    def start(self, v0):
        """A (P, part) vector to update in place: zeros, or a copy of v0."""
        if v0 is None:
            return torch.zeros((self.P, self.part), dtype=torch.float32,
                               device=self.device)
        return self.vector(v0).clone()

    def sq_pass(self, v, sq_part):
        self._pass("sq_pass", (v,), _ptr(v), _ptr(sq_part), vec=self.body)

    def update(self, vin, vout, cw, wsum, sq_part, d2_part=None, d2=None,
               tol2=0.0):
        """One iteration from ``vin`` (None: zeros) into ``vout`` (may be
        ``vin``: in place), carrying the next norms incrementally into
        ``sq_part``. With d2 (the adaptive step) a frozen partition is
        neither read nor written, so only a first step (d2 = +inf) may
        write a ``vout`` other than ``vin``."""
        if self.n > TILE and self._scratch is None:
            # the peer-tiled update keeps each column's update here between
            # its two sweeps; one buffer per stack, reused by every iteration
            self._scratch = self.empty(self.P, self.part)
        self._pass("update", (vin, vout), _ptr(vin), _ptr(vout), _ptr(cw),
                   _ptr(wsum), _ptr(sq_part), _ptr(d2_part), _ptr(d2), tol2,
                   _ptr(self._scratch), vec=self.body)

    def clip_pass(self, vin, vout, cw, wsum, sq_part):
        """A pass of the two-phase clip: with ``vout`` None the norms at
        ``vin`` (None: zeros) into ``sq_part``; else the update ``vin`` ->
        ``vout`` (may be ``vin``), carrying the next iteration's norms at
        ``vout`` into ``sq_part`` unless it is None."""
        self._pass("clip_pass", (vin, vout), _ptr(vin), _ptr(vout),
                   _ptr(cw), _ptr(wsum), _ptr(sq_part), vec=self.clip_vec)

    def dot_pass(self, v, z, dot_part, sq_part=None):
        self._pass("dot_pass", (v, z), _ptr(v), _ptr(z), _ptr(dot_part),
                   _ptr(sq_part), vec=self.body)

    def rows_dot_pass(self, rows, v, z, dot_part, sq_part):
        self._pass("rows_dot_pass", (v, z), _ptr(rows), rows.shape[0],
                   _ptr(v), _ptr(z), _ptr(dot_part), _ptr(sq_part),
                   vec=self.body)

    def mean_dot_pass(self, w, v, z, dot_part, sq_part):
        """verified:mean's one read of the stack: writes v = sum_i w_i x_i /
        max(sum_i w_i, 1e-30) and the partials of <x_i - v, z> and
        ||x_i - v||^2 against it, the bits of a mean pass followed by
        ``dot_pass`` with norms."""
        self._pass("mean_dot_pass", (v, z), _ptr(w), _ptr(v), _ptr(z),
                   _ptr(dot_part), _ptr(sq_part), vec=self.body)

    def finish_weights(self, sq_part, w, tau, sq, cw, wsum=None,
                       d2_part=None, d2=None, iters=None, tol2=0.0,
                       d2_seen=None):
        """Clip weights from the norms' partials; the adaptive step (d2)
        also finishes d2 and iters, and writes d2 to ``d2_seen`` (the
        address of P floats of pinned host memory) when given."""
        self._call("finish weights", self.lib.cc_finish_weights,
                   _ptr(sq_part), self.P, self.C, self.n, _ptr(w),
                   float(tau), _ptr(sq), _ptr(cw), _ptr(wsum),
                   _ptr(d2_part), _ptr(d2), _ptr(iters), tol2, d2_seen)

    def finish_tables(self, dot_part, tau, s, norms, sq_part=None,
                      sq_in=None):
        # one CTA per row of the partials: P partitions, or k sampled ones
        self._call("finish tables", self.lib.cc_finish_tables,
                   _ptr(dot_part), _ptr(sq_part), _ptr(sq_in),
                   dot_part.shape[0], self.C, self.n, float(tau), _ptr(s),
                   _ptr(norms))

    def finish_digests(self, dot_part, sq_part, s, norms):
        self._call("finish digests", self.lib.cc_finish_digests,
                   _ptr(dot_part), _ptr(sq_part), dot_part.shape[0], self.C,
                   self.n, _ptr(s), _ptr(norms))


def _rows(rows, n_parts, device):
    """The sampled partition ids as a (k,) int32 tensor on ``device``,
    checked: k >= 1 and every id in [0, n_parts)."""
    rows = torch.as_tensor(rows).to(device=device, dtype=torch.int32)
    if rows.dim() != 1 or rows.shape[0] == 0:
        raise ValueError(f"rows must be a non-empty (k,) vector, got shape "
                         f"{tuple(rows.shape)}")
    if bool(((rows < 0) | (rows >= n_parts)).any()):
        raise ValueError(f"rows must lie in [0, {n_parts}), got "
                         f"{rows.tolist()}")
    return rows.contiguous()


def _on_cuda(grads) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if grads.is_cuda:
        return True
    if grads.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {grads.device}")


def _fused_clip(k, taus, z, tau_v, weights, v0):
    """The passes of the fused kernel over a validated stack ``k``:
    a norm prologue, len(taus) updates carrying the next norms, the table
    epilogue. v0 is read in place (None: zeros, read from nothing) and the
    first update writes v, so no pass copies or fills a vector.
    Returns (v, s, norms)."""
    w, v0 = k.weights(weights), k.vector(v0)
    z = k.f32(z, (k.P, k.part), "z")
    sq_part, dot_part = k.partials(), k.partials()
    sq, cw, wsum = k.empty(k.P, k.n), k.empty(k.P, k.n), k.empty(1)
    k.sq_pass(v0, sq_part)  # prologue: ||x_i - v0||^2
    k.finish_weights(sq_part, w, taus[0] if taus else tau_v, sq, cw, wsum)
    v = k.empty(k.P, k.part) if taus else k.start(v0)
    for it, tau in enumerate(taus):
        k.update(v0 if it == 0 else v, v, cw, wsum, sq_part=sq_part)
        k.finish_weights(sq_part, w, taus[min(it + 1, len(taus) - 1)], sq,
                         cw)
    s, norms = k.empty(k.P, k.n), k.empty(k.P, k.n)
    k.dot_pass(v, z, dot_part)  # epilogue: <x_i - v, z>; sq is carried
    k.finish_tables(dot_part, tau_v, s, norms, sq_in=sq)
    return v, s, norms


def butterfly_clip_fused(grads, n_parts, taus, z, tau_v=None, weights=None,
                         v0=None):
    """CenteredClip over every partition for ``len(taus)`` iterations with
    incremental next-iteration norms, then the Alg. 6 table epilogue
    s_i = min(1, tau_v/||x_i - v||) <z, x_i - v>, ||x_i - v||, in
    len(taus) + 2 passes of the stack. z, v0: (n_parts, part).
    Returns (agg (n_parts, part), s (n_parts, n), norms (n_parts, n))."""
    taus = [float(t) for t in taus]
    tau_v = taus[-1] if tau_v is None else float(tau_v)
    if not _on_cuda(grads):
        return butterfly_clip_fused_plain(grads, n_parts, taus, z, tau_v,
                                          weights, v0)
    out = _fused_clip(_Stack(grads, n_parts), taus, z, tau_v, weights, v0)
    _count("butterfly_clip_fused")
    return out


def _one_partition(xs, v=None):
    """The (n, part) float32 stack of one owner and an optional (part,)
    vector, checked: the single-partition kernels take nothing else."""
    if xs.dim() != 2 or xs.dtype != torch.float32:
        raise ValueError(f"xs must be an (n, part) float32 stack, got "
                         f"{tuple(xs.shape)} {xs.dtype}")
    if v is not None and tuple(v.shape) != (xs.shape[1],):
        raise ValueError(f"expected a ({xs.shape[1]},) vector, got "
                         f"{tuple(v.shape)}")
    return _Stack(xs, 1)


def centered_clip_fused(xs, taus, z, tau_v=None, weights=None, v0=None):
    """One owner's CenteredClip for ``len(taus)`` iterations with
    incremental next-iteration norms, then the Alg. 6 tables
    s_i = min(1, tau_v/||x_i - v||) <z, x_i - v>, ||x_i - v||, in
    len(taus) + 2 passes of the stack. xs (n, part) f32; z, v0 (part,).
    Returns (agg (part,), s (n,), norms (n,))."""
    taus = [float(t) for t in taus]
    tau_v = taus[-1] if tau_v is None else float(tau_v)
    if not _on_cuda(xs):
        return centered_clip_fused_plain(xs, taus, z, tau_v, weights, v0)
    k = _one_partition(xs, z)
    v, s, norms = _fused_clip(k, taus, z[None], tau_v, weights,
                              None if v0 is None else v0[None])
    _count("centered_clip_fused")
    return v[0], s[0], norms[0]


def verify_tables(xs, v, z, tau):
    """One owner's Alg. 6 tables against a given aggregate, in one pass:
    s_i = min(1, tau/||x_i - v||) <z, x_i - v>, norm_i = ||x_i - v||.
    xs (n, part) f32; v, z (part,). Returns (s (n,), norms (n,))."""
    if not _on_cuda(xs):
        return verify_tables_plain(xs, v, z, tau)
    k = _one_partition(xs, v)
    v, z = k.f32(v[None], (1, k.part), "v"), k.f32(z[None], (1, k.part), "z")
    dot_part, sq_part = k.partials(), k.partials()
    s, norms = k.empty(1, k.n), k.empty(1, k.n)
    k.dot_pass(v, z, dot_part, sq_part=sq_part)
    k.finish_tables(dot_part, tau, s, norms, sq_part=sq_part)
    _count("verify_tables")
    return s[0], norms[0]


def butterfly_clip_fused_dequant(qs, scales, n_parts, taus, z, tau_v=None,
                                 weights=None, v0=None):
    """``butterfly_clip_fused`` over wire payloads: qs (n, d) int8/bf16,
    scales (n_parts, n) f32, each element dequantized in registers as
    f32(q) * scale, so the result is bit for bit that of
    ``butterfly_clip_fused`` on ``dequantize(qs, scales)`` while every pass
    reads 1-2 bytes per element."""
    taus = [float(t) for t in taus]
    tau_v = taus[-1] if tau_v is None else float(tau_v)
    if not _on_cuda(qs):
        return butterfly_clip_fused_dequant_plain(qs, scales, n_parts, taus,
                                                  z, tau_v, weights, v0)
    out = _fused_clip(_Stack(qs, n_parts, scales), taus, z, tau_v, weights,
                      v0)
    _count("butterfly_clip_fused_dequant")
    return out


def verify_tables_batched(grads, n_parts, agg, z, tau):
    """The Alg. 6 tables of every partition against a given aggregate, in
    one pass. agg, z: (n_parts, part). Returns (s, norms), (n_parts, n)."""
    if not _on_cuda(grads):
        return verify_tables_batched_plain(grads, n_parts, agg, z, tau)
    k = _Stack(grads, n_parts)
    agg = k.f32(agg, (k.P, k.part), "agg")
    z = k.f32(z, (k.P, k.part), "z")
    dot_part, sq_part = k.partials(), k.partials()
    s, norms = k.empty(k.P, k.n), k.empty(k.P, k.n)
    k.dot_pass(agg, z, dot_part, sq_part=sq_part)
    k.finish_tables(dot_part, tau, s, norms, sq_part=sq_part)
    _count("verify_tables_batched")
    return s, norms


def adaptive_decide(i, max_iters, slots, seen, done, converged):
    """The adaptive loop's decision before it enqueues iteration i (from
    0): (whether to enqueue it, the newest iteration known complete).
    ``seen``: the newest iteration known complete so far (-1: none);
    ``done(j)``: whether iteration j's reading of d2 has landed on the host
    (an event's query: never a wait); ``converged(j)``: whether that reading
    has every partition at d2 <= tol2. Iterations land in order, so the
    host asks forward from ``seen`` and stops at the first that has not
    landed, among the ``slots`` newest only (an older slot has been
    written again). It stops at ``max_iters``, or once the newest landed
    reading shows every partition converged, which then lasts: a converged
    partition is frozen on the card, so every iteration enqueued after it
    is a no-op and where the loop stops changes no bit."""
    if i >= max_iters:
        return False, seen
    newest, j = seen, max(seen + 1, i - slots)
    while j < i and done(j):
        newest, j = j, j + 1
    return not (newest > seen and converged(newest)), newest


class _D2Ring:
    """The adaptive loop's readings of d2 (P,) on the host: iteration j's
    finish writes d2 into slot j % slots of a pinned host buffer (mapped
    into the card's address space: no copy is enqueued), and an event is
    recorded behind it on the stream of d2's card; ``done`` asks the
    event, ``converged`` reads the landed slot. The slots start at +inf,
    so a reading that were not yet visible could only delay the stop."""

    def __init__(self, d2, slots):
        self.slots = slots
        host = torch.empty((slots, d2.shape[0]), dtype=torch.float32,
                           pin_memory=True)
        self.rows = host.numpy()
        self.rows.fill(np.inf)
        self.ptrs = [row.data_ptr() for row in host]
        self.host = host
        self.events = [torch.cuda.Event() for _ in range(slots)]
        self.stream = torch.cuda.current_stream(d2.device)

    def slot(self, j):
        """The address iteration j's finish writes its d2 to."""
        return self.ptrs[j % self.slots]

    def push(self, j):
        """The event behind iteration j's finish."""
        self.events[j % self.slots].record(self.stream)

    def done(self, j):
        return self.events[j % self.slots].query()

    def converged(self, j, tol2):
        return not bool((self.rows[j % self.slots] > tol2).any())


def _release_landed():
    """Drop the held rings whose last finish has landed (an event's query:
    never a wait)."""
    with _HELD_LOCK:
        _HELD_RINGS[:] = [(r, j) for r, j in _HELD_RINGS if not r.done(j)]


def _hold_ring(ring, last):
    """Keep ``ring`` alive until iteration ``last``'s finish has landed.
    The finishes write d2 through a raw mapped pointer, which records no
    stream on the pinned block, so torch's host cache would hand the block
    out again as soon as the ring were dropped, while finishes queued
    behind the call still write to it. The finishes land in order, so the
    last one's event covers them all."""
    if last >= 0:
        with _HELD_LOCK:
            _HELD_RINGS.append((ring, last))


def _adaptive_clip(k, tau, tol, max_iters, weights, v0, ring=_D2Ring):
    """The passes of the early-exit loop over a validated stack ``k``: a
    norm prologue at v0 (read in place), then up to ``max_iters``
    iterations, each a step (update carrying the next norms and ||dv||^2)
    and its finish (clip weights; d2 and iters of the partitions that
    stepped), enqueued back to back with no host read between them: each
    finish also writes d2 into a slot of ``ring``, pinned host memory,
    behind which an event is recorded; the host polls the landed slots
    (``adaptive_decide``) to stop enqueuing once every partition has
    converged, and the ring outlives the call until its last finish has
    landed (``_hold_ring``). The first step reads v0 and writes v (every
    partition steps at iteration 0 while tol2 < +inf, the d2 it starts
    from), the rest run in place. A tol2 of +inf or NaN freezes every partition before its
    first step: v0 (None: zeros) comes back, and nothing is launched.
    Each step enqueued is a launch.
    Returns (v (P, part), iters (P,) int32)."""
    w, v0 = k.weights(weights), k.vector(v0)
    sq_part, d2_part = k.partials(), k.empty(k.P, k.C)
    sq, cw, wsum = k.empty(k.P, k.n), k.empty(k.P, k.n), k.empty(1)
    tol2 = float(np.float32(tol) ** 2)
    d2 = torch.full((k.P,), math.inf, device=k.device)
    iters = torch.zeros((k.P,), dtype=torch.int32, device=k.device)
    if max_iters < 1 or not math.inf > tol2:
        return k.start(v0), iters
    k.sq_pass(v0, sq_part)  # prologue: the carried state for v0
    k.finish_weights(sq_part, w, tau, sq, cw, wsum)
    v = k.empty(k.P, k.part)
    _release_landed()
    ring = ring(d2, min(max_iters, ADAPTIVE_RING))
    seen, last = -1, -1
    for i in range(max_iters):
        go_on, seen = adaptive_decide(i, max_iters, ring.slots, seen,
                                      ring.done,
                                      lambda j: ring.converged(j, tol2))
        if not go_on:
            break
        k.update(v0 if i == 0 else v, v, cw, wsum, sq_part=sq_part,
                 d2_part=d2_part, d2=d2, tol2=tol2)
        _count("adaptive_clip_step")
        k.finish_weights(sq_part, w, tau, sq, cw, d2_part=d2_part, d2=d2,
                         iters=iters, tol2=tol2, d2_seen=ring.slot(i))
        ring.push(i)
        last = i
    _hold_ring(ring, last)
    return v, iters


def butterfly_clip_adaptive(grads, n_parts, tau, tol, max_iters,
                            weights=None, v0=None):
    """Early-exit CenteredClip: one step kernel per iteration, clip weights
    from the carried squared norms, converged partitions frozen (their
    step is skipped, which is the select of the TPU loop). The loop is
    decided on the card: iterations go out back to back and the host only
    polls landed readings of ||dv||^2 to stop enqueuing
    (``_adaptive_clip``).
    ``LAUNCHES`` counts the steps enqueued.
    Returns (agg (n_parts, part), iters (n_parts,) int32)."""
    if not _on_cuda(grads):
        return butterfly_clip_adaptive_plain(grads, n_parts, tau, tol,
                                             max_iters, weights, v0)
    return _adaptive_clip(_Stack(grads, n_parts), tau, tol, max_iters,
                          weights, v0)


def _two_pass_clip(k, taus, weights, v0):
    """The passes of the two-phase kernel over a validated stack ``k``. Up
    to TILE peers one read of the stack an iteration: a prologue forms the
    norms at v0, and each update but the last forms the next iteration's
    norms at its result, ||x_i - v_new||^2 recomputed from x (not the fused
    kernel's incremental ones). Above TILE, per iteration a norm pass and
    an update pass. Clip weights at each iteration's tau; v0 is read in
    place (None: zeros) and the first update writes v.
    Returns v (k.P, k.part)."""
    w, v0 = k.weights(weights), k.vector(v0)
    sq_part = k.partials()
    sq, cw, wsum = k.empty(k.P, k.n), k.empty(k.P, k.n), k.empty(1)
    v = k.empty(k.P, k.part) if taus else k.start(v0)
    one_read = k.n <= TILE
    for it, tau in enumerate(taus):
        vin = v0 if it == 0 else v
        if it == 0 or not one_read:
            k.clip_pass(vin, None, None, None, sq_part)
        k.finish_weights(sq_part, w, tau, sq, cw, wsum if it == 0 else None)
        carry = one_read and it + 1 < len(taus)
        k.clip_pass(vin, v, cw, wsum, sq_part if carry else None)
    return v


def butterfly_clip(grads, n_parts, taus, weights=None, v0=None):
    """Two-phase CenteredClip without tables: per iteration the norms
    recomputed from x and an update, len(taus) + 1 passes of the stack up
    to TILE peers (2 len(taus) above). Returns (n_parts, part)."""
    taus = [float(t) for t in taus]
    if not _on_cuda(grads):
        return butterfly_clip_plain(grads, n_parts, taus, weights, v0)
    v = _two_pass_clip(_Stack(grads, n_parts), taus, weights, v0)
    _count("butterfly_clip")
    return v


def centered_clip(xs, taus, weights=None, v0=None):
    """Single-partition CenteredClip with a per-iteration tau schedule
    (kernel #12): #4's passes over the whole (n, d) stack,
    v += sum_i w_i min(1, taus[l]/||x_i - v||) (x_i - v) / max(sum_i w_i,
    1e-30), len(taus) + 1 passes up to TILE peers, no tables. xs (n, d)
    float32 or bfloat16 (widened exactly in registers); weights (n,); v0
    (d,) warm start. Returns v (d,) float32."""
    taus = [float(t) for t in taus]
    if not _on_cuda(xs):
        return centered_clip_plain(xs, taus, weights, v0)
    if xs.dim() != 2 or xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xs must be an (n, d) float32 or bfloat16 stack, "
                         f"got {tuple(xs.shape)} {xs.dtype}")
    if v0 is not None and tuple(v0.shape) != (xs.shape[1],):
        raise ValueError(f"v0 must be ({xs.shape[1]},), got "
                         f"{tuple(v0.shape)}")
    # a bf16 stack runs the wire passes with unit scales: q * 1 is exact
    scales = (None if xs.dtype == torch.float32 else
              torch.ones((1, xs.shape[0]), dtype=torch.float32,
                         device=xs.device))
    v = _two_pass_clip(_Stack(xs, 1, scales), taus, weights,
                       None if v0 is None else v0[None])
    _count("centered_clip")
    return v[0]


def digest_tables_batched(grads, n_parts, agg, z):
    """The verified:* digests of every partition against a given aggregate,
    in one pass: s_i = <z, x_i - v>, norm_i = ||x_i - v||, no clip weight.
    agg, z: (n_parts, part). Returns (s, norms), (n_parts, n)."""
    if not _on_cuda(grads):
        return digest_tables_batched_plain(grads, n_parts, agg, z)
    k = _Stack(grads, n_parts)
    agg = k.f32(agg, (k.P, k.part), "agg")
    z = k.f32(z, (k.P, k.part), "z")
    dot_part, sq_part = k.partials(), k.partials()
    s, norms = k.empty(k.P, k.n), k.empty(k.P, k.n)
    k.dot_pass(agg, z, dot_part, sq_part=sq_part)
    k.finish_digests(dot_part, sq_part, s, norms)
    _count("digest_tables_batched")
    return s, norms


def _mean_digest(k, z, weights):
    """verified:mean over a validated stack ``k`` in one read of it: the
    pass that writes the weighted mean and the digests' partials against
    it, then their finish. Returns (v, s, norms)."""
    w = k.weights(weights)
    z = k.f32(z, (k.P, k.part), "z")
    v = k.empty(k.P, k.part)
    dot_part, sq_part = k.partials(), k.partials()
    s, norms = k.empty(k.P, k.n), k.empty(k.P, k.n)
    k.mean_dot_pass(w, v, z, dot_part, sq_part)
    k.finish_digests(dot_part, sq_part, s, norms)
    return v, s, norms


def mean_digest_fused(grads, n_parts, z, weights=None):
    """verified:mean in one read of the stack: v = sum_i w_i x_i /
    max(sum_i w_i, 1e-30) per partition and the digests against v (two
    reads above 32 peers).
    z: (n_parts, part); weights: (n,). Returns (agg (n_parts, part),
    s (n_parts, n), norms (n_parts, n))."""
    if not _on_cuda(grads):
        return mean_digest_fused_plain(grads, n_parts, z, weights)
    out = _mean_digest(_Stack(grads, n_parts), z, weights)
    _count("mean_digest_fused")
    return out


def mean_digest_fused_dequant(qs, scales, n_parts, z, weights=None):
    """``mean_digest_fused`` over wire payloads (qs (n, d) int8/bf16,
    scales (n_parts, n)), dequantized in registers: bit for bit the result
    on ``dequantize(qs, scales)``."""
    if not _on_cuda(qs):
        return mean_digest_fused_dequant_plain(qs, scales, n_parts, z,
                                               weights)
    out = _mean_digest(_Stack(qs, n_parts, scales), z, weights)
    _count("mean_digest_fused_dequant")
    return out


def digest_tables_rows(grads, n_parts, agg, z, rows, tau):
    """The digests of the sampled partitions ``rows`` only, in one pass
    over those k partitions of the stack: tau > 0 applies the clip weight
    min(1, tau/||x_i - v||) (tau = inf -> 1), as ``verify_tables_batched``;
    tau <= 0 gives the plain digests, as ``digest_tables_batched``. agg, z:
    (n_parts, part); rows: (k,) partition ids in [0, n_parts). The chunking
    is that of the full n_parts-partition stack, so row j equals row
    rows[j] of the full kernel's output bit for bit. Returns (s, norms),
    both (k, n)."""
    if not _on_cuda(grads):
        return digest_tables_rows_plain(grads, n_parts, agg, z, rows, tau)
    rows = _rows(rows, n_parts, grads.device)
    k = _Stack(grads, n_parts)
    agg = k.f32(agg, (k.P, k.part), "agg")
    z = k.f32(z, (k.P, k.part), "z")
    n_rows = rows.shape[0]
    dot_part, sq_part = k.partials(n_rows), k.partials(n_rows)
    s, norms = k.empty(n_rows, k.n), k.empty(n_rows, k.n)
    k.rows_dot_pass(rows, agg, z, dot_part, sq_part)
    if float(tau) > 0:
        k.finish_tables(dot_part, tau, s, norms, sq_part=sq_part)
    else:
        k.finish_digests(dot_part, sq_part, s, norms)
    _count("digest_tables_rows")
    return s, norms
