"""The Python side of the CenteredClip kernels' pass geometry
(``repro_torch.kernels.centered_clip``), on the CPU: the logical chunk grid
is a function of (n, d, n_parts) alone, its chunk length a multiple of the
group width, its chunks tile each partition with none empty; and the
drivers hand every pass and its finish the same grid and buffers, read v0
in place, and ask for 16-byte loads exactly where every row start is
aligned. The kernels themselves run on the card only
(``tests/test_torch_cuda.py``); here a recording stand-in for the built
library takes their launches."""
import ctypes
import gc
import inspect
import math
import weakref

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import centered_clip as kc

D_FULL = 78_223_360  # ALBERT-large's d
GRIDS = [(4, D_FULL, 4), (4, D_FULL // 4, 1), (2, D_FULL // 2, 1),
         (16, D_FULL, 1), (5, 5 * 1001 - 3, 5), (4, 4 * 517 - 3, 4),
         (4, 4 * (4096 + 5), 4), (33, 2**20 + 3, 33), (64, 2**20 + 3, 64),
         (1, 1, 1), (8, 8 * kc.CHUNK, 8), (3, kc.CHUNK + 1, 1)]


@pytest.mark.parametrize("n, d, n_parts", GRIDS)
def test_chunk_grid_tiles_each_partition(n, d, n_parts):
    g = kc.chunk_grid(n, d, n_parts)
    assert g == kc.chunk_grid(n, d, n_parts)
    assert g.part == kc.part_len(d, n_parts)
    assert g.group == (kc.GROUP if n <= 8 else 1)
    assert g.cs % kc.GROUP == 0 and g.cs % g.group == 0
    assert g.C == math.ceil(g.part / g.cs)
    # the two-phase clip's passes: the same chunks, groups of 4 up to 32
    # peers (the register and the staged bodies), 1 above (peer tiles)
    assert kc.clip_grid(n, d, n_parts) == g._replace(
        group=kc.GROUP if n <= 32 else 1)
    bounds = [(c * g.cs, min(g.part, (c + 1) * g.cs)) for c in range(g.C)]
    assert bounds[0][0] == 0 and bounds[-1][1] == g.part
    assert all(k0 < k1 for k0, k1 in bounds)  # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_chunk_grid_takes_nothing_of_the_card():
    """The grid's only inputs are (n, d, n_parts) and module constants:
    the persistent grid that walks it is sized inside the launchers."""
    assert list(inspect.signature(kc.chunk_grid).parameters) == [
        "n", "d", "n_parts"]
    assert kc.CHUNK % kc.GROUP == 0


class _Recorder:
    """Stands in for a built library: records each launcher call."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        if not name.startswith(("cc_", "wire_")):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def calls(monkeypatch):
    rec = []
    monkeypatch.setattr(build, "load", lambda name="centered_clip":
                        _Recorder(rec))
    monkeypatch.setattr(kc, "_stream", lambda device: 0)
    return rec


def _pass_args(name, args):
    """(cs, C, vec, the pass's own arguments) of a recorded pass."""
    i = 6 if name.startswith("cc_") else 8
    return args[i], args[i + 1], args[i + 2], args[i + 3:-1]


def _stack(n, d, n_parts, offset=0, dtype=torch.float32):
    big = torch.zeros((n, d + 8 + offset), dtype=dtype)
    return big[:, offset:offset + d]


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("n, d, n_parts", [(4, 4 * 4096, 4),
                                           (5, 5 * 1001 - 3, 5),
                                           (3, 3 * 8200, 1)])
def test_fused_driver_hands_each_pass_the_grid(calls, n, d, n_parts, cold):
    """The fused clip: a norm prologue on v0 (read in place, or nothing on
    a cold start), the iterations (the first from v0 into a new v, then in
    place), the dot pass, each finish on its pass's partials and C; every
    pass on the staged body where every row start is 16-byte aligned (a
    group of 4 float32), else column by column."""
    g = _stack(n, d, n_parts)
    k = kc._Stack(g, n_parts)
    geo = kc.chunk_grid(n, d, n_parts)
    v0 = None if cold else torch.zeros((n_parts, geo.part))
    z = torch.zeros((n_parts, geo.part))
    taus = [1.0] * 3
    v, _, _ = kc._fused_clip(k, taus, z, 1.0, None, v0)
    names = [c[0] for c in calls]
    assert names == (["cc_sq_pass", "cc_finish_weights"]
                     + ["cc_update", "cc_finish_weights"] * len(taus)
                     + ["cc_dot_pass", "cc_finish_tables"])
    ld = g.stride(0)
    want_vec = kc.STAGED * int(geo.part % 4 == 0 and ld % 4 == 0)
    v0_ptr = None if cold else v0.data_ptr()
    written = None
    for (name, args), (fin, fargs) in zip(calls[::2], calls[1::2]):
        cs, C, vec, own = _pass_args(name, args)
        assert (cs, C, vec) == (geo.cs, geo.C, want_vec)
        # the finish sums the C partials of the buffer the pass wrote
        if fin == "cc_finish_weights":
            assert fargs[2] == C
        else:
            assert fargs[4] == C
        if name == "cc_sq_pass":
            assert own[0] == v0_ptr and fargs[0] == own[1]
        elif name == "cc_update":
            want_in = v0_ptr if written is None else written
            assert own[:2] == (want_in, v.data_ptr())
            assert fargs[0] == own[4]
            written = own[1]
        else:
            assert own[0] == v.data_ptr() and fargs[0] == own[2]
    assert k.partials().shape == (n_parts, n, geo.C)


@pytest.mark.parametrize("offset, dtype, want", [
    (0, torch.float32, 1), (1, torch.float32, 0), (2, torch.float32, 0),
    (4, torch.float32, 1), (0, torch.int8, 1), (2, torch.int8, 0),
    (0, torch.bfloat16, 1), (1, torch.bfloat16, 0)])
def test_wide_loads_only_where_every_row_start_is_aligned(calls, offset,
                                                          dtype, want):
    """vec = 1 exactly when the stack's base, row stride and partition
    length keep every (peer, partition) row start on a group of 4 elements
    and the float32 vectors are 16-byte aligned; the same stack at another
    storage offset runs the column-by-column body, whose sums are the
    same. A stack whose row starts are all on 16 bytes asks for the
    staged body (vec 2), which implies them."""
    n, n_parts, part = 4, 2, 4096
    g = _stack(n, n_parts * part, n_parts, offset, dtype)
    scales = None if dtype == torch.float32 else torch.ones((n_parts, n))
    k = kc._Stack(g, n_parts, scales)
    v = torch.zeros((n_parts, part))
    k.sq_pass(v, k.partials())
    got = _pass_args(*calls[-1])[2]
    assert min(got, 1) == want
    assert (got == kc.STAGED) == k.stage
    # a float32 vector off its 16-byte alignment turns the wide loads off
    k.sq_pass(torch.zeros(n_parts * part + 1)[1:].view(n_parts, part),
              k.partials())
    assert _pass_args(*calls[-1])[2] == 0


@pytest.mark.parametrize("n, d, n_parts", [(4, 4 * 4097, 4),
                                           (9, 9 * 4096, 9),
                                           (40, 40 * 4096, 40)])
def test_no_wide_loads_for_ragged_partitions_or_many_peers(calls, n, d,
                                                           n_parts):
    """A partition length that is not a multiple of 4, or more than 8
    peers (groups of one column), runs the column-by-column body."""
    k = kc._Stack(_stack(n, d, n_parts), n_parts)
    k.sq_pass(None, k.partials())
    assert _pass_args(*calls[-1])[2] == 0


@pytest.mark.parametrize("n", [4, 16, 40])
def test_two_pass_and_digest_drivers_share_the_grid(calls, n):
    """#4 up to 32 peers reads the stack once an iteration: a prologue
    forms the norms at v0 (read in place), then every update (the first
    from v0 into a new v, then in place) but the last carries the next
    norms into the buffer its finish sums. Above 32 peers a norm pass and
    an update an iteration. The sampled rows pass takes the full stack's
    grid, so a sampled row sums what the full pass sums."""
    n_parts, part = 4, 4096 * 3 + 4
    g = _stack(n, n_parts * part, n_parts)
    geo = kc.chunk_grid(n, n_parts * part, n_parts)
    v0 = torch.zeros((n_parts, part))
    taus = [1.0, 2.0, 3.0]
    v = kc._two_pass_clip(kc._Stack(g, n_parts), taus, None, v0)
    one_read = n <= 32
    if one_read:
        want = (["cc_clip_pass", "cc_finish_weights"]
                + ["cc_clip_pass", "cc_finish_weights"] * (len(taus) - 1)
                + ["cc_clip_pass"])
    else:
        want = ["cc_clip_pass", "cc_finish_weights", "cc_clip_pass"] * 3
    assert [c[0] for c in calls] == want
    passes = [_pass_args(*c) for c in calls if c[0] == "cc_clip_pass"]
    finishes = [args for name, args in calls if name == "cc_finish_weights"]
    sq = finishes[0][0]
    assert all(f[0] == sq and f[2] == geo.C for f in finishes)
    assert [f[5] for f in finishes] == taus
    assert all((cs, C, vec) == (geo.cs, geo.C, int(one_read))
               for cs, C, vec, _ in passes)
    # (v_in, v_out, the norms' buffer) of each pass
    got = [(own[0], own[1], own[4]) for _, _, _, own in passes]
    vp, v0p = v.data_ptr(), v0.data_ptr()
    if one_read:
        assert got == [(v0p, None, sq), (v0p, vp, sq), (vp, vp, sq),
                       (vp, vp, None)]
    else:
        assert got == [(v0p, None, sq), (v0p, vp, None), (vp, None, sq),
                       (vp, vp, None), (vp, None, sq), (vp, vp, None)]
    calls.clear()
    k = kc._Stack(g, n_parts)
    z = torch.zeros((n_parts, part))
    rows = torch.tensor([3, 1], dtype=torch.int32)
    dot_part, sq_part = k.partials(2), k.partials(2)
    k.rows_dot_pass(rows, v0, z, dot_part, sq_part)
    cs, C, _, own = _pass_args(*calls[-1])
    assert (cs, C) == (geo.cs, geo.C) and own[1] == 2
    assert dot_part.shape == (2, n, geo.C)


@pytest.mark.parametrize("n, offset, dtype, want", [
    (4, 0, torch.float32, 1), (4, 2, torch.float32, 0),
    (16, 0, torch.float32, 1), (16, 2, torch.float32, 0),
    (16, 4, torch.float32, 1), (32, 1, torch.float32, 0),
    (4, 4, torch.bfloat16, 0), (4, 8, torch.bfloat16, 1),
    (16, 0, torch.bfloat16, 1),
    (16, 4, torch.bfloat16, 0), (24, 8, torch.bfloat16, 1),
    (33, 0, torch.float32, 0)])
def test_two_phase_passes_stage_only_16_byte_rows(calls, n, offset, dtype,
                                                  want):
    """The two-phase clip asks for its staged body (vec = 1), which copies
    whole 16-byte units into shared memory, up to 32 peers where every row
    start is 16-byte aligned (a bf16 row on 8 bytes runs the global body);
    above 32 peers the peer-tiled passes take none."""
    n_parts, part = 2, 4096
    g = _stack(n, n_parts * part, n_parts, offset, dtype)
    scales = None if dtype == torch.float32 else torch.ones((n_parts, n))
    k = kc._Stack(g, n_parts, scales)
    prefix = "cc_" if dtype == torch.float32 else "wire_"
    k.clip_pass(None, None, None, None, k.partials())
    assert calls[-1][0] == prefix + "clip_pass"
    assert _pass_args(*calls[-1])[2] == want


# ---------------------------------------------------------------------------
# #3: the adaptive loop decided on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i, max_iters, slots, seen, landed, conv_from, want", [
    # nothing enqueued yet: go on, nothing seen
    (0, 5, 5, -1, -1, 0, (True, -1)),
    # the cap: stop whatever landed
    (5, 5, 5, 4, 4, None, (False, 4)),
    # iteration 0 landed, converged from 0: stop
    (1, 5, 5, -1, 0, 0, (False, 0)),
    # iterations 0-2 landed, converged only from 3: go on, seen 2
    (3, 5, 5, -1, 2, 3, (True, 2)),
    # nothing new landed since seen (not converged then): go on
    (4, 8, 8, 2, 2, 0, (True, 2)),
    # the newest landed reading decides (converged from 2, 0-3 landed)
    (4, 8, 8, 0, 3, 2, (False, 3)),
    # slots: only the 2 newest are asked (0-4 landed, 5 not): sees 4
    (6, 9, 2, -1, 4, None, (True, 4)),
    # an overwritten slot is never read: 0 landed but only 4-5 may be
    # asked, and neither has landed
    (6, 9, 2, -1, 0, 0, (True, -1)),
    # never converged: go on up to the cap
    (7, 8, 8, 5, 6, None, (True, 6)),
])
def test_adaptive_decision(i, max_iters, slots, seen, landed, conv_from,
                           want):
    """``adaptive_decide``, the adaptive loop's host logic, against a fake
    poll: iterations up to ``landed`` have landed, and a landed reading
    shows every partition converged from iteration ``conv_from`` on (None:
    never). It asks only iterations it may read (the ``slots`` newest,
    forward from ``seen``), in order, and never one not yet enqueued."""
    asked = []

    def done(j):
        assert max(seen + 1, i - slots) <= j < i
        asked.append(j)
        return j <= landed

    def converged(j):
        assert j <= landed and j >= i - slots
        return conv_from is not None and j >= conv_from

    assert kc.adaptive_decide(i, max_iters, slots, seen, done,
                              converged) == want
    assert asked == sorted(asked)


class _AdaptiveCard(_Recorder):
    """The recording stand-in plus the finish's bookkeeping of the adaptive
    step, written into the (CPU) d2 and iters buffers: a partition whose d2
    is above tol2 steps, iters[p] += 1, and its d2 becomes 0 on its step
    number conv[p] (from 0; None: never), else 1; d2 is then written to
    the ring's slot the finish is handed."""

    def __init__(self, calls, conv):
        super().__init__(calls)
        self.conv = conv

    def __getattr__(self, name):
        launch = super().__getattr__(name)
        if name != "cc_finish_weights":
            return launch

        def finish(*args):
            launch(*args)
            P, d2_ptr, iters_ptr, tol2, seen = args[1], *args[10:14]
            if d2_ptr is not None:
                d2 = np.ctypeslib.as_array(
                    (ctypes.c_float * P).from_address(d2_ptr))
                iters = np.ctypeslib.as_array(
                    (ctypes.c_int32 * P).from_address(iters_ptr))
                for p in range(P):
                    if d2[p] > tol2:
                        d2[p] = 0.0 if iters[p] == self.conv[p] else 1.0
                        iters[p] += 1
                np.ctypeslib.as_array(
                    (ctypes.c_float * P).from_address(seen))[:] = d2
            return 0
        return finish


class _FakeRing:
    """Stands in for the pinned ring (slots of P floats, from +inf): the
    stand-in finish writes iteration j's d2 into slot j % slots at once,
    and its reading lands once the host has enqueued ``lag`` more
    iterations."""

    def __init__(self, calls, lag):
        self.calls, self.lag = calls, lag

    def __call__(self, d2, slots):
        self.slots, self.pushed = slots, 0
        self.rows = np.full((slots, d2.shape[0]), np.inf, dtype=np.float32)
        return self

    def slot(self, j):
        return self.rows[j % self.slots].ctypes.data

    def push(self, j):
        assert j == self.pushed
        self.calls.append(("push", j))
        self.pushed += 1

    def done(self, j):
        return j < self.pushed - self.lag

    def converged(self, j, tol2):
        return not (self.rows[j % self.slots] > tol2).any()


HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
              "tolist", "numpy", "cpu")


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("max_iters, conv, lag", [
    (6, [0, 0, 0], 0),            # every partition converges on step 0
    (6, [1, 0, 1], 0),            # step 1
    (6, [3, 1, 0], 2),            # mid-way, the readings 2 behind
    (20, [9, 4, 0, 2], 3),
    (20, [9, 4, 0, 2], 25),       # the host more than the ring ahead
    (6, [2, None, 0], 1),         # one partition never converges
    (6, [None, None, None], 0),
    (1, [0, 0, 0], 0),
    (0, [0, 0, 0], 0),
])
def test_adaptive_loop_enqueues_without_host_reads(monkeypatch, max_iters,
                                                   conv, lag, cold):
    """#3's host loop: a norm prologue, then (update, finish) pairs back to
    back, each followed by the ring's copy of d2 and nothing else: no host
    read of a tensor at all, and one launch counted a step enqueued. It
    stops within ``lag`` + 1 iterations after the
    step that converges the last partition (the readings lag the host by
    ``lag`` iterations) while the ring holds them, else at ``max_iters``,
    never past it; the first step reads v0 (None: nothing) and writes v,
    the rest run in place; each step's finish writes d2 to its slot."""
    calls = []
    monkeypatch.setattr(build, "load", lambda name="centered_clip":
                        _AdaptiveCard(calls, conv))
    monkeypatch.setattr(kc, "_stream", lambda device: 0)
    for name in HOST_READS:
        real = getattr(torch.Tensor, name)

        def read(self, *a, _real=real, _name=name, **kw):
            calls.append(("read", _name))
            return _real(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, read)
    P = len(conv)
    g = _stack(4, P * 4096, P)
    v0 = None if cold else torch.zeros((P, 4096))
    before = kc.LAUNCHES["adaptive_clip_step"]
    ring = _FakeRing(calls, lag)
    v, iters = kc._adaptive_clip(kc._Stack(g, P), 1.0, 1e-4, max_iters,
                                 None, v0, ring=ring)
    monkeypatch.undo()  # the reads below are the test's own
    slots = min(max_iters, kc.ADAPTIVE_RING)
    last = None if None in conv else max(conv)
    if last is not None and lag < slots:
        m = min(max_iters, last + lag + 1)
    else:
        m = max_iters
    want_iters = [m if c is None else min(c + 1, m) for c in conv]
    names = [c[0] for c in calls]
    if max_iters == 0:
        assert names == []
    else:
        assert names == (["cc_sq_pass", "cc_finish_weights"]
                         + ["cc_update", "cc_finish_weights", "push"] * m)
    assert m <= max_iters
    assert iters.tolist() == want_iters
    assert kc.LAUNCHES["adaptive_clip_step"] - before == m
    updates = [_pass_args(n, a)[3] for n, a in calls if n == "cc_update"]
    # each step's finish writes d2 to its iteration's slot, the prologue's
    # to none
    finishes = [a for n, a in calls if n == "cc_finish_weights"]
    assert [f[13] for f in finishes] == (
        [None] + [ring.slot(j) for j in range(m)] if max_iters else [])
    # the prologue and the steps take the staged body (an aligned stack)
    assert all(_pass_args(n, a)[2] == kc.STAGED for n, a in calls
               if n in ("cc_sq_pass", "cc_update"))
    v0_ptr = None if cold else v0.data_ptr()
    assert [u[:2] for u in updates] == (
        [(v0_ptr, v.data_ptr())] + [(v.data_ptr(), v.data_ptr())] * (m - 1)
        if m else [])


class _LandingRing(_FakeRing):
    """A stand-in ring whose readings (and the event behind its last
    finish) report done only once ``landed`` is set."""

    def __init__(self, calls):
        super().__init__(calls, lag=0)
        self.landed = False

    def done(self, j):
        return self.landed and super().done(j)


def test_adaptive_ring_outlives_the_call_until_its_last_finish_lands(
        monkeypatch):
    """The ring's pinned block is written by finishes still queued when
    the call returns, so the loop holds the ring past the call: it stays
    alive while the event behind its last finish reports not done (across
    further calls), and is released by the first call after it reports
    done; a call that enqueued nothing holds nothing."""
    calls = []
    monkeypatch.setattr(build, "load", lambda name="centered_clip":
                        _AdaptiveCard(calls, [None, None]))
    monkeypatch.setattr(kc, "_stream", lambda device: 0)
    monkeypatch.setattr(kc, "_HELD_RINGS", [])
    g = _stack(4, 2 * 4096, 2)

    def call(max_iters=6):
        ring = _LandingRing(calls)
        kc._adaptive_clip(kc._Stack(g, 2), 1.0, 1e-4, max_iters, None, None,
                          ring=ring)
        return weakref.ref(ring)

    first = call()
    gc.collect()
    assert first() is not None and first().pushed == 6
    assert kc._HELD_RINGS == [(first(), 5)]  # held behind iteration 5
    second = call()  # the first's last finish has not landed: both held
    gc.collect()
    assert first() is not None and second() is not None
    first().landed = True
    third = call()  # made after the first landed: the first goes
    gc.collect()
    assert first() is None
    assert second() is not None and third() is not None
    second().landed = third().landed = True
    kc._release_landed()
    gc.collect()
    assert second() is None and third() is None and kc._HELD_RINGS == []
    none = call(max_iters=0)
    gc.collect()
    assert none() is None and kc._HELD_RINGS == []


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("tol", [math.inf, 2e19, math.nan])
def test_adaptive_loop_at_unbounded_tol_launches_nothing(calls, tol, cold):
    """A tolerance whose float32 square is +inf or NaN freezes every
    partition before its first step, as in the plain version: nothing is
    launched or counted, v0 comes back in a vector of its own (zeros on a
    cold start) and iters is 0."""
    P, part = 3, 4096
    g = _stack(4, P * part, P)
    v0 = None if cold else torch.rand((P, part))
    before = kc.LAUNCHES["adaptive_clip_step"]
    with np.errstate(over="ignore"):
        v, iters = kc._adaptive_clip(kc._Stack(g, P), 1.0, tol, 6, None, v0)
        want_v, want_it = kc.butterfly_clip_adaptive_plain(g, P, 1.0, tol, 6,
                                                           None, v0)
    assert calls == []
    assert kc.LAUNCHES["adaptive_clip_step"] == before
    assert torch.equal(v, want_v) and torch.equal(iters, want_it)
    assert iters.tolist() == [0] * P
    assert v0 is None or v.data_ptr() != v0.data_ptr()


# ---------------------------------------------------------------------------
# #7: the wire passes' staged body
# ---------------------------------------------------------------------------
def _wire_stack(n, d, ld, offset, dtype):
    big = torch.zeros(n * ld + offset + 64, dtype=dtype)
    return big[offset:offset + n * ld].view(n, ld)[:, :d]


@pytest.mark.parametrize("dtype, n, part, extra, offset, want", [
    (torch.int8, 4, 4096, 0, 0, 2), (torch.int8, 4, 4096, 0, 16, 2),
    (torch.int8, 4, 4096, 0, 4, 1), (torch.int8, 4, 4096, 0, 1, 0),
    (torch.int8, 4, 4096, 16, 0, 2), (torch.int8, 4, 4096, 4, 0, 1),
    (torch.int8, 4, 4100, 0, 0, 1), (torch.int8, 4, 4112, 0, 0, 2),
    (torch.int8, 8, 4096, 0, 0, 2), (torch.int8, 9, 4096, 0, 0, 0),
    (torch.int8, 16, 4096, 0, 0, 0), (torch.int8, 33, 4096, 0, 0, 0),
    (torch.bfloat16, 4, 4096, 0, 0, 2), (torch.bfloat16, 4, 4096, 0, 8, 2),
    (torch.bfloat16, 4, 4096, 0, 4, 1), (torch.bfloat16, 4, 4096, 0, 2, 0),
    (torch.bfloat16, 4, 4096, 8, 0, 2), (torch.bfloat16, 4, 4096, 4, 0, 1),
    (torch.bfloat16, 4, 4100, 0, 0, 1), (torch.bfloat16, 4, 4104, 0, 0, 2),
    (torch.bfloat16, 8, 4096, 0, 0, 2), (torch.bfloat16, 16, 4096, 0, 0, 0),
    (torch.float32, 4, 4096, 0, 0, 2), (torch.float32, 4, 4096, 2, 0, 0),
    (torch.float32, 9, 4096, 0, 0, 0),
])
def test_wire_passes_stage_only_16_byte_rows(calls, dtype, n, part, extra,
                                             offset, want):
    """The wire stack (row stride d + ``extra``, stored ``offset`` elements
    into its buffer, n partitions of ``part``) asks for the staged body
    (vec 2) in #7's norm, update and dot passes and #8's one pass exactly
    up to 8 peers where every row start is 16-byte aligned; else the
    16-byte loads (1) where a row start is on a group of 4 elements, else
    column by column (0). A float32 stack (#1 and #5) takes the same rule,
    under which a group of 4 is 16 bytes."""
    d = n * part
    g = _wire_stack(n, d, d + extra, offset, dtype)
    wire = dtype != torch.float32
    k = kc._Stack(g, n, torch.ones((n, n)) if wire else None)
    assert k.stage == (want == 2)
    z, v0 = torch.zeros((n, part)), torch.zeros((n, part))
    kc._fused_clip(k, [1.0] * 3, z, 1.0, None, v0)
    kc._mean_digest(k, z, None)
    prefix = "wire_" if wire else "cc_"
    passes = [(name[len(prefix):], _pass_args(name, args)[2])
              for name, args in calls if name.startswith(prefix)
              and not name.startswith("cc_finish")]
    assert passes == ([("sq_pass", want)] + [("update", want)] * 3
                      + [("dot_pass", want), ("mean_dot_pass", want)])
    assert all(name.startswith("cc_finish") for name, _ in calls
               if not name.startswith(prefix))
    calls.clear()
    k.sq_pass(torch.zeros(n * part + 1)[1:].view(n, part), k.partials())
    assert _pass_args(*calls[-1])[2] == 0


# ---------------------------------------------------------------------------
# #5 and #8: verified:mean in one read of the stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [1, 4, 8, 9, 16, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
def test_mean_digest_is_one_pass(calls, dtype, n, aligned):
    """verified:mean (#5 over float32, #8 over int8/bf16 payloads) launches
    one pass, which writes v and the digests' partials against it, then the
    finish that sums those partials, and nothing else. The pass takes the
    staged body exactly where ``_Stack.stage`` allows it (up to 8 peers,
    every row start on 16 bytes); a stack stored 8 bytes off 16 takes the
    4-element loads where a group of 4 elements is 4 or 8 bytes (int8,
    bf16; up to 8 peers), else column by column."""
    n_parts, part = 2, 4096 + 16
    d = n_parts * part
    es = torch.empty((), dtype=dtype).element_size()
    offset = 0 if aligned else 8 // es
    g = _wire_stack(n, d, d, offset, dtype)
    wire = dtype != torch.float32
    k = kc._Stack(g, n_parts, torch.ones((n_parts, n)) if wire else None)
    assert k.stage == (aligned and n <= 8)
    if k.stage:
        want = kc.STAGED
    else:
        want = int(n <= 8 and offset * es % (kc.GROUP * es) == 0)
    z, w = torch.zeros((n_parts, part)), torch.ones(n)
    v, s, norms = kc._mean_digest(k, z, w)
    prefix = "wire_" if wire else "cc_"
    assert [name for name, _ in calls] == [prefix + "mean_dot_pass",
                                           "cc_finish_digests"]
    (_, args), (_, fargs) = calls
    geo = kc.chunk_grid(n, d, n_parts)
    cs, C, vec, own = _pass_args(prefix + "mean_dot_pass", args)
    assert (cs, C, vec) == (geo.cs, geo.C, want)
    assert own[:3] == (w.data_ptr(), v.data_ptr(), z.data_ptr())
    # the finish sums the (P, n, C) partials the pass wrote into (s, norms)
    assert fargs[:5] == (own[3], own[4], n_parts, C, n)
    assert fargs[5:7] == (s.data_ptr(), norms.data_ptr())
    assert v.shape == (n_parts, part) and s.shape == norms.shape == (
        n_parts, n)
