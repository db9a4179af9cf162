"""The Python side of the CenteredClip kernels' pass geometry
(``repro_torch.kernels.centered_clip``), on the CPU: the logical chunk grid
is a function of (n, d, n_parts) alone, its chunk length a multiple of the
group width, its chunks tile each partition with none empty; and the
drivers hand every pass and its finish the same grid and buffers, read v0
in place, and ask for 16-byte loads exactly where every row start is
aligned. The kernels themselves run on the card only
(``tests/test_torch_cuda.py``); here a recording stand-in for the built
library takes their launches."""
import inspect
import math

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
    place), the dot pass, each finish on its pass's partials and C."""
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
    want_vec = int(geo.part % 4 == 0 and ld % 4 == 0)
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
    same."""
    n, n_parts, part = 4, 2, 4096
    g = _stack(n, n_parts * part, n_parts, offset, dtype)
    scales = None if dtype == torch.float32 else torch.ones((n_parts, n))
    k = kc._Stack(g, n_parts, scales)
    v = torch.zeros((n_parts, part))
    k.sq_pass(v, k.partials())
    assert _pass_args(*calls[-1])[2] == want
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
