"""The launch path's peer-group collectives (``repro_torch.launch.
collectives``) against numpy: ``LocalGroup``'s all_to_all, all_gather
(stacked and tiled), psum and pmax, with and without index groups; a rank
that raises ends every rank with that error; a rank that never arrives
times out instead of hanging; the kernels' launch counts stay exact under
concurrent ranks; and ``DistGroup`` over gloo (4 processes, spawned inside
one subprocess, with a file rendezvous) gives ``LocalGroup``'s results.

No process or process group starts inside the pytest process, and every
rendezvous here has a timeout of a few seconds."""
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import centered_clip as kc
from repro_torch.launch import collectives as coll

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
TIMEOUT = 10.0
GROUPS = [[0, 1], [2, 3]]
STRIDED = [[0, 2], [1, 3]]


def _inputs(rank):
    """Rank ``rank``'s deterministic inputs, the same in every process."""
    rng = np.random.default_rng(100 + rank)
    return {"x": rng.standard_normal((N * 3, 5)).astype(np.float32),
            "s": rng.standard_normal((N,)).astype(np.float32),
            "b": rng.standard_normal((2, 3)).astype(np.float32)}


def _collectives(group):
    """Every collective of the interface on this rank's inputs -> numpy."""
    inp = {k: torch.from_numpy(v) for k, v in _inputs(group.rank).items()}
    out = {
        "a2a": group.all_to_all(inp["x"]),
        "a2a_scalar": group.all_to_all(inp["s"]),
        "gather": group.all_gather(inp["b"]),
        "gather_tiled": group.all_gather(inp["b"], tiled=True),
        "psum": group.psum(inp["b"]),
        "pmax": group.pmax(inp["b"]),
    }
    for tag, groups in (("grp", GROUPS), ("strided", STRIDED)):
        out[f"a2a_{tag}"] = group.all_to_all(inp["x"][:6], groups)
        out[f"gather_{tag}"] = group.all_gather(inp["b"], groups)
        out[f"gather_tiled_{tag}"] = group.all_gather(inp["b"], groups,
                                                      tiled=True)
        out[f"psum_{tag}"] = group.psum(inp["b"], groups)
    group.barrier()
    return {k: v.numpy() for k, v in out.items()}


def _expected(rank):
    """What jax.lax's collectives give peer ``rank`` (numpy)."""
    ins = [_inputs(r) for r in range(N)]
    out = {
        "a2a": np.concatenate([ins[m]["x"][rank * 3:(rank + 1) * 3]
                               for m in range(N)]),
        "a2a_scalar": np.asarray([ins[m]["s"][rank] for m in range(N)]),
        "gather": np.stack([i["b"] for i in ins]),
        "gather_tiled": np.concatenate([i["b"] for i in ins]),
        "psum": sum(i["b"] for i in ins),
        "pmax": np.max(np.stack([i["b"] for i in ins]), axis=0),
    }
    for tag, groups in (("grp", GROUPS), ("strided", STRIDED)):
        members = next(g for g in groups if rank in g)
        me = members.index(rank)
        out[f"a2a_{tag}"] = np.concatenate(
            [ins[m]["x"][me * 3:(me + 1) * 3] for m in members])
        out[f"gather_{tag}"] = np.stack([ins[m]["b"] for m in members])
        out[f"gather_tiled_{tag}"] = np.concatenate(
            [ins[m]["b"] for m in members])
        out[f"psum_{tag}"] = sum(ins[m]["b"] for m in members)
    return out


def test_local_group_collectives_match_numpy():
    results = coll.run_local(N, _collectives, timeout=TIMEOUT)
    for rank, got in enumerate(results):
        want = _expected(rank)
        assert sorted(got) == sorted(want)
        for k in want:
            # sums of four float32 values: added in member order, as numpy
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{rank} {k}")
            if not k.startswith("psum"):
                np.testing.assert_array_equal(got[k], want[k])


def test_psum_adds_in_member_order_bit_for_bit():
    """The sum is taken in member order, so its bits repeat run to run and
    equal a left fold over the members."""
    vals = [torch.tensor([1e8, 1.0, -1e8], dtype=torch.float32) * (r + 1)
            + torch.tensor([0.5 ** (r + 3)] * 3) for r in range(N)]
    fold = vals[0].clone()
    for v in vals[1:]:
        fold = fold + v
    for _ in range(2):
        got = coll.run_local(N, lambda g: g.psum(vals[g.rank]),
                             timeout=TIMEOUT)
        assert all(torch.equal(x, fold) for x in got)


def test_bad_groups_raise():
    with pytest.raises(ValueError, match="partition"):
        coll.run_local(N, lambda g: g.psum(torch.ones(2), [[0, 1], [2]]),
                       timeout=TIMEOUT)
    with pytest.raises(ValueError, match="multiple of the group size"):
        coll.run_local(N, lambda g: g.all_to_all(torch.ones(6)),
                       timeout=TIMEOUT)


def test_a_failing_rank_ends_every_rank_with_its_error():
    seen = [None] * N

    def fn(group):
        try:
            group.barrier()
            if group.rank == 2:
                raise KeyError("rank 2 fails")
            group.psum(torch.ones(3))
        except BaseException as err:
            seen[group.rank] = type(err)
            raise

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank 2 fails"):
        coll.run_local(N, fn, timeout=TIMEOUT)
    assert time.perf_counter() - t0 < TIMEOUT / 2  # aborted, not timed out
    assert seen[2] is KeyError
    assert all(seen[r] is threading.BrokenBarrierError for r in (0, 1, 3))
    assert not [t for t in threading.enumerate() if t.name.startswith("rank")]


def test_a_missing_rank_times_out_instead_of_hanging():
    def fn(group):
        if group.rank == 3:
            return None  # never arrives at the collective
        return group.psum(torch.ones(2))

    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        coll.run_local(N, fn, timeout=1.0)
    assert time.perf_counter() - t0 < 8.0


def test_rank_threads_bound_cpu_threads_and_leave_the_caller_alone():
    before = torch.get_num_threads()
    got = coll.run_local(N, lambda g: torch.get_num_threads(),
                         timeout=TIMEOUT, cpu_threads=1)
    assert got == [1] * N
    assert torch.get_num_threads() == before


def test_launch_counts_are_exact_under_concurrent_ranks():
    """Every wrapper counts through one locked helper: 16 threads (more
    than the cores) x 5000 increments of two kernels' counts, with the
    interpreter switching threads every microsecond, lose none."""
    before = dict(kc.LAUNCHES)
    threads, per = 16, 5000

    def hammer():
        for _ in range(per):
            kc._count("centered_clip_fused")
            kc._count("verify_tables")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=hammer) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    for name in ("centered_clip_fused", "verify_tables"):
        assert kc.LAUNCHES[name] - before[name] == threads * per
    kc.LAUNCHES.update(before)


def test_concurrent_first_loads_build_a_library_once(monkeypatch):
    """The ranks' first launches race to ``build.load``: one builds and
    loads, the others wait and get the same library."""
    calls = {"compile": 0}

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            object.__setattr__(self, name, fn)
            return fn

    def compile_all(names):
        calls["compile"] += 1
        time.sleep(0.2)  # long enough for every thread to arrive
        return {n: f"/nonexistent/lib{n}.so" for n in names}

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "compile_all", compile_all)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    libs = [None] * 6

    def load(i):
        libs[i] = build.load("centered_clip")

    workers = [threading.Thread(target=load, args=(i,)) for i in range(6)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
    assert not any(w.is_alive() for w in workers)
    assert calls["compile"] == 1
    assert all(lib is libs[0] for lib in libs)


RANK_CODE = r"""
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_collectives as t
from repro_torch.launch import collectives as coll
rank = int(sys.argv[1])
group = coll.init_dist({init!r}, t.N, rank, device="cpu", timeout=60)
out = t._collectives(group)
np.savez({out!r} + f"/rank{{rank}}.npz", **out)
import torch.distributed as dist
dist.destroy_process_group()
"""

LAUNCH_CODE = r"""
import subprocess, sys
procs = [subprocess.Popen([sys.executable, "-c", {code!r}, str(r)])
         for r in range({n})]
try:
    codes = [p.wait(timeout=120) for p in procs]
finally:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
sys.exit(max(abs(c) for c in codes))
"""


def test_dist_group_over_gloo_gives_the_local_groups_results(tmp_path):
    code = RANK_CODE.format(tests=str(ROOT / "tests"),
                            init=f"file://{tmp_path}/rendezvous",
                            out=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-c", LAUNCH_CODE.format(code=code, n=N)],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    local = coll.run_local(N, _collectives, timeout=TIMEOUT)
    for rank in range(N):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert sorted(got) == sorted(local[rank])
        for k, v in local[rank].items():
            # gloo's all_reduce may add in another order than member order
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{rank} {k}")
            if not k.startswith("psum"):
                np.testing.assert_array_equal(got[k], v)


def test_rank_threads_select_an_indexed_card(monkeypatch):
    """``torch.cuda.set_device`` refuses a device without an index
    ("cuda"): each rank thread selects the caller's current card by its
    index."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: chosen.append(torch.device(dev)))
    coll.run_local(N, lambda g: g.barrier(), device="cuda", timeout=TIMEOUT)
    assert chosen == [torch.device("cuda", 0)] * N


def test_init_dist_selects_nccl_and_the_ranks_card(monkeypatch):
    """On CUDA each process uses NCCL and makes its own card current before
    the process group starts (NCCL's barrier runs on the current card)."""
    import torch.distributed as dist

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(dist, "get_world_size", lambda: 8)
    monkeypatch.setattr(dist, "get_rank", lambda: 6)
    group = coll.init_dist("file:///nowhere", 8, 6, device="cuda")
    assert calls["backend"] == "nccl" and calls["card"] == 2
    assert calls["rank"] == 6 and calls["world_size"] == 8
    assert (group.rank, group.n) == (6, 8)
    calls.clear()
    coll.init_dist("file:///nowhere", 8, 6, device="cpu")
    assert calls["backend"] == "gloo" and "card" not in calls


def test_init_dist_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no device argument init_dist runs on the card: on a machine
    without one it raises before any process group starts, and never
    chooses gloo on its own."""
    import torch.distributed as dist

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: started.append(backend))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coll.init_dist("file:///nowhere", 4, 0)
    assert started == []
