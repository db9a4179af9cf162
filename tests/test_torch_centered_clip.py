"""The rest of core/centered_clip and kernel #12 on the CPU against the JAX
package: tau_schedule (equal arrays), centered_clip (scalar tau and the eq.
(5) schedule, a banned peer, a warm start, a bf16 stack), the adaptive and
to-tolerance loops (equal iteration counts, v within 1e-5), kernel #12's
plain version against the Pallas kernel in interpret mode over the
reference's own sweep shapes (tests/test_kernels.py), and the Fig. 9 sweep
at its own size (d = 1024) against the reference bench's problem and
calls.

Tolerances: float32 within rtol = atol = 1e-5 (the two frameworks sum in
different orders); a bf16 stack within 5e-2, the reference's own bf16
kernel tolerance; the Fig. 9 errors within 1e-4 relative, its stack
within 1e-6 (the port's threefry normal matches jax's to float32
rounding).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import centered_clip as tcc
from repro_torch.kernels import centered_clip as tkc
from repro_torch.kernels import ops as tops
from repro_torch.launch import clip_iters

# the module, not the function repro.core re-exports under the same name
jcc = importlib.import_module("repro.core.centered_clip")

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _stack(n=8, d=301, seed=0):
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    xs[-2:] *= 20.0  # two far peers: the clip matters
    return xs


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(jx):
    """A JAX bf16 array as a torch bf16 tensor with the same bits."""
    return torch.from_numpy(np.asarray(jx).view(np.int16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("delta, sigma, b0", [(0.0, 1.0, 0.0),
                                              (0.1, 1.0, 0.0),
                                              (0.3, 0.5, 2.0)])
def test_tau_schedule_equals_jax(delta, sigma, b0):
    t = tcc.tau_schedule(delta, sigma, 12, b0)
    j = jcc.tau_schedule(delta, sigma, 12, b0)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


WEIGHTS = {"all": None,
           "banned": np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)}


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("tau", ["scalar", "inf", "schedule"])
def test_centered_clip_matches_jax(tau, weights, warm):
    xs = _stack()
    taus = {"scalar": 1.5, "inf": np.inf,
            "schedule": jcc.tau_schedule(0.2, 3.0, 15)}[tau]
    w = WEIGHTS[weights]
    v0 = (np.random.default_rng(5).standard_normal(xs.shape[1])
          .astype(np.float32) if warm else None)
    j = jcc.centered_clip(jnp.asarray(xs), jnp.asarray(taus), n_iters=15,
                          weights=None if w is None else jnp.asarray(w),
                          v0=None if v0 is None else jnp.asarray(v0))
    before = tkc.LAUNCHES["centered_clip"]
    t = tcc.centered_clip(_t(xs), taus, n_iters=15,
                          weights=None if w is None else _t(w),
                          v0=None if v0 is None else _t(v0))
    assert tkc.LAUNCHES["centered_clip"] == before  # the CPU runs no kernel
    assert t.dtype == torch.float32 and t.shape == (xs.shape[1],)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_centered_clip_bf16_stack_matches_jax():
    """The iteration runs in f32 whatever the input dtype."""
    jx = jnp.asarray(_stack(seed=3)).astype(jnp.bfloat16)
    j = jcc.centered_clip(jx, 2.0, n_iters=10)
    t = tcc.centered_clip(_bf16(jx), 2.0, n_iters=10)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **BF16_TOL)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("tau, tol", [(4.0, 1e-3), (2.0, 1e-3),
                                      (np.inf, 1e-5)])
def test_adaptive_and_to_tol_iterations_equal_jax(tau, tol, warm):
    xs = _stack(seed=1)
    w = WEIGHTS["banned"]
    v0 = np.full(xs.shape[1], 0.3, np.float32) if warm else None
    jv, ji = jcc.centered_clip_adaptive(
        jnp.asarray(xs), tau, tol, 300, weights=jnp.asarray(w),
        v0=None if v0 is None else jnp.asarray(v0))
    tv, ti = tcc.centered_clip_adaptive(
        _t(xs), tau, tol, 300, weights=_t(w),
        v0=None if v0 is None else _t(v0))
    assert ti == int(ji)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    jv, ji = jcc.centered_clip_to_tol(
        jnp.asarray(xs), tau, eps=tol, max_iters=300,
        weights=jnp.asarray(w), v0=None if v0 is None else jnp.asarray(v0))
    tv, ti = tcc.centered_clip_to_tol(
        _t(xs), tau, eps=tol, max_iters=300, weights=_t(w),
        v0=None if v0 is None else _t(v0))
    assert ti == int(ji) and ti < 300
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_adaptive_at_tol_zero_is_the_fixed_budget_bitwise():
    """The shared freeze-by-select loop: tol = 0 runs the cap through the
    fixed budget's update rule."""
    xs = _t(_stack(seed=2))
    v, iters = tcc.centered_clip_adaptive(xs, 1.0, 0.0, 9)
    fixed = tcc.centered_clip_stacked(xs[None], 1.0, n_iters=9)[0]
    assert iters == 9 and torch.equal(v, fixed)


def test_to_tol_keeps_the_input_dtype():
    xs = _t(_stack(seed=4)).to(torch.bfloat16)
    v, iters = tcc.centered_clip_to_tol(xs, 1.0, eps=1e-2, max_iters=50)
    assert v.dtype == torch.bfloat16 and 0 < iters <= 50
    ref, _ = tcc.centered_clip_to_tol(xs.float(), 1.0, eps=1e-2,
                                      max_iters=50)
    np.testing.assert_allclose(v.float().numpy(), ref.numpy(), **BF16_TOL)


# the reference's own kernel sweep shapes (tests/test_kernels.py)
SHAPES = [(4, 128), (8, 257), (16, 1000), (32, 2048), (7, 999), (3, 130)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_kernel_12_matches_pallas_interpret(shape, dtype):
    """#12's plain version (the CPU path of ops.centered_clip_op) against
    the JAX centered_clip_op, whose Pallas kernel runs in interpret mode
    here, with a banned peer and a warm start."""
    n, d = shape
    rng = np.random.default_rng(n * d)
    xs = (rng.standard_normal((n, d)) * 2 + 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    w[n // 2] = 0.0
    v0 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    jx = jnp.asarray(xs).astype(dtype)
    j = jops.centered_clip_op(jx, 1.0, jnp.asarray(w), jnp.asarray(v0),
                              n_iters=12)
    tx = _t(xs) if dtype == "float32" else _bf16(jx)
    t = tops.centered_clip_op(tx, 1.0, _t(w), _t(v0), n_iters=12)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# Fig. 9 at its own size
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fig9():
    """The port's sweep on the port's problem, and the reference's numbers
    from the reference bench's own _problem and calls."""
    import jax

    from benchmarks.bench_fig9_clip_iters import _problem

    jxs, jhm = _problem()
    jdrift = 0.05 * jax.random.normal(jax.random.key(5), jxs.shape)
    xs, hm = clip_iters.problem(1024)
    xs_drift = xs + clip_iters.drift(xs.shape)
    lines = []
    port = clip_iters.sweep(xs, hm, xs_drift,
                            emit=lambda *a: lines.append(a))
    ref = {}
    for tau, label in clip_iters.TAUS:
        conv, iters = jcc.centered_clip_to_tol(jxs, tau, eps=1e-6,
                                               max_iters=3000)
        r = {"iters": int(iters), "err": float(jnp.linalg.norm(conv - jhm)),
             "budgets": {}, "warm": {}}
        for b in clip_iters.BUDGETS:
            r["budgets"][b] = float(jnp.linalg.norm(
                jcc.centered_clip(jxs, tau, n_iters=b) - jhm))
        _, r["iters_cold"] = jcc.centered_clip_to_tol(
            jxs + jdrift, tau, eps=1e-4, max_iters=3000)
        _, r["iters_warm"] = jcc.centered_clip_to_tol(
            jxs + jdrift, tau, eps=1e-4, max_iters=3000, v0=conv)
        for b in clip_iters.WARM_BUDGETS:
            r["warm"][b] = tuple(float(jnp.linalg.norm(
                jcc.centered_clip(jxs + jdrift, tau, n_iters=b, v0=v0) - jhm))
                for v0 in (None, conv))
        ref[label] = r
    return (jxs, jhm, jdrift), (xs, hm, xs_drift), port, ref, lines


def test_fig9_problem_equals_jax(fig9):
    (jxs, jhm, jdrift), (xs, hm, xs_drift), *_ = fig9
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(hm.numpy(), np.asarray(jhm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xs_drift.numpy(), np.asarray(jxs + jdrift),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("label", ["weaker", "stronger"])
def test_fig9_iterations_equal_and_errors_match_jax(fig9, label):
    *_, port, ref, _ = fig9
    p, r = port[label], ref[label]
    for k in ("iters", "iters_cold", "iters_warm"):
        assert p[k] == int(r[k]), k
    errs = [(p["err"], r["err"])]
    errs += [(p["budgets"][b], r["budgets"][b]) for b in clip_iters.BUDGETS]
    errs += [(a, b) for k in clip_iters.WARM_BUDGETS
             for a, b in zip(p["warm"][k], r["warm"][k])]
    for got, want in errs:
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_fig9_lines_are_the_reference_lines(fig9):
    """The reference bench's names and derived fields, plus the cap line;
    the to-tolerance run of the reference hits its 3000 cap too."""
    *_, port, ref, lines = fig9
    names = [name for name, _, _ in lines]
    for _, label in clip_iters.TAUS:
        base = f"fig9/tau_{label}"
        want = ([f"{base}/to_convergence"]
                + [f"{base}/iters={b}" for b in clip_iters.BUDGETS]
                + [f"{base}/warm_start"]
                + [f"{base}/warm_iters={b}" for b in clip_iters.WARM_BUDGETS]
                + [f"{base}/cap"])
        got = [n for n in names if n.startswith(base + "/")]
        assert got == want
    derived = dict((n, d) for n, _, d in lines)
    r = ref["weaker"]
    assert derived["fig9/tau_weaker/to_convergence"] == \
        f"iters={r['iters']};err={r['err']:.3f}"
    assert derived["fig9/tau_weaker/cap"].startswith("max_iters=3000;")
    assert port["weaker"]["capped"]["iters"] == (r["iters"] >= 3000)


def test_clip_iters_cli_runs_on_cpu(capsys):
    clip_iters.main(["--d", "64", "--device", "cpu", "--max-iters", "40"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("fig9/tau_weaker/to_convergence,0.0,iters=")
    assert out[-1].startswith("fig9/plain_cpu_clip_20it,")
    assert "max_iters=40" in [ln for ln in out if "/cap," in ln][0]
