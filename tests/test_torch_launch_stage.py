"""The launch path's stage 2 on the CPU: the port's
``launch.steps.aggregation_stage`` over ``LocalGroup(4)`` against the JAX
package's under ``shard_map`` on a ``(4,)`` "peers" mesh of fake CPU
devices, on the same numpy inputs.

The grid: butterfly_clip with a fixed budget and with the adaptive budget
(warm-started), verified:mean, verified:trimmed_mean,
compressed:butterfly_clip (int8) and compressed:verified:mean (bf16), each
with groups in {None, 2} and audit_k in {None, 1}; the lying owner
(agg_attack_scale) under verified:mean and butterfly_clip; and the
non-verifiable mean. The JAX side runs its kernel dispatch
(``use_pallas=True``, interpret mode), the one the port takes on the card.

Aggregates, tables, checksums and audit mismatches within rtol = atol =
1e-5 (the kernels' tolerance: the two frameworks sum in different orders,
and the unit directions z agree to float32 rounding); clip_iters,
audit_target, the Delta_max votes and which audit mismatches are nonzero
exactly. Every rank's aggregate is compared, not only one.

The JAX reference runs once for the whole grid, in a subprocess with its
own ``XLA_FLAGS`` (fake devices must be set before jax is imported), as
tests/test_aggregators.py does; nothing here starts a process group."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.aggregators import resolve_spec
from repro_torch.launch import collectives as coll
from repro_torch.launch import steps as tsteps

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D = 4, 1003  # part 251 (flat) / 502 (2 groups): ragged
SEED = 7932 + 15851  # a step's public seed: audit target 3, column 3
DELTA_MAX = 5.0
TAU, ITERS = 1.0, 5
TOL = dict(rtol=1e-5, atol=1e-5)

SPECS = {
    "fixed": "butterfly_clip",
    "adaptive": "butterfly_clip:adaptive_tol=0.001,n_iters=40",
    "vmean": "verified:mean",
    "vtrim": "verified:trimmed_mean:trim_ratio=0.25",
    "cfixed": "compressed:butterfly_clip",
    "cvmean": "compressed:verified:mean:codec=bf16",
}


def _cases():
    cases = []
    for tag, spec in SPECS.items():
        for groups in (None, 2):
            for audit_k in (None, 1):
                cases.append(dict(name=f"{tag}-g{groups}-k{audit_k}",
                                  spec=spec, groups=groups, audit_k=audit_k,
                                  warm=tag == "adaptive", attack=None))
    for tag in ("vmean", "fixed"):
        for groups in (None, 2):
            cases.append(dict(name=f"{tag}-lying-owner-g{groups}",
                              spec=SPECS[tag], groups=groups, audit_k=None,
                              warm=False, attack=5.0))
    cases.append(dict(name="mean", spec="mean", groups=None, audit_k=None,
                      warm=True, attack=None))
    return cases


CASES = _cases()


def _inputs():
    rng = np.random.default_rng(2024)
    G = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    G[3] *= -10.0  # the attacker's payload: an outlier
    G[1, :50] = 0.0
    return {
        "G": G,
        "w": np.asarray([1.0, 1.0, 1.0, 1.0], np.float32),
        "v0": (rng.standard_normal(D) * 0.02).astype(np.float32),
        "byz": np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
        "audit_grad": np.asarray([0.0, 0.0, 0.0, 3.5], np.float32),
    }


JAX_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_threefry_partitionable", True)
from jax.sharding import PartitionSpec as P
from repro.core.aggregators import resolve_spec
from repro.launch import steps as lsteps

cases, inp_path, out_path, seed, dmax, tau, iters = json.loads(sys.argv[1])
inp = dict(np.load(inp_path))
mesh = jax.make_mesh((4,), ("peers",))
out = {}
for c in cases:
    spec = resolve_spec(c["spec"]).with_defaults(
        tau=tau, n_iters=iters, max_iters=iters)
    hier = c["groups"] is not None and spec.verifiable

    def f(gv, w, v0, byz, ag):
        full, verif = lsteps.aggregation_stage(
            gv.reshape(-1), ("peers",), 4, spec, w, seed, use_pallas=True,
            delta_max=dmax, v0_full=v0 if c["warm"] else None,
            groups=c["groups"], audit_k=c["audit_k"],
            agg_attack_scale=c["attack"], byz_mask=byz,
            audit_grad=ag.reshape(()) if spec.verifiable else None)
        return full[None], verif

    tbl = P("peers", None) if hier else P(None, None)
    verif_specs = {k: P("peers") for k in (
        "checksum", "votes", "clip_iters", "audit_target",
        "audit_grad_mismatch", "audit_agg_mismatch")}
    verif_specs["s_table"] = verif_specs["norm_table"] = tbl
    fn = lsteps._shard_map(
        f, mesh=mesh, in_specs=(P("peers"), P(), P(), P(), P("peers")),
        out_specs=(P("peers"), verif_specs), axis_names={"peers"})
    full, verif = jax.jit(fn)(inp["G"], inp["w"], inp["v0"], inp["byz"],
                              inp["audit_grad"])
    out[c["name"] + "/full"] = np.asarray(full)
    for k, v in verif.items():
        out[c["name"] + "/" + k] = np.asarray(v)
np.savez(out_path, **out)
print("JAX_STAGE_OK", len(cases))
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage")
    np.savez(tmp / "inputs.npz", **_inputs())
    args = json.dumps([CASES, str(tmp / "inputs.npz"), str(tmp / "ref.npz"),
                       SEED, DELTA_MAX, TAU, ITERS])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", JAX_CODE, args], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + "\n---\n" + r.stderr[-4000:]
    assert "JAX_STAGE_OK" in r.stdout
    return dict(np.load(tmp / "ref.npz"))


def _port(case):
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    spec = resolve_spec(case["spec"]).with_defaults(
        tau=TAU, n_iters=ITERS, max_iters=ITERS)
    hier = case["groups"] is not None and spec.verifiable

    def rank(group):
        r = group.rank
        full, verif = tsteps.aggregation_stage(
            inp["G"][r], group, N, spec, inp["w"], SEED, delta_max=DELTA_MAX,
            v0_full=inp["v0"] if case["warm"] else None,
            groups=case["groups"], audit_k=case["audit_k"],
            agg_attack_scale=case["attack"], byz_mask=inp["byz"],
            audit_grad=inp["audit_grad"][r] if spec.verifiable else None)
        return full, tsteps.global_verif(group, verif, hier)

    results = coll.run_local(N, rank, timeout=30.0)
    full = torch.stack([f for f, _ in results])
    verif = results[0][1]
    for _, v in results[1:]:  # every rank holds the same global view
        for k in verif:
            assert torch.equal(v[k], verif[k]), k
    return full, verif


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_stage_matches_jax_under_shard_map(jax_ref, case):
    full, verif = _port(case)
    ref = {k.split("/", 1)[1]: v for k, v in jax_ref.items()
           if k.split("/", 1)[0] == case["name"]}
    assert full.shape == ref["full"].shape == (N, D)
    np.testing.assert_allclose(full.numpy(), ref["full"], **TOL)
    assert sorted(verif) == sorted(k for k in ref if k != "full")
    for k in ("s_table", "norm_table", "checksum", "audit_grad_mismatch",
              "audit_agg_mismatch"):
        assert verif[k].shape == ref[k].shape, k
        np.testing.assert_allclose(verif[k].numpy(), ref[k], err_msg=k,
                                   **TOL)
    for k in ("clip_iters", "audit_target", "votes"):
        np.testing.assert_array_equal(verif[k].numpy(), ref[k], err_msg=k)
    for k in ("audit_grad_mismatch", "audit_agg_mismatch"):
        np.testing.assert_array_equal(verif[k].numpy() != 0, ref[k] != 0,
                                      err_msg=k)


def test_grid_exercises_every_branch(jax_ref):
    """The grid is not vacuous: the lying owner is caught by the audit,
    the sampled mode zeroes table columns, the adaptive budget stops
    early, and Delta_max votes fire on the outlier."""
    r = lambda name, k: jax_ref[f"{name}/{k}"]  # noqa: E731
    assert r("vmean-lying-owner-gNone", "audit_agg_mismatch")[3] > 0
    assert r("fixed-lying-owner-g2", "audit_agg_mismatch").max() > 0
    assert (r("fixed-gNone-k1", "s_table") == 0).sum() >= N * (N - 1)
    assert r("adaptive-gNone-kNone", "clip_iters").max() < 40
    assert r("fixed-gNone-kNone", "votes").max() > 0
    assert r("fixed-gNone-kNone", "audit_grad_mismatch")[3] == 3.5
