"""The launch path as a whole on the CPU: ``repro_torch.launch.train`` (its
``make_btard_train_step`` / ``make_btard_scan_train_step`` and the host ban
policy, over ``LocalGroup(4)``) against a reference composed from the JAX
package's own pieces, since its whole ``shard_map`` train step does not run
under this jax: per-peer ``value_and_grad(model.loss_fn)`` over each
peer's rows of the global batch without ``shard_map``, the flatten,
``device_attack`` and ``aggregation_stage`` under ``shard_map`` on 4 fake
devices, ``sgd`` (momentum 0.9, Nesterov) with ``apply_updates``, and
train.py's host ban policy (``checksum_offender_peers``, the audit
offenders, ``HostMembership``).

A reduced ALBERT (``reduce_config``), 4 peers, sign-flip attacker 3, tau 1,
5 clip iterations, 4 steps from the same weights (the JAX init carried over
with ``models.convert``-style leaves): bans and ban steps equal, every
step's loss within 1e-4 relative (float32 gradients summed in another order
by the two frameworks, through 4 optimizer steps), the slots' lifecycle
equal. Cases: butterfly_clip and verified:mean one step per call; the
chunked path (warm-started butterfly_clip, 2 rounds per chunk) with device
data and with ``--host-data``; butterfly_clip under churn (slot 1 leaves
at step 1 and a fresh identity joins it at step 2 on probation); the
baseline defense (the gradient of the global batch's loss, no bans); and
butterfly_clip on a reduced Qwen3-1.7B (``--arch qwen3-1.7b``: RoPE,
QK-norm, GQA, tied embeddings).

Also: the CLI on ``--device cpu`` prints the JAX launcher's lines and its
SUMMARY; ``--backend dist`` over gloo (2 processes inside one subprocess,
file rendezvous) prints the local backend's numbers; every flag of a later
item raises ``NotImplementedError`` naming it; without a CUDA device the
launcher refuses to run unless ``--device cpu`` is asked for. Crash
recovery: on the chunked path a run halted at step 2 (``--checkpoint-dir
--halt-at``) and resumed (``--resume``) gives the uninterrupted run's
losses, bans, SUMMARY, state and ``--checkpoint`` file bit for bit, with
a churn event after the halt; the files load in the JAX package under its
launcher's example tree; misused flags exit as argparse errors, and a
checkpoint pair out of sync or off the chunking raises.

The JAX reference runs once for every case, in a subprocess with its own
``XLA_FLAGS``; nothing here starts a process group in the pytest process,
and every rank rendezvous has a timeout."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.flatten import tree_leaves, tree_unflatten
from repro_torch.core.prng import key as tkey
from repro_torch.launch import train as ttrain
from repro_torch.models.workload import lm_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "albert-large", "--reduced", "--device", "cpu",
        "--mesh", "4x1", "--steps", "4", "--seq", "16", "--batch", "8",
        "--attack", "sign_flip", "--byzantine", "3", "--tau", "1",
        "--clip-iters", "5", "--timeout", "120"]
CASES = {
    "fixed": ["--aggregator", "butterfly_clip"],
    "verified_mean": ["--aggregator", "verified:mean"],
    "chunk_device_data": ["--aggregator", "butterfly_clip:warm_start=true",
                          "--scan-steps", "2"],
    "chunk_host_data": ["--aggregator", "butterfly_clip:warm_start=true",
                        "--scan-steps", "2", "--host-data"],
    "churn": ["--aggregator", "butterfly_clip", "--churn",
              "leave@1:1,join@2:1", "--probation-steps", "1"],
    "baseline_mean": ["--defense", "mean"],
    "qwen3_fixed": ["--arch", "qwen3-1.7b", "--aggregator", "butterfly_clip"],
}


def _flag(argv, name, default=None):
    return argv[argv.index(name) + 1] if name in argv else default

JAX_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_threefry_partitionable", True)
from jax.sharding import PartitionSpec as P
from repro.core import butterfly as bf
from repro.core.sybil import HostMembership, parse_churn
from repro.data import TokenPipeline
from repro.launch import steps as lsteps
from repro.launch.train import resolve_cli_aggregator
from repro.models import get_model
from repro.optim import sgd
from repro.optim.optimizers import apply_updates

cases, out_path = json.loads(sys.argv[1])
N, STEPS, SEQ, BATCH, TAU, ITERS, LR = 4, 4, 16, 8, 1.0, 5, 3e-2
BYZ = [3]
out, setups = {}, {}
for arch in sorted({c[-1] for c in cases.values()}):
    model = get_model(arch, reduced=True)
    params0 = model.init_params(jax.random.key(0))
    out.update({f"{arch}/leaf{i}": np.asarray(l)
                for i, l in enumerate(jax.tree.leaves(params0))})
    setups[arch] = (params0, TokenPipeline(model.cfg.vocab_size, SEQ, BATCH),
                    jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True)))
mesh = jax.make_mesh((N,), ("peers",))
opt = sgd(LR, momentum=0.9, nesterov=True)
byz_mask = jnp.asarray([1.0 if i in BYZ else 0.0 for i in range(N)])

def baseline(name, churn, probation):
    # make_baseline_train_step: the gradient of the global batch's loss
    params, opt_state, losses = params0, opt.init(params0), []
    for step in range(STEPS):
        (loss, _), grads = grad_fn(params, pipe.batch(step))
        updates, opt_state = opt.update(grads, opt_state, params, step)
        params = apply_updates(params, updates)
        losses.append(float(loss))
    out[name + "/losses"] = np.asarray(losses, np.float64)
    out[name + "/banned"] = out[name + "/ban_steps"] = np.zeros(0, np.int64)
    out[name + "/lifecycle"] = np.full(N, 2, np.int64)


for name, (agg_text, n_scan, defense, churn, probation, arch) in cases.items():
    params0, pipe, grad_fn = setups[arch]
    if defense == "mean":
        baseline(name, churn, probation)
        continue
    spec = resolve_cli_aggregator(agg_text, False, None, len(BYZ))
    if not n_scan and "warm_start" in spec.definition.param_names:
        spec = spec.override(warm_start=False)  # no carry between calls
    spec = spec.with_defaults(tau=TAU, n_iters=ITERS, max_iters=ITERS,
                              adaptive_tol=None, warm_start=False)
    carry_v0 = spec.warm_startable and bool(spec.get("warm_start", False))

    def stage(g, seed, step, weights, v_prev):
        vec = g.reshape(-1)
        vec_honest = vec
        key = jax.random.fold_in(jax.random.key(seed), step)
        vec = lsteps.device_attack(vec, byz_mask, ("peers",), "sign_flip",
                                   key)
        probe = jnp.max(jnp.abs(vec - vec_honest))
        t_peer = jnp.mod(seed, N)
        audit_grad = jnp.where(jax.lax.axis_index("peers") == t_peer,
                               probe, 0.0)
        agg, verif = lsteps.aggregation_stage(
            vec, ("peers",), N, spec, weights, seed, use_pallas=False,
            delta_max=1e9, v0_full=v_prev if carry_v0 else None,
            byz_mask=byz_mask, audit_grad=audit_grad)
        verif["probe_mismatch"] = probe[None]
        return agg[None], verif

    vspecs = {k: P("peers") for k in (
        "checksum", "votes", "clip_iters", "audit_target",
        "audit_grad_mismatch", "audit_agg_mismatch", "probe_mismatch")}
    vspecs["s_table"] = vspecs["norm_table"] = P(None, None)
    stage_fn = jax.jit(lsteps._shard_map(
        stage, mesh=mesh, in_specs=(P("peers"), P(), P(), P(), P()),
        out_specs=(P("peers"), vspecs), axis_names={"peers"}))

    params, opt_state = params0, opt.init(params0)
    mem = HostMembership(N, probation_steps=probation,
                         events=parse_churn(churn) if churn else None)
    v_prev = jnp.zeros((sum(l.size for l in jax.tree.leaves(params0)),))
    losses, bans = [], {}

    def round_(step, weights):
        global params, opt_state, v_prev
        toks = pipe.batch(step)["tokens"]
        seed = jnp.int32(step * 7919 + 13)
        rows = [grad_fn(params, {"tokens": toks[i * 2:(i + 1) * 2]})
                for i in range(N)]
        loss = jnp.stack([r[0][0] for r in rows]).mean()
        leaves0 = jax.tree.leaves(rows[0][1])
        G = jnp.stack([lsteps._flatten_local(jax.tree.leaves(r[1]))
                       for r in rows])
        agg, verif = stage_fn(G, seed, jnp.int32(step), weights, v_prev)
        agg_leaves = lsteps._unflatten_local(jnp.asarray(np.asarray(agg)[0]),
                                             leaves0)
        agg_tree = jax.tree.unflatten(jax.tree.structure(rows[0][1]),
                                      agg_leaves)
        updates, opt_state = opt.update(agg_tree, opt_state, params, step)
        params = apply_updates(params, updates)
        v_prev = lsteps._flatten_local(agg_leaves)
        return float(loss), verif

    def policy(verifs, idxs):
        for i, s in enumerate(idxs):
            mem.observe_probe(np.asarray(verifs[i]["probe_mismatch"],
                                         np.float64), s)
        bad = set(int(b) for b in
                  bf.checksum_offender_peers(verifs[-1]["checksum"]))
        for k in ("audit_grad_mismatch", "audit_agg_mismatch"):
            a = np.max([np.asarray(v[k], np.float64) for v in verifs], 0)
            bad |= {int(i) for i in np.nonzero(a > 1e-5)[0]}
        mem.ban_slots(bad, idxs[-1])

    chunk = n_scan or 1
    for start in range(0, STEPS, chunk):
        idxs = list(range(start, min(start + chunk, STEPS)))
        for s in idxs:
            mem.apply_events(s)
        weights = jnp.asarray(mem.weights())
        verifs = []
        for s in idxs:
            loss, verif = round_(s, weights)
            losses.append(loss)
            verifs.append(verif)
        policy(verifs, idxs)
    out[name + "/losses"] = np.asarray(losses, np.float64)
    ids = sorted(mem.banned_identities)
    out[name + "/banned"] = np.asarray(ids, np.int64)
    out[name + "/ban_steps"] = np.asarray(
        [mem.banned_identities[i] for i in ids], np.int64)
    out[name + "/lifecycle"] = np.asarray(mem.lifecycle, np.int64)
np.savez(out_path, **out)
print("JAX_TRAIN_OK", len(cases))
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    cases = {name: (_flag(argv, "--aggregator", "butterfly_clip"),
                    int(_flag(argv, "--scan-steps", 0)),
                    _flag(argv, "--defense", "btard"), _flag(argv, "--churn"),
                    int(_flag(argv, "--probation-steps", 3)),
                    _arch(argv))
             for name, argv in CASES.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", JAX_CODE,
         json.dumps([cases, str(tmp / "ref.npz")])],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + "\n---\n" + r.stderr[-4000:]
    assert "JAX_TRAIN_OK" in r.stdout
    return dict(np.load(tmp / "ref.npz"))


def _arch(argv):
    """The case's ``--arch``: its own, which overrides BASE's."""
    return _flag(argv, "--arch", _flag(BASE, "--arch"))


def _jax_params(ref, arch="albert-large"):
    """The JAX init carried onto the port's parameter tree (same leaf
    order: dict keys sorted)."""
    template = lm_model(arch, reduced=True).init_params(tkey(0))
    n = len(tree_leaves(template))
    leaves = [torch.from_numpy(np.array(ref[f"{arch}/leaf{i}"]))
              for i in range(n)]
    assert [t.shape for t in leaves] == [t.shape for t in
                                         tree_leaves(template)]
    return tree_unflatten(template, leaves)


@pytest.mark.parametrize("case", sorted(CASES))
def test_launch_train_matches_composed_jax_reference(jax_ref, case, capsys):
    args = ttrain.build_parser().parse_args(BASE + CASES[case])
    rec = ttrain.run(args, params0=_jax_params(jax_ref, args.arch))
    losses = np.asarray(rec["losses"])
    want = jax_ref[case + "/losses"]
    assert losses.shape == want.shape == (4,)
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    banned = sorted(rec["ban_steps"])
    assert banned == jax_ref[case + "/banned"].tolist()
    assert [rec["ban_steps"][s] for s in banned] == \
        jax_ref[case + "/ban_steps"].tolist()
    assert rec["summary"]["lifecycle"] == \
        jax_ref[case + "/lifecycle"].tolist()
    out = capsys.readouterr().out
    if case != "baseline_mean":
        assert banned == [3] and "banned peers -> [3]" in out


def test_ban_steps_follow_the_audit_schedule(jax_ref):
    """The sign-flip attacker is first the audit target at step 2
    (seed = 7919 step + 13, target seed mod 4): one step per call bans it
    there, chunks of 2 at the chunk's last step."""
    assert jax_ref["fixed/ban_steps"].tolist() == [2]
    assert jax_ref["verified_mean/ban_steps"].tolist() == [2]
    assert jax_ref["chunk_host_data/ban_steps"].tolist() == [3]


def test_cli_prints_the_launchers_lines_and_summary(capsys):
    ttrain.main(BASE[:-2] + ["--timeout", "60", "--steps", "3",
                             "--aggregator", "verified:trimmed_mean"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=albert-large-smoke params=")
    assert "mesh={'data': 4, 'model': 1} peers=4 byz=[3]" in lines[0]
    assert "backend=local device=cpu" in lines[0]
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3 and all("loss=" in s and "checksum=" in s
                                   for s in steps)
    assert "banned peers -> [3]" in lines
    assert any(ln.startswith("done: 3 steps in ") for ln in lines)
    summary = json.loads(lines[-1].removeprefix("SUMMARY "))
    assert summary["banned_slots"] == [3] and summary["steps_done"] == 3
    assert summary["weights"] == [1.0, 1.0, 1.0, 0.0]
    assert np.isfinite(summary["final_loss"])


def test_cli_baseline_defense_runs(capsys):
    ttrain.main(BASE[:-2] + ["--timeout", "60", "--steps", "2",
                             "--defense", "mean"])
    out = capsys.readouterr().out
    assert "banned" not in out.replace("banned_", "")
    summary = json.loads(out.splitlines()[-1].removeprefix("SUMMARY "))
    assert summary["banned_slots"] == [] and np.isfinite(
        summary["final_loss"])


@pytest.mark.parametrize("aggregator", ["krum", "geometric_median",
                                        "centered_clip"])
def test_cli_full_vector_baselines_run(capsys, aggregator):
    """The §4.1 full-vector baselines on the launch path: every rank
    all_gathers the (n, d) stack and applies the spec, with no tables and
    no bans; the sign-flip attacker's gradient stays out of Krum's pick
    and the loss stays finite."""
    ttrain.main(BASE[:-2] + ["--timeout", "60", "--steps", "2",
                             "--aggregator", aggregator])
    out = capsys.readouterr().out
    summary = json.loads(out.splitlines()[-1].removeprefix("SUMMARY "))
    assert summary["banned_slots"] == [] and np.isfinite(
        summary["final_loss"])
    assert summary["steps_done"] == 2


DIST_CODE = r"""
import subprocess, sys
argv = sys.argv[1:]
procs = [subprocess.Popen(
    [sys.executable, "-m", "repro_torch.launch.train", *argv,
     "--backend", "dist", "--rank", str(r)],
    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for r in range(2)]
try:
    outs = [p.communicate(timeout=240) for p in procs]
finally:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
sys.stdout.write(outs[0][0])
sys.stderr.write(outs[0][1] + outs[1][1])
sys.exit(max(abs(p.returncode) for p in procs))
"""


def test_dist_backend_over_gloo_gives_the_local_backends_numbers(tmp_path,
                                                                  capsys):
    argv = BASE[:BASE.index("--mesh")] + [
        "--mesh", "2x1", "--steps", "3", "--seq", "16", "--batch", "4",
        "--attack", "sign_flip", "--byzantine", "1", "--tau", "1",
        "--clip-iters", "5", "--timeout", "120"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-c", DIST_CODE, *argv, "--dist-init",
         f"file://{tmp_path}/rendezvous"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + "\n---\n" + r.stderr[-4000:]
    ttrain.main(argv)
    local = capsys.readouterr().out.splitlines()
    dist = r.stdout.splitlines()
    assert "backend=dist" in dist[0] and "backend=local" in local[0]
    # two ranks: sums of two terms and gathers are exact, so every printed
    # number is the same
    keep = lambda lines: [ln for ln in lines  # noqa: E731
                          if not ln.startswith(("arch=", "done:"))]
    assert keep(dist) == keep(local)
    assert any(ln.startswith("step ") for ln in keep(local))


@pytest.mark.parametrize("extra, item", [
    (["--mesh", "4x2"], "item 14"),
    (["--mesh", "2x2x1"], "item 14"),
    (["--seq-parallel"], "item 14"),
    (["--mesh", "2x2"], "item 14"),
])
def test_flags_of_later_items_raise_naming_the_item(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(BASE + extra)


def test_launcher_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(argv + ["--steps", "1"])


CHUNKED = BASE[:BASE.index("--steps")] + [
    "--steps", "4", "--seq", "16", "--batch", "8", "--attack", "sign_flip",
    "--byzantine", "3", "--tau", "1", "--clip-iters", "5", "--timeout", "120",
    "--scan-steps", "2", "--aggregator", "butterfly_clip:warm_start=true",
    "--churn", "leave@2:3,join@3:3", "--probation-steps", "1"]


def _run(argv):
    return ttrain.run(ttrain.build_parser().parse_args(argv))


def test_halt_then_resume_equals_the_uninterrupted_run_bitwise(tmp_path,
                                                               capsys):
    """Leg A runs 4 steps and writes ``--checkpoint``; B halts at step 2
    with its pair in D; C resumes from D. The churn (slot 3 leaves at step
    2, a fresh identity joins at 3 and is banned from probation) falls
    after the halt, and the warm start carries the restored aggregate."""
    d = tmp_path / "D"
    a = _run(CHUNKED + ["--checkpoint", str(tmp_path / "a.msgpack")])
    out_a = capsys.readouterr().out
    b = _run(CHUNKED + ["--checkpoint-dir", str(d), "--halt-at", "2"])
    out_b = capsys.readouterr().out.splitlines()
    assert b["halted"] == 2 and b["losses"] == a["losses"][:2]
    assert out_b[-2] == ("halt requested at step 2: checkpointed step 2, "
                         "exiting (resume with --resume)")
    assert json.loads(out_b[-1].removeprefix("SUMMARY "))["steps_done"] == 2
    assert sorted(p.name for p in d.iterdir()) == ["membership.msgpack",
                                                   "state.msgpack"]
    c = _run(CHUNKED + ["--checkpoint-dir", str(d), "--resume",
                        "--checkpoint", str(tmp_path / "c.msgpack")])
    out_c = capsys.readouterr().out
    assert "resumed at step 2 (banned=[], arch=albert-large)" in out_c
    assert c["losses"] == a["losses"][2:]
    assert c["clip_iters"] == a["clip_iters"][2:]
    assert c["summary"] == a["summary"] and c["ban_steps"] == a["ban_steps"]
    assert a["summary"]["banned_identities"] == [4]  # the rejoin, at step 2
    assert out_c.splitlines()[-2] == out_a.splitlines()[-2]  # SUMMARY
    for name in ("opt", "v_prev"):
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a["state"][name]), tree_leaves(c["state"][name])))
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["state"]["params"]), tree_leaves(c["state"]["params"])))
    assert (tmp_path / "a.msgpack").read_bytes() == \
        (tmp_path / "c.msgpack").read_bytes()


def test_launcher_files_load_in_the_jax_package(tmp_path):
    """params, opt and membership under the JAX launcher's own example
    trees, bit for bit; the warm-start carry (float32 leaves here, the
    params' dtypes there) by value."""
    import jax

    from repro.checkpoint import load_checkpoint as jload
    from repro.core.sybil import HostMembership as JMembership
    from repro.models import get_model
    from repro.optim import sgd as jsgd

    d = tmp_path / "D"
    rec = _run(CHUNKED + ["--checkpoint-dir", str(d), "--halt-at", "2"])
    jparams = get_model("albert-large", reduced=True).init_params(
        jax.random.key(0))
    example = {"params": jparams,
               "opt": jsgd(3e-2, momentum=0.9, nesterov=True).init(jparams),
               "v_prev": jax.tree.map(np.zeros_like, jparams)}
    state, step, meta = jload(str(d / "state.msgpack"), example)
    assert step == 2 and meta == {
        "arch": "albert-large", "aggregator": "butterfly_clip:warm_start=True"}
    port = rec["state"]
    got = [np.asarray(x) for x in jax.tree.leaves(state["params"])]
    want = [x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
            else x.numpy() for x in tree_leaves(port["params"])]
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    m = np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree.leaves(state["opt"]["m"])])
    assert m.dtype == np.float32 and m.tobytes() == port["opt"]["m"].numpy(
    ).tobytes()
    v = np.concatenate([np.asarray(x, np.float32).reshape(-1)
                        for x in jax.tree.leaves(state["v_prev"])])
    np.testing.assert_allclose(v, port["v_prev"].numpy(), rtol=1e-2,
                               atol=1e-6)
    mem_tree, mem_step, _ = jload(str(d / "membership.msgpack"))
    assert mem_step == 2
    jmem = JMembership(4).restore_tree(mem_tree)
    summary = dict(rec["summary"])
    for k in ("byzantine", "final_loss", "steps_done"):
        summary.pop(k)
    assert jmem.summary() == summary


@pytest.mark.parametrize("extra, match", [
    (["--checkpoint-dir", "ck"], "require --scan-steps"),
    (["--resume"], "require --scan-steps"),
    (["--scan-steps", "2", "--resume"], "requires it"),
    (["--scan-steps", "2", "--halt-at", "2"], "requires --checkpoint-dir"),
], ids=["dir_without_scan", "resume_without_scan", "resume_without_dir",
        "halt_without_dir"])
def test_checkpoint_flags_misused_exit_as_argparse_errors(extra, match,
                                                          capsys):
    with pytest.raises(SystemExit) as err:
        ttrain.main(BASE + extra)
    assert err.value.code == 2
    assert match in capsys.readouterr().err


def test_resume_refuses_a_pair_out_of_sync_or_off_the_chunking(tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    d = tmp_path / "D"
    _run(CHUNKED + ["--checkpoint-dir", str(d), "--halt-at", "2"])
    mem_path = str(d / "membership.msgpack")
    tree, _, _ = load_checkpoint(mem_path)
    save_checkpoint(mem_path, tree, step=4)  # a crash between the two saves
    with pytest.raises(RuntimeError, match="out of sync"):
        _run(CHUNKED + ["--checkpoint-dir", str(d), "--resume"])
    save_checkpoint(mem_path, tree, step=2)
    with pytest.raises(RuntimeError, match="not a multiple of --scan-steps"):
        _run([a if a != "2" or CHUNKED[i - 1] != "--scan-steps" else "3"
              for i, a in enumerate(CHUNKED)]
             + ["--checkpoint-dir", str(d), "--resume"])


def test_checkpoint_flag_on_the_one_step_path(tmp_path, capsys):
    """``--checkpoint`` needs no chunking: one step per call writes the
    final params and momentum (the JAX package's ``{"params", "opt"}``)."""
    from repro_torch.checkpoint import load_checkpoint

    path = str(tmp_path / "final.msgpack")
    rec = _run(BASE[:-2] + ["--timeout", "60", "--steps", "2",
                            "--checkpoint", path])
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"checkpoint saved: {path}"
    flat, step, meta = load_checkpoint(path)
    assert step == 2 and meta == {"arch": "albert-large"}
    params = [t for k, t in flat.items() if k.startswith("params/")]
    momentum = [t for k, t in flat.items() if k.startswith("opt/m/")]
    assert len(params) == len(momentum) == len(flat) // 2
    assert all(torch.equal(a, b) for a, b in zip(
        params, tree_leaves(rec["state"]["params"])))
    assert torch.equal(torch.cat([m.reshape(-1) for m in momentum]),
                       rec["state"]["opt"]["m"])
