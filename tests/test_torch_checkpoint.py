"""Checkpoint format v2 in the port (repro_torch.checkpoint) against the
JAX package's (repro.checkpoint).

The codec (``msgpack_lite``) writes ``msgpack.packb(obj,
use_bin_type=True)``'s bytes and reads what ``msgpack.unpackb`` reads, on
a derandomised hypothesis property over the subset the format uses, and
refuses ext types, reserved bytes, truncated and trailing input. For the
same tree the two packages write the same file, byte for byte, and each
loads the other's bit for bit (f32, bf16, int8, int32, uint32 keys,
bool). The reference's guarantees are mirrored: the version gate, a
missing array named, writable restores, atomic saves. A ``ProtocolState``
that JAX saved after 4 rounds resumes in the port: 4 more rounds give the
bans, ban reasons, lifecycle and identity ledgers of JAX's uninterrupted 8
exactly and every g_hat within 1e-5; the port's own 4 + save + load + 4
give its uninterrupted 8 bit for bit; a port-written state loads in JAX.
``HostMembership`` trees and a reduced ALBERT's params and momentum
(``sgd(momentum=0.9)``) cross both ways."""
import math

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.checkpoint.checkpoint import FORMAT_VERSION as J_FORMAT_VERSION
from repro.core import engine as jeng
from repro.core.protocol import AttackConfig as JAttack
from repro.core.sybil import HostMembership as JMembership
from repro.core.sybil import parse_churn as jparse_churn
from repro.models import get_model
from repro.optim import sgd as jsgd
from repro_torch.checkpoint import FORMAT_VERSION, msgpack_lite
from repro_torch.checkpoint import load_checkpoint as tload
from repro_torch.checkpoint import save_checkpoint as tsave
from repro_torch.checkpoint.checkpoint import tree_paths
from repro_torch.core import engine as teng
from repro_torch.core.prng import key as tkey
from repro_torch.core.protocol import AttackConfig as TAttack
from repro_torch.core.sybil import HostMembership as TMembership
from repro_torch.core.sybil import parse_churn as tparse_churn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.workload import lm_model

N, D = 6, 24


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------
_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text()
            | st.binary(max_size=300))
_objects = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, derandomize=True, database=None, deadline=None)
@given(obj=_objects)
def test_codec_is_msgpacks_bytes_both_ways(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("obj", [
    127, 128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32, 2**64 - 1,
    -32, -33, -128, -129, -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63,
    "a" * 31, "a" * 32, "a" * 255, "a" * 256, "a" * 2**16, "é中",
    b"", b"x" * 255, b"x" * 256, b"x" * 2**16, [0] * 15, [0] * 16,
    [0] * 2**16, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {str(i): i for i in range(2**16)},
    math.inf, -0.0, (1, (2, 3))], ids=lambda o: type(o).__name__)
def test_codec_every_width_boundary(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_reads_float32_and_nan_and_streams_buffers(tmp_path):
    for x in (1.5, -2.25, float("nan")):
        got = msgpack_lite.unpackb(msgpack.packb(x, use_single_float=True))
        assert np.float32(got).tobytes() == np.float32(x).tobytes()
    nan = msgpack.packb(float("nan"), use_bin_type=True)
    assert msgpack_lite.packb(float("nan")) == nan
    # a numpy array's memory goes out as bin without a bytes copy, and a
    # zero-copy read gives memoryview slices of the input
    arr = np.arange(70_000, dtype=np.float32)
    with open(tmp_path / "x", "wb") as f:
        msgpack_lite.dump({"a": memoryview(arr), "b": [1]}, f)
    data = (tmp_path / "x").read_bytes()
    assert data == msgpack.packb({"a": arr.tobytes(), "b": [1]},
                                 use_bin_type=True)
    view = msgpack_lite.unpackb(data)["a"]
    assert isinstance(view, memoryview)
    np.testing.assert_array_equal(np.frombuffer(view, np.float32), arr)


@pytest.mark.parametrize("data, match", [
    (msgpack.packb(msgpack.ExtType(1, b"ab")), "ext type"),
    (b"\xd4\x01\x00", "ext type"),
    (b"\xc1", "reserved"),
    (b"", "truncated"),
    (msgpack.packb({"a": b"x" * 300}, use_bin_type=True)[:-1], "truncated"),
    (msgpack.packb("abc")[:-1], "truncated"),
    (b"\xcd\x01", "truncated"),
    (msgpack.packb([1, 2]) + b"\x00", "trailing"),
], ids=["ext8", "fixext1", "reserved", "empty", "bin", "str", "uint16",
        "trailing"])
def test_codec_refuses_ext_and_truncated_input(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_lite.unpackb(data)


def test_codec_refuses_what_msgpack_cannot_hold():
    with pytest.raises(TypeError, match="serialize"):
        msgpack_lite.packb({1, 2})
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack_lite.packb(big)
    # a bin32 holds at most 2^32 - 1 bytes; the header refuses more
    with pytest.raises(ValueError, match="too large"):
        msgpack_lite._len_header(2**32, None, 0, (0xC4, 0xC5, 0xC6), "bytes")


# ---------------------------------------------------------------------------
# Files across the two packages
# ---------------------------------------------------------------------------
def _bf16_tensor(values):
    bits = np.asarray(jnp.asarray(values, jnp.bfloat16)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _dtype_trees():
    """The tree of the JAX package's test_dtype_fidelity_exact_bits, and
    the same values as the port's leaves."""
    bf16 = [1.5, -2.25, 3e-8, 65504.0]
    jtree = {
        "f32": np.linspace(-1, 1, 7, dtype=np.float32),
        "bf16": jnp.asarray(bf16, jnp.bfloat16),
        "int8": np.asarray([-128, -1, 0, 127], np.int8),
        "i32": np.asarray([-(2**31), 2**31 - 1], np.int32),
        "key": np.asarray(jax.random.PRNGKey(7)),
        "bool": np.asarray([True, False, True]),
    }
    ttree = {
        "f32": torch.from_numpy(jtree["f32"].copy()),
        "bf16": _bf16_tensor(bf16),
        "int8": torch.from_numpy(jtree["int8"].copy()),
        "i32": torch.from_numpy(jtree["i32"].copy()),
        "key": jtree["key"].copy(),  # uint32: a numpy leaf
        "bool": torch.from_numpy(jtree["bool"].copy()),
    }
    return jtree, ttree


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


def _bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def test_same_tree_same_file_and_bitwise_loads_both_ways(tmp_path):
    jtree, ttree = _dtype_trees()
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jsave(jpath, jtree, step=5, meta={"tag": "x"})
    tsave(tpath, ttree, step=5, meta={"tag": "x"})
    assert FORMAT_VERSION == J_FORMAT_VERSION == 2
    assert (tmp_path / "j.msgpack").read_bytes() == \
        (tmp_path / "t.msgpack").read_bytes()
    # JAX's file in the port, with and without an example tree
    got, step, meta = tload(jpath, ttree)
    assert step == 5 and meta == {"tag": "x"}
    flat, _, _ = tload(jpath)
    for k, ref in ttree.items():
        assert type(got[k]) is type(ref) and got[k].dtype == ref.dtype, k
        assert _bytes(got[k]) == _bytes(ref) == _bytes(flat[k]), k
    assert flat["key"].dtype == torch.uint32
    # the port's file in JAX
    back, step, meta = jload(tpath, jtree)
    assert step == 5 and meta == {"tag": "x"}
    for k, ref in jtree.items():
        assert np.asarray(back[k]).dtype == np.asarray(ref).dtype, k
        assert np.asarray(back[k]).tobytes() == np.asarray(ref).tobytes(), k


def test_paths_are_the_jax_packages(tmp_path):
    """Dict keys sorted, list items by index, NamedTuple fields as
    ``.field``, None without a leaf: the keys JAX's flatten writes."""
    cfg = teng.EngineConfig(n=N, d=D, n_events=2)
    tree = {"b": [np.int8(1), {"z": 2.5, "a": True}], "a": None,
            "s": teng.state_to_tree(cfg, teng.init_state(cfg, device="cpu"))}
    jtree = jax.tree.map(np.asarray, tree)
    jsave(str(tmp_path / "j"), jtree)
    flat, _, _ = jload(str(tmp_path / "j"))
    assert [k for k, _ in tree_paths(tree)] == list(flat)
    assert [k for k, _ in tree_paths(tree)][:4] == [
        "b/0", "b/1/a", "b/1/z", "s/.step"]
    tsave(str(tmp_path / "t"), tree)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_restore_casts_only_where_dtypes_differ(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    tsave(path, {"a": torch.tensor([1.0, 2.5, -3.0]),
                 "b": _bf16_tensor([1.5, 2.0])})
    ex = {"a": torch.zeros(3, dtype=torch.bfloat16),
          "b": np.zeros(2, np.float32)}
    got, _, _ = tload(path, ex)
    assert got["a"].dtype == torch.bfloat16 and isinstance(got["b"],
                                                           np.ndarray)
    assert got["a"].tolist() == [1.0, 2.5, -3.0]
    assert got["b"].dtype == np.float32 and got["b"].tolist() == [1.5, 2.0]


# the reference's own guarantees (tests/test_checkpoint.py), mirrored
def test_restored_arrays_are_writable(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    tsave(path, {"a": torch.arange(4, dtype=torch.float32)})
    flat, _, _ = tload(path)
    flat["a"][0] = 99.0
    assert flat["a"][0] == 99.0
    got, _, _ = tload(path, {"a": np.zeros(4, np.float32)})
    got["a"][0] = 7.0
    assert got["a"][0] == 7.0


def test_format_version_mismatch_rejected_clearly(tmp_path):
    path = str(tmp_path / "old.msgpack")
    tsave(path, {"a": torch.zeros(2)}, step=3)
    payload = msgpack.unpackb((tmp_path / "old.msgpack").read_bytes(),
                              raw=False)
    for stale in ({"format_version": FORMAT_VERSION + 1}, {}):
        payload.pop("format_version", None)
        payload.update(stale)
        (tmp_path / "old.msgpack").write_bytes(
            msgpack.packb(payload, use_bin_type=True))
        with pytest.raises(ValueError, match="format_version"):
            tload(path)


def test_missing_array_named_in_error(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    tsave(path, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="b"):
        tload(path, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_atomic_save_preserves_previous_on_reload(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    tsave(path, {"a": torch.zeros(3)}, step=1)
    tsave(path, {"a": torch.ones(3)}, step=2)
    flat, step, _ = tload(path)
    assert step == 2 and torch.all(flat["a"] == 1.0)
    assert not (tmp_path / "ck.msgpack.tmp").exists()


# ---------------------------------------------------------------------------
# ProtocolState across the packages
# ---------------------------------------------------------------------------
STEPS = 8
EVENTS = [(2, "leave", 5), (4, "join", 5)]
ATTACKS = {"delayed_gradient": dict(kind="delayed_gradient", start_step=0,
                                    delay=3),
           "sign_flip": dict(kind="sign_flip", start_step=0, lam=1.0)}
EXACT = ("ban_step", "ban_reason", "lifecycle", "slot_identity",
         "probation_clean", "id_ban_step", "id_ban_reason", "id_accused",
         "accused_count", "col_checked", "active", "validator")


def _grads():
    rng = np.random.default_rng(9)
    w_true = rng.standard_normal(D).astype(np.float32)
    X = rng.standard_normal((STEPS, N, 4, D)).astype(np.float32)
    y = np.einsum("tnbd,d->tnb", X, w_true)
    return (-2.0 * np.einsum("tnbd,tnb->tnd", X, y) / 4.0).astype(np.float32)


GRADS = _grads()
BYZ = np.array([0, 0, 0, 0, 0, 1], np.float32)


def _cfgs(attack):
    kw = dict(tau=1.0, clip_iters=30, m_validators=2,
              aggregator="verified:mean", n_events=2, probation_steps=2)
    return (jeng.config_from_attack(N, D, JAttack(**ATTACKS[attack]), **kw),
            teng.config_from_attack(N, D, TAttack(**ATTACKS[attack]), **kw))


def _jax_run(cfg, state, k):
    G = jnp.asarray(GRADS)
    return jeng.scan_protocol(cfg, state, jnp.asarray(BYZ),
                              jnp.zeros(D, jnp.float32),
                              lambda p, t, f: (G[t], G[t]), k)


def _port_run(cfg, state, k):
    G = torch.from_numpy(GRADS)
    return teng.scan_protocol(cfg, state, torch.from_numpy(BYZ),
                              torch.zeros(D), lambda p, t, f: (G[t], G[t]), k)


def _stack(outs, name):
    return torch.stack([getattr(o, name) for o in outs]).numpy()


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_protocol_state_saved_by_jax_resumes_in_the_port(tmp_path, attack):
    jcfg, tcfg = _cfgs(attack)
    jfull, _, jouts = _jax_run(
        jcfg, jeng.init_state(jcfg, seed=0, events=EVENTS), STEPS)
    jhalf, _, _ = _jax_run(jcfg, jeng.init_state(jcfg, seed=0, events=EVENTS),
                           4)
    jpath = str(tmp_path / "jax_state.msgpack")
    jsave(jpath, jhalf, step=4)

    example = teng.state_to_tree(
        tcfg, teng.init_state(tcfg, seed=0, events=EVENTS, device="cpu"))
    tree, step, _ = tload(jpath, example)
    assert step == 4
    for (key, ref), (_, got) in zip(tree_paths(jhalf), tree_paths(tree)):
        assert _dtype_name(got) == str(np.asarray(ref).dtype), key
        assert _bytes(got) == np.asarray(ref).tobytes(), key
    resumed = teng.state_from_tree(tcfg, tree, device="cpu")
    assert resumed.step == 4 and resumed.key.dtype == torch.int64
    assert (resumed.delay_buf is None) == (attack != "delayed_gradient")
    tst, _, touts = _port_run(tcfg, resumed, 4)

    for name in ("lifecycle", "banned_now", "ban_reason_now", "accuse_mat",
                 "validators", "n_active"):
        np.testing.assert_array_equal(_stack(touts, name),
                                      np.asarray(getattr(jouts, name))[4:],
                                      err_msg=name)
    np.testing.assert_allclose(_stack(touts, "g_hat"),
                               np.asarray(jouts.g_hat)[4:], rtol=1e-5,
                               atol=1e-5)
    for name in EXACT:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jfull, name)),
                                      err_msg=name)
    assert tst.step == int(jfull.step) == STEPS
    assert np.asarray(jfull.ban_reason)[5] != 0  # the scenario bans

    # within the port: 4 + save + load + 4 is its own 8, bit for bit
    init = lambda: teng.init_state(tcfg, seed=0, events=EVENTS,  # noqa: E731
                                   device="cpu")
    full, _, full_outs = _port_run(tcfg, init(), STEPS)
    half, _, _ = _port_run(tcfg, init(), 4)
    tpath = str(tmp_path / "port_state.msgpack")
    tsave(tpath, teng.state_to_tree(tcfg, half), step=4)
    tree, _, _ = tload(tpath, example)
    again, _, again_outs = _port_run(
        tcfg, teng.state_from_tree(tcfg, tree, device="cpu"), 4)
    np.testing.assert_array_equal(_stack(again_outs, "g_hat"),
                                  _stack(full_outs, "g_hat")[4:])
    for name in teng.ProtocolState._fields:
        a, b = getattr(again, name), getattr(full, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name

    # ... and the port's file loads in JAX with JAX's example tree
    jtree, step, _ = jload(tpath, jhalf)
    assert step == 4
    for name in EXACT + ("events", "step", "key"):
        np.testing.assert_array_equal(np.asarray(getattr(jtree, name)),
                                      np.asarray(getattr(jhalf, name)),
                                      err_msg=name)
    assert np.asarray(jtree.key).dtype == np.uint32
    for name in ("prev_agg", "delay_buf"):
        got = np.asarray(getattr(jtree, name), np.float32)
        np.testing.assert_allclose(
            got, np.asarray(getattr(jhalf, name), np.float32), rtol=1e-5,
            atol=1e-5, err_msg=name)


def test_state_tree_is_the_reference_layout():
    """Without the delayed attack the port holds no ring buffer; its tree
    carries the reference's float32 (1, n, d) zeros, and the key as the
    two uint32 words of PRNGKey."""
    jcfg, tcfg = _cfgs("sign_flip")
    jstate = jeng.init_state(jcfg, seed=3, events=EVENTS)
    tstate = teng.init_state(tcfg, seed=3, events=EVENTS, device="cpu")
    assert tstate.delay_buf is None
    tree = teng.state_to_tree(tcfg, tstate)
    for (jk, jv), (tk, tv) in zip(tree_paths(jstate), tree_paths(tree)):
        assert jk == tk
        assert np.asarray(tv).dtype == np.asarray(jv).dtype, jk
        assert np.shape(tv) == np.shape(jv), jk
    np.testing.assert_array_equal(np.asarray(tree.key),
                                  np.asarray(jstate.key))
    back = teng.state_from_tree(tcfg, tree, device="cpu")
    assert back.delay_buf is None and torch.equal(back.key, tstate.key)


# ---------------------------------------------------------------------------
# HostMembership and the launcher's params across the packages
# ---------------------------------------------------------------------------
def _drive(mem):
    mem.apply_events(1)
    mem.ban_slots({3}, 1)
    mem.apply_events(2)
    mem.observe_probe(np.zeros(mem.n), 2)
    mem.apply_events(3)
    mem.observe_probe(np.where(np.arange(mem.n) == 1, 1.0, 0.0), 3)
    return mem


def test_host_membership_trees_cross_both_ways(tmp_path):
    churn = "leave@1:1,join@2:1,leave@2:3,join@3:3"
    jmem = _drive(JMembership(5, probation_steps=2,
                              events=jparse_churn(churn)))
    tmem = _drive(TMembership(5, probation_steps=2,
                              events=tparse_churn(churn)))
    assert tmem.summary() == jmem.summary()
    assert jmem.summary()["banned_identities"]  # the scenario bans
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jsave(jpath, jmem.to_tree(), step=4)
    tsave(tpath, tmem.to_tree(), step=4)
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    tflat, step, _ = tload(jpath)
    assert step == 4
    fresh_t = TMembership(5, probation_steps=2).restore_tree(tflat)
    jflat, _, _ = jload(tpath)
    fresh_j = JMembership(5, probation_steps=2).restore_tree(jflat)
    assert fresh_t.summary() == fresh_j.summary() == jmem.summary()


def test_albert_params_and_momentum_cross_both_ways(tmp_path):
    """A JAX ``{"params", "opt"}`` checkpoint of reduced ALBERT (its
    ``init_params``, ``sgd(momentum=0.9)``'s state with a momentum
    filled in) loads in the port equal to ``from_jax_params`` bit for
    bit, and the port's file loads back in JAX bit for bit."""
    model = get_model("albert-large", reduced=True)
    params = model.init_params(jax.random.key(0))
    opt_state = jsgd(3e-2, momentum=0.9, nesterov=True).init(params)
    opt_state = {"m": jax.tree.map(
        lambda m, p: (m + 0.5 * p.astype(jnp.float32)) * 1.0001,
        opt_state["m"], params)}
    jtree = {"params": params, "opt": opt_state}
    jpath = str(tmp_path / "jax.msgpack")
    jsave(jpath, jtree, step=7, meta={"arch": "albert-large"})

    np_tree = jax.tree.map(np.asarray, jtree)
    want = {"params": from_jax_params(np_tree["params"]),
            "opt": {"m": from_jax_params(np_tree["opt"]["m"])}}
    example = {"params": lm_model("albert-large", reduced=True).init_params(
        tkey(0)), "opt": {"m": from_jax_params(jax.tree.map(
            lambda x: np.zeros(x.shape, np.float32), np_tree["opt"]["m"]))}}
    got, step, meta = tload(jpath, example)
    assert step == 7 and meta == {"arch": "albert-large"}
    pairs = list(zip(tree_paths(want), tree_paths(got)))
    assert len(pairs) == len(jax.tree.leaves(jtree))
    for (k, a), (k2, b) in pairs:
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), k

    tpath = str(tmp_path / "port.msgpack")
    tsave(tpath, got, step=7, meta={"arch": "albert-large"})
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "jax.msgpack").read_bytes()
    back, _, _ = jload(tpath, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
