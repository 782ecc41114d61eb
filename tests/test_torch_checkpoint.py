"""The port's checkpoint layer against the JAX package's.

(a) `repro_torch.checkpoint.io`, the reference's io tests
    (tests/test_checkpoint.py): suffixless paths, None leaves and empty
    subtrees, '/' rejected, every leaf dtype bit for bit (bf16 included),
    the `latest` pointer with retention, a torn writer; and the
    generator state, which stands where the reference stores its PRNG
    key, continuing its stream after a round trip.
(b) The RoundState codec (`fl.state_to_tree` / `state_from_tree`): every
    combination of EF, downlink EF and downlink delta, plus buffered,
    round-trips bit for bit through an archive; each optional-field
    mismatch, the legacy 'prev_broadcast' tree and a tree without its
    required fields are refused with the JAX package's own message; a
    wrong shape or dtype is refused naming the leaf; a generator state of
    another device type is refused naming both.
(c) Elastic K, grow and shrink, against the JAX `state_from_tree` on the
    same state (carried across by `convert`): every field but rng equal.
(d) Layout parity: the same state written by both packages' codec and
    io gives archives with the same keys, dtypes and bytes, apart from
    the one rng entry.
(e) Kill/resume bit for bit on the MLR golden task: a run killed at a
    block edge and restored into a fresh FedServer gives the
    uninterrupted run's state and metrics (atol 0), scanned on the f32 and
    the int8 + EF wire (with its rounds to 85%), stepwise, at 5 of 10
    clients with the int8 delta downlink, buffered under a
    `fixed_arrival_schedule`, and in sequential mode; and an elastic-K
    restore that still reaches the target.
"""
import itertools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.checkpoint import io as jio
from repro.core import fl as jfl
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint.io import GeneratorState
from repro_torch.core import fl as tfl
from repro_torch.core import treemath
from repro_torch.data import synthetic
from repro_torch.transport import downlink as tdl



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small rounds, and when
    several test processes share the CPU torch's default thread pool
    oversubscribes it (a round then slows by an order of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _bits(t) -> np.ndarray:
    a = t.detach().cpu() if isinstance(t, torch.Tensor) else t
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.uint8)


def _assert_trees_bitexact(a, b, what=""):
    """Bitwise equality of two trees of tensors / GeneratorStates."""
    pa, pb = treemath.tree_paths(a), treemath.tree_paths(b)
    assert pa == pb, what
    for path, x, y in zip(pa, treemath.tree_leaves(a),
                          treemath.tree_leaves(b)):
        name = f"{what}{'/'.join(map(str, path))}"
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(_bits(x), _bits(y)), f"{name} differs"
        else:
            assert x == y, name


def _assert_states_bitexact(a, b, what=""):
    """Every RoundState field bitwise, the generator's state included."""
    _assert_trees_bitexact(tfl.state_to_tree(a), tfl.state_to_tree(b), what)


# --------------------------------------------------------- (a) the io layer


def test_save_load_agree_on_suffixless_path(tmp_path):
    p = str(tmp_path / "ckpt")  # no .npz suffix
    ckpt_io.save(p, {"a": torch.arange(3)})
    assert ckpt_io.load(p)["a"].tolist() == [0, 1, 2]
    assert ckpt_io.load(p + ".npz")["a"].tolist() == [0, 1, 2]
    assert os.listdir(tmp_path) == ["ckpt.npz"]


def test_none_leaves_and_empty_subtrees_roundtrip(tmp_path):
    tree = {"params": {"w": torch.ones(2)}, "ef": None, "dl_ef": None,
            "nested": {"inner": None}, "empty": {}}
    p = str(tmp_path / "t.npz")
    ckpt_io.save(p, tree)
    back = ckpt_io.load(p)
    assert back["ef"] is None and back["dl_ef"] is None
    assert back["nested"]["inner"] is None
    assert back["empty"] == {}
    assert treemath.tree_paths(back) == treemath.tree_paths(tree)


def test_slash_in_key_rejected(tmp_path):
    with pytest.raises(ValueError, match="a/b"):
        ckpt_io.save(str(tmp_path / "t"), {"a/b": torch.zeros(1)})
    with pytest.raises(ValueError, match="separator"):
        ckpt_io.save(str(tmp_path / "t"), {"sub": {"x/y": torch.zeros(1)}})


def test_generator_state_roundtrip_continues_the_stream(tmp_path):
    """A CPU generator's state survives an archive: the restored
    generator draws what the original draws next."""
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)  # move off the seed
    p = str(tmp_path / "g.npz")
    ckpt_io.save(p, {"rng": GeneratorState.of(gen),
                     "nested": {"g2": GeneratorState.of(
                         torch.Generator().manual_seed(3))}})
    with np.load(p) as z:
        assert "rng__gen:cpu__" in z.files
    back = ckpt_io.load(p)
    assert isinstance(back["rng"], GeneratorState)
    assert back["rng"].device_type == "cpu"
    assert back["rng"].state.dtype == torch.uint8
    restored = back["rng"].generator("cpu")
    assert torch.equal(torch.rand(8, generator=restored),
                       torch.rand(8, generator=gen))
    assert torch.equal(
        torch.rand(4, generator=back["nested"]["g2"].generator("cpu")),
        torch.rand(4, generator=torch.Generator().manual_seed(3)))


def test_generator_of_another_device_type_is_refused():
    state = GeneratorState("cuda", torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        state.generator("cpu")


def test_module_docstring_points_at_the_codec():
    assert "state_to_tree" in ckpt_io.__doc__
    assert hasattr(tfl, "state_to_tree") and hasattr(tfl, "state_from_tree")


def test_all_leaf_dtypes_roundtrip_exactly(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "f32": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(5,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(4, 2)).astype(
            np.float32)).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-128, 127, (7,)).astype(np.int8)),
        "u8": torch.from_numpy(rng.integers(0, 255, (6,)).astype(np.uint8)),
        "i32": torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (3,))
                                .astype(np.int32)),
        "u32": torch.from_numpy(rng.integers(0, 2**32 - 1, (3,))
                                .astype(np.uint32)),
        "i64": torch.from_numpy(rng.integers(-2**62, 2**62, (2,))),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(3.5, dtype=torch.float32),
        "gen": GeneratorState.of(torch.Generator().manual_seed(11)),
    }
    p = str(tmp_path / "dtypes.npz")
    ckpt_io.save(p, tree)
    with np.load(p) as z:  # bf16 is stored as its bits, in uint16
        assert z["bf16__bf16__"].dtype == np.uint16
    _assert_trees_bitexact(ckpt_io.load(p), tree)


def test_save_checkpoint_latest_pointer_and_retention(tmp_path):
    d = str(tmp_path / "run")
    for step in (2, 4, 6, 8):
        ckpt_io.save_checkpoint(d, step, {"x": torch.tensor(step)}, keep=2)
    assert [s for s, _ in ckpt_io.list_checkpoints(d)] == [6, 8]
    step, tree = ckpt_io.load_latest(d)
    assert step == 8 and int(tree["x"]) == 8
    assert not [f for f in os.listdir(d) if ".tmp." in f]


def test_latest_pointer_survives_torn_writer(tmp_path):
    d = str(tmp_path / "run")
    ckpt_io.save_checkpoint(d, 3, {"x": torch.tensor(3)})
    with open(os.path.join(d, "ckpt_00000009.npz.tmp.999"), "wb") as f:
        f.write(b"partial garbage")
    with open(os.path.join(d, "latest"), "w") as f:
        f.write("ckpt_00000009.npz\n")
    step, tree = ckpt_io.load_latest(d)
    assert step == 3 and int(tree["x"]) == 3
    assert ckpt_io.load_latest(str(tmp_path / "nowhere")) is None


# ------------------------------------------------------ (b) the codec

_NP_PARAMS = {"w": np.linspace(-1.0, 1.0, 8, dtype=np.float32).reshape(4, 2),
              "b": np.asarray([0.5, -0.25], jnp.bfloat16)}


def _tparams():
    return convert.params_from_numpy(_NP_PARAMS, "cpu")


def _jparams():
    return jax.tree.map(jnp.asarray, _NP_PARAMS)


def _combo_kw(ef, dlef, dld, buffered=False, num_clients=5):
    kw = dict(num_clients=num_clients, clients_per_round=3, local_steps=2,
              transport="int8" if ef else "f32",
              downlink="int8" if (dlef or dld) else "f32",
              error_feedback=ef, downlink_error_feedback=dlef,
              downlink_delta=dld)
    if buffered:
        kw.update(aggregation="buffered", buffer_m=2)
    return kw


COMBOS = [(*c, False) for c in itertools.product([False, True], repeat=3)]
COMBOS.append((True, True, True, True))


@pytest.mark.parametrize("ef,dlef,dld,buffered", COMBOS)
def test_state_tree_roundtrip_every_optional_combo(tmp_path, ef, dlef, dld,
                                                   buffered):
    """save(state_to_tree) -> load -> state_from_tree is the identity: the
    structure of init_round_state, bitwise-equal leaves, the generator
    in the same place of its stream, the round counter."""
    cfg = tfl.FLConfig(**_combo_kw(ef, dlef, dld, buffered))
    state = tfl.init_round_state(cfg, _tparams(), seed=3)
    torch.rand(9, generator=state.rng)
    state = state._replace(round=17)
    p = str(tmp_path / "state")
    ckpt_io.save(p, tfl.state_to_tree(state))
    back = tfl.state_from_tree(cfg, ckpt_io.load(p), device="cpu")
    _assert_states_bitexact(back, state)
    assert back.round == 17 and back.rng is not state.rng
    assert torch.equal(torch.rand(4, generator=back.rng),
                       torch.rand(4, generator=state.rng))


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("field,have,want", [
    ("ef", True, False), ("ef", False, True),
    ("dl_ef", True, False), ("dl_ef", False, True),
    ("bcast", True, False), ("bcast", False, True),
    ("buf", True, False), ("buf", False, True),
])
def test_optional_field_mismatch_refused_as_the_reference(field, have, want):
    """The tree of a config with `field` on (off) restored under one with
    it off (on): both packages refuse with the same message, naming the
    field and its flag."""
    def kw(on):
        return _combo_kw(ef=on and field == "ef",
                         dlef=on and field == "dl_ef",
                         dld=on and field == "bcast",
                         buffered=on and field == "buf")

    jtree = jfl.state_to_tree(jfl.init_round_state(
        jfl.FLConfig(**kw(have)), _jparams()))
    ttree = tfl.state_to_tree(tfl.init_round_state(
        tfl.FLConfig(**kw(have)), _tparams()))
    want_msg = _error(
        lambda: jfl.state_from_tree(jfl.FLConfig(**kw(want)), jtree))
    got_msg = _error(lambda: tfl.state_from_tree(
        tfl.FLConfig(**kw(want)), ttree, device="cpu"))
    assert got_msg == want_msg
    assert repr(field) in got_msg


def test_legacy_and_incomplete_trees_refused_as_the_reference():
    kw = _combo_kw(False, False, True)
    jtree = jfl.state_to_tree(jfl.init_round_state(jfl.FLConfig(**kw),
                                                   _jparams()))
    ttree = tfl.state_to_tree(tfl.init_round_state(tfl.FLConfig(**kw),
                                                   _tparams()))
    for mutate in (
            lambda t: {**{k: v for k, v in t.items() if k != "bcast"},
                       "bcast": None, "prev_broadcast": t["bcast"]["head"]},
            lambda t: {k: v for k, v in t.items() if k != "rng"},
            lambda t: {k: v for k, v in t.items() if k != "prev_delta"}):
        want = _error(lambda: jfl.state_from_tree(jfl.FLConfig(**kw),
                                                      mutate(jtree)))
        got = _error(lambda: tfl.state_from_tree(
            tfl.FLConfig(**kw), mutate(ttree), device="cpu"))
        assert got == want
    assert "prev_broadcast" in _error(lambda: tfl.state_from_tree(
        tfl.FLConfig(**kw), {**ttree, "prev_broadcast": torch.zeros(3)},
        device="cpu"))


def test_state_from_tree_validates_shape_and_dtype():
    cfg = tfl.FLConfig(**_combo_kw(True, False, False))
    tree = tfl.state_to_tree(tfl.init_round_state(cfg, _tparams()))
    bad = dict(tree, prev_delta={"w": tree["prev_delta"]["w"],
                                 "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="prev_delta/b"):
        tfl.state_from_tree(cfg, bad, device="cpu")
    # the EF width must match this model's parameter count
    bad = dict(tree, ef=torch.zeros((cfg.num_clients, 3)))
    with pytest.raises(ValueError, match="ef"):
        tfl.state_from_tree(cfg, bad, device="cpu")
    bad = dict(tree, ef=tree["ef"].double())
    with pytest.raises(ValueError, match="ef.*float64"):
        tfl.state_from_tree(cfg, bad, device="cpu")
    bad = dict(tree, round=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="round"):
        tfl.state_from_tree(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="torch.Generator state"):
        tfl.state_from_tree(cfg, dict(tree, rng=torch.zeros(2)),
                            device="cpu")
    # a generator saved on the card does not continue on the CPU
    cuda_state = GeneratorState("cuda", torch.zeros(16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        tfl.state_from_tree(cfg, dict(tree, rng=cuda_state), device="cpu")


# --------------------------------------------- (c) elastic K against JAX


def _jax_state(kw, seed=1):
    """A JAX RoundState under `kw` with every live field nonzero."""
    cfg = jfl.FLConfig(**kw)
    st = jfl.init_round_state(cfg, _jparams(), seed=seed)
    k, n = cfg.num_clients, jfl.param_count(_jparams())
    rng = np.random.default_rng(seed)
    st = st._replace(
        angle=jfl.AngleState(
            smoothed=jnp.asarray(rng.uniform(0, 1.5, k), jnp.float32),
            count=jnp.arange(k, dtype=jnp.int32)),
        prev_delta=jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            st.prev_delta),
        round=jnp.int32(6))
    if st.ef is not None:
        st = st._replace(ef=jnp.asarray(rng.normal(size=(k, n)), jnp.float32))
    if st.dl_ef is not None:
        st = st._replace(dl_ef=jnp.asarray(rng.normal(size=n), jnp.float32))
    if st.bcast is not None:
        st = st._replace(bcast=st.bcast._replace(
            ring=jnp.asarray(rng.normal(size=st.bcast.ring.shape),
                             jnp.float32),
            head=jnp.asarray(rng.normal(size=n), jnp.float32),
            head_ver=jnp.int32(5),
            ver=jnp.asarray(np.arange(k) % 7 - 1, jnp.int32)))
    if st.buf is not None:
        kk = cfg.clients_per_round
        st = st._replace(buf=st.buf._replace(
            data=jnp.asarray(rng.normal(size=(kk, n)), jnp.float32),
            slot=jnp.asarray([4, 0, 2][:kk], jnp.int32),
            sizes=jnp.asarray([100.0, 200.0, 300.0][:kk], jnp.float32),
            age=jnp.asarray([0, 1, 2][:kk], jnp.int32),
            wait=jnp.asarray([0, 2, 0][:kk], jnp.int32),
            free=jnp.asarray([False, False, True][:kk])))
    return cfg, st


def _to_port(tcfg, jst):
    return convert.round_state_from_numpy(
        tcfg, jax.tree.map(np.asarray, jst.params),
        np.asarray(jst.angle.smoothed), np.asarray(jst.angle.count),
        round=int(jst.round), device="cpu",
        ef=None if jst.ef is None else np.asarray(jst.ef),
        dl_ef=None if jst.dl_ef is None else np.asarray(jst.dl_ef),
        bcast=jst.bcast, buf=jst.buf,
        prev_delta=jax.tree.map(np.asarray, jst.prev_delta))


def _assert_matches_jax_exactly(tst, jst):
    got = convert.round_state_to_numpy(tst)
    np.testing.assert_array_equal(got["angle_smoothed"],
                                  np.asarray(jst.angle.smoothed))
    np.testing.assert_array_equal(got["angle_count"],
                                  np.asarray(jst.angle.count))
    assert got["round"] == int(jst.round)
    for name in ("params", "prev_delta"):
        ours = jax.tree.map(np.asarray, getattr(jst, name))
        for path, a in zip(treemath.tree_paths(got[name]),
                           treemath.tree_leaves(got[name])):
            b = ours
            for p in path:
                b = b[p]
            assert a.dtype == b.dtype, (name, path)
            assert np.array_equal(_bits(a), _bits(b)), (name, path)
    for field in ("ef", "dl_ef"):
        theirs = getattr(jst, field)
        assert (got[field] is None) == (theirs is None), field
        if theirs is not None:
            assert np.array_equal(got[field], np.asarray(theirs)), field
    for field in ("bcast", "buf"):
        ours, theirs = got[field], getattr(jst, field)
        assert (ours is None) == (theirs is None), field
        for key, value in (ours or {}).items():
            want = np.asarray(getattr(theirs, key))
            assert value.dtype == want.dtype and np.array_equal(
                value, want), (field, key)


@pytest.mark.parametrize("k_new", [13, 7], ids=["grow", "shrink"])
@pytest.mark.parametrize("buffered", [False, True],
                         ids=["sync", "buffered"])
def test_elastic_k_matches_jax_state_from_tree(tmp_path, k_new, buffered):
    """One K = 10 state (EF, downlink EF, delta ring; or buffered with
    reports in flight) restored into K = 13 and K = 7 by both packages'
    codecs, the port's through an archive: every field but rng equal."""
    kw = _combo_kw(True, True, True, buffered, num_clients=10)
    jcfg, jst = _jax_state(kw)
    kw_new = dict(kw, num_clients=k_new)
    jback = jfl.state_from_tree(jfl.FLConfig(**kw_new),
                                jfl.state_to_tree(jst))
    tst = _to_port(tfl.FLConfig(**kw), jst)
    p = ckpt_io.save(str(tmp_path / "k10"), tfl.state_to_tree(tst))
    tback = tfl.state_from_tree(tfl.FLConfig(**kw_new), ckpt_io.load(p),
                                device="cpu")
    _assert_matches_jax_exactly(tback, jback)
    assert tback.angle.count.shape == (k_new,)
    if k_new > 10:  # new clients: unseen angle, zero residual, never pulled
        assert not tback.angle.count[10:].any()
        assert not tback.ef[10:].any()
        assert (tback.bcast.ver[10:] == tdl.NEVER_PULLED).all()


# ------------------------------------------------- (d) layout parity


@pytest.mark.parametrize("ef,dlef,dld,buffered",
                         [(False, False, False, False),
                          (True, True, True, False),
                          (True, False, True, True)])
def test_archive_layout_matches_the_jax_package(tmp_path, ef, dlef, dld,
                                                buffered):
    """The same state, carried across, written by both packages'
    state_to_tree + io.save: the same keys, dtypes and bytes, the one
    rng entry apart."""
    kw = _combo_kw(ef, dlef, dld, buffered)
    _, jst = _jax_state(kw)
    tst = _to_port(tfl.FLConfig(**kw), jst)
    jp = jio.save(str(tmp_path / "jax"), jfl.state_to_tree(jst))
    tp = ckpt_io.save(str(tmp_path / "port"), tfl.state_to_tree(tst))
    with np.load(jp) as jz, np.load(tp) as tz:
        jrng = [k for k in jz.files if k.startswith("rng__key:")]
        trng = [k for k in tz.files if k.startswith("rng__gen:")]
        assert len(jrng) == len(trng) == 1 and trng == ["rng__gen:cpu__"]
        jkeys = sorted(set(jz.files) - set(jrng))
        assert sorted(set(tz.files) - set(trng)) == jkeys
        assert "params/b__bf16__" in jkeys and "round" in jkeys
        for key in jkeys:
            a, b = tz[key], jz[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key


# ------------------------------------------ (e) kill/resume bit for bit


@pytest.fixture(scope="module")
def golden_task():
    """The golden-convergence task of tests/test_checkpoint.py: 12k-train
    images, 5 IID + one-class nodes of 600 samples, MLR."""
    return synthetic.make_image_task(seed=0, num_train=12000,
                                     num_test=2000)


def _server(task, cfg, arrival_fn=None):
    train, test = task
    spec = [("iid", None)] * 5 + [("xclass", 1)] * 8
    nodes = synthetic.make_federated(train, spec[:cfg.num_clients],
                                     samples_per_node=600, seed=1)
    return repro_torch.FedServer("mlr", cfg, nodes, test, batch_size=50,
                                 seed=0, device="cpu", arrival_fn=arrival_fn)


def _cfg(**kw):
    base = dict(num_clients=10, clients_per_round=10, local_steps=12,
                method="fedadp", engine="flat", base_lr=0.05)
    return repro_torch.FLConfig(**{**base, **kw})


def _assert_hist_tail(h_res, h_ref, edge):
    """The resumed History is the uninterrupted one's from `edge` on, bit
    for bit: accuracy, loss, divergence, angles and weights."""
    assert h_res.accuracy == h_ref.accuracy[edge:]
    assert h_res.loss == h_ref.loss[edge:]
    assert h_res.divergence == h_ref.divergence[edge:]
    for key in ("thetas", "weights"):
        got, want = getattr(h_res, key), getattr(h_ref, key)[edge:]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.tobytes() == b.tobytes(), key


def _kill_resume(task, cfg, tmp_path, rounds=6, block=2, edges=(2, 4),
                 arrival_fn=None):
    """The uninterrupted scanned run, then a fresh server restored at
    each edge running the rest: state and History bit for bit."""
    d = str(tmp_path / "ckpts")
    ref = _server(task, cfg, arrival_fn)
    h_ref = ref.run(rounds, eval_every=1, mode="scanned", block=block,
                    ckpt_dir=d, ckpt_keep=0)
    saved = dict(ckpt_io.list_checkpoints(d))
    assert sorted(saved) == list(range(block, rounds + 1, block))
    for edge in edges:
        res = _server(task, cfg, arrival_fn)
        assert res.restore(saved[edge]) == edge
        h_res = res.run(rounds - edge, eval_every=1, mode="scanned",
                        block=block)
        _assert_hist_tail(h_res, h_ref, edge)
        _assert_states_bitexact(res.state, ref.state, f"edge {edge}: ")
    return ref, h_ref, saved


@pytest.mark.parametrize("wire", [dict(), dict(transport="int8",
                                               error_feedback=True)],
                         ids=["f32-f32", "int8ef-f32"])
def test_kill_resume_scanned_bit_exact(tmp_path, golden_task, wire):
    """Killed at either inner block edge and restored, the scanned run is
    the uninterrupted one; its rounds to 85% too, through a resumed early
    exit."""
    cfg = _cfg(**wire)
    _, h_ref, saved = _kill_resume(golden_task, cfg, tmp_path, rounds=8,
                                   edges=(2, 4, 6))
    hits = np.flatnonzero(np.asarray(h_ref.accuracy) >= 0.85)
    assert hits.size, f"the golden task no longer reaches 85%: {h_ref}"
    res = _server(golden_task, cfg)
    res.restore(saved[2])
    h = res.run(6, target_acc=0.85, eval_every=1, mode="scanned", block=2)
    assert h.rounds_to_target == int(hits[0]) + 1
    assert len(h.loss) == h.rounds_to_target - 2


def test_kill_resume_stepwise_bit_exact(tmp_path, golden_task):
    """3 steps + save + restore + 3 steps == 6 steps, state and each
    step's metrics."""
    cfg = _cfg()
    ref = _server(golden_task, cfg)
    want = [ref.step(eval_every=1) for _ in range(6)]
    part = _server(golden_task, cfg)
    for _ in range(3):
        part.step(eval_every=1)
    d = str(tmp_path / "ckpts")
    part.save_checkpoint(d)
    res = _server(golden_task, cfg)
    assert res.restore(d) == 3
    for m_ref in want[3:]:
        m = res.step(eval_every=1)
        assert set(m) == set(m_ref)
        for key in m:
            assert m[key].tobytes() == m_ref[key].tobytes(), key
    assert res.round == 6
    _assert_states_bitexact(res.state, ref.state)


def test_kill_resume_subset_selection_delta_downlink(tmp_path, golden_task):
    """5 of 10 clients with the int8 delta downlink: the checkpoint holds
    a mid-flight ring, chain head and staggered per-client versions."""
    ref, _, _ = _kill_resume(golden_task, _cfg(
        clients_per_round=5, downlink="int8", downlink_delta=True),
        tmp_path)
    assert int(ref.state.bcast.head_ver) == 5
    assert len(set(ref.state.bcast.ver.tolist())) > 1


def test_kill_resume_buffered_fixed_schedule(tmp_path, golden_task):
    """The buffered server under a fixed arrival schedule, on the int8
    wire with EF at 6 of 10: the block edges fall with reports in
    flight, and the schedule's tick follows the restored round."""
    delays = np.zeros((6, 6), np.int32)
    delays[1, [0, 3]] = 2
    delays[3, 2] = 1
    drops = np.zeros((6, 6), bool)
    drops[2, 5] = True
    cfg = _cfg(clients_per_round=6, transport="int8", error_feedback=True,
               aggregation="buffered", buffer_m=4)
    sched = repro_torch.fixed_arrival_schedule(delays, drops)
    _, _, saved = _kill_resume(golden_task, cfg, tmp_path,
                               arrival_fn=sched)
    in_flight = ~ckpt_io.load(saved[2])["buf"]["free"]
    assert int(in_flight.sum()) > 0


def test_kill_resume_sequential(tmp_path, golden_task):
    _kill_resume(golden_task, _cfg(mode="sequential", engine="tree"),
                 tmp_path, rounds=4, edges=(2,))


def test_elastic_k_restore_converges(tmp_path, golden_task):
    """A K = 10 checkpoint restores into K = 13 and K = 7 fleets: new
    clients start unseen, survivors keep their history, and both fleets
    still reach 85%."""
    d = str(tmp_path / "ckpts")
    wire = dict(transport="int8", error_feedback=True)
    _server(golden_task, _cfg(**wire)).run(2, eval_every=0, mode="scanned",
                                           block=2, ckpt_dir=d)
    for k in (13, 7):
        sk = _server(golden_task, _cfg(num_clients=k, clients_per_round=k,
                                       **wire))
        assert sk.restore(d) == 2
        counts = sk.state.angle.count
        if k > 10:
            assert not counts[10:].any() and not sk.state.ef[10:].any()
        assert (counts[:min(k, 10)] == 2).all()
        h = sk.run(40, target_acc=0.85, eval_every=1, mode="scanned",
                   block=4)
        assert h.rounds_to_target is not None, f"K={k} did not converge"


def test_restore_checks_the_model_and_the_source(tmp_path, golden_task):
    d = str(tmp_path / "ckpts")
    mlr = _server(golden_task, _cfg())
    mlr.save_checkpoint(d)
    train, test = golden_task
    nodes = synthetic.make_federated(train, [("iid", None)] * 10,
                                     samples_per_node=100, seed=1)
    cnn = repro_torch.FedServer("cnn", _cfg(), nodes, test, batch_size=50,
                                device="cpu")
    with pytest.raises(ValueError, match="this server's model"):
        cnn.restore(d)
    with pytest.raises(FileNotFoundError):
        mlr.restore(str(tmp_path))


def test_run_scanned_shim_warns_once(golden_task, monkeypatch):
    monkeypatch.setattr(repro_torch.FedServer, "_warned_run_scanned", False)
    s = _server(golden_task, _cfg())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        h = s.run_scanned(2, eval_every=1, block=2)
        s.run_scanned(1, eval_every=1)
    assert [w.category for w in caught] == [DeprecationWarning]
    assert len(h.accuracy) == 2 and s.round == 3
