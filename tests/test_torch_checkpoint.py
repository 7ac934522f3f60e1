"""The port's checkpoint store (``repro_torch.checkpoint.store``) and its
format against the JAX package's ``repro.checkpoint.store``.

Tiers, all bitwise: leaf bytes, bfloat16 included; the codec leaves
decode to exactly the codec's plain round trip; a checkpoint the
reference writes restores in the port, and one the port writes
restores in the reference, for Algorithm 1's state (``{"params", "opt":
QAdamState}``) and for the distributed state at one worker (``master``,
``m``, ``v``, ``e``, ``count``): params, count, m, v and e equal, and
the two packages' manifests list the same keys, names, shapes and
dtypes. Algorithm 1's threefry key is the state's own, written as
uint32 and read back (``tests/test_torch_threefry_train.py`` resumes
TernGrad runs across the packages on it).
"""
import itertools
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jget
from repro.core import qadam as JQA
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import make_train_step as j_make_train_step
from repro.models.model import Model as JModel
from repro.train.session import SessionConfig as JSC
from repro.train.session import TrainSession as JSession
from repro_torch.checkpoint import store
from repro_torch.comm.codec import get_codec
from repro_torch.configs import get_config as tget
from repro_torch.core import qadam as TQA
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.train.session import SessionConfig, TrainSession
from repro_torch.tree import tree_flatten_with_path

OPT = dict(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
           weight_q_min_numel=2 ** 14)
DIST = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
            weight_absolute=True)


def _small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "b": torch.randn(7, generator=g).to(torch.bfloat16)},
            "m": {"w": torch.randn(3, 5, generator=g)},
            "count": np.int32(4)}


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_tree_paths_are_the_references():
    """Keys letter for letter as jax's flattening: dict keys sorted,
    sequence indices ``[i]``, NamedTuple fields by name, None empty."""
    tree = {"opt": {"count": 0, "m": [1, 2], "v": [3], "key": 4,
                    "e": [5]},
            "params": {"layers": [{"w": 6}], "a": None},
            "nt": JQA.QAdamState(count=7, m=8, v=9, e=10, key=11)}
    keys, vals, _ = jstore._flatten(tree)
    assert [k for k, _ in tree_flatten_with_path(tree)] == keys
    assert [v for _, v in tree_flatten_with_path(tree)] == vals


def test_versioned_subdirs_and_pruning(tmp_path):
    d = str(tmp_path)
    trees = [_small_tree(s) for s in range(4)]
    for s, t in enumerate(trees, start=1):
        out = store.save(d, t, step=s, keep=2, extra={"batches_consumed": s})
        assert out == os.path.join(d, f"step_{s:08d}")
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert store.latest_step(d) == 4
    assert store.read_extra(d) == {"batches_consumed": 4}
    assert store.read_extra(d, step=3) == {"batches_consumed": 3}
    back = store.restore(d, trees[0], step=3)
    assert _equal(back["params"]["w"], trees[2]["params"]["w"])
    assert int(back["count"]) == 4


def test_crash_mid_save_keeps_the_previous_checkpoint(tmp_path,
                                                      monkeypatch):
    d = str(tmp_path)
    store.save(d, _small_tree(0), step=1)

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(store.np, "savez", boom)
    with pytest.raises(OSError):
        store.save(d, _small_tree(1), step=2)
    monkeypatch.undo()
    assert os.listdir(d) == ["step_00000001"]     # no temp dir left
    assert store.latest_step(d) == 1
    back = store.restore(d, _small_tree(5))
    assert _equal(back["params"]["w"], _small_tree(0)["params"]["w"])


def test_partial_dir_is_ignored(tmp_path):
    d = str(tmp_path)
    store.save(d, _small_tree(0), step=2)
    os.makedirs(os.path.join(d, "step_00000009"))   # a crash's leftover
    os.makedirs(os.path.join(d, ".tmp-step_00000010.1"))
    assert store.latest_step(d) == 2
    assert store.read_extra(d) == {}
    store.restore(d, _small_tree(1))


def test_flat_layout(tmp_path):
    d = str(tmp_path)
    t = _small_tree(3)
    assert store.save(d, t) == d
    assert store.latest_step(d) is None
    back = store.restore(d, t)
    assert _equal(back["m"]["w"], t["m"]["w"])
    assert store.latest_step(str(tmp_path / "none")) is None


@pytest.mark.parametrize("shape", [(7,), (3, 5), ()])
def test_bfloat16_round_trip(tmp_path, shape):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 100).to(torch.bfloat16)
    store.save(str(tmp_path), {"x": x}, step=1)
    back = store.restore(str(tmp_path), {"x": x})["x"]
    assert _equal(back, x)
    # the reference reads the same bytes as ml_dtypes bfloat16
    ref = jstore.restore(str(tmp_path), {"x": np.zeros(shape, np.float32)})
    np.testing.assert_array_equal(
        np.asarray(ref["x"]).astype(np.float32), x.float().numpy())


def test_compressed_members_restore_and_a_bad_crc_raises(tmp_path):
    """Members ``np.savez`` stores are read at their offsets; a deflated
    member (``np.savez_compressed``) reads as well, and a flipped byte
    in a stored member fails its CRC-32."""
    t = _small_tree(4)
    d = store.save(str(tmp_path), t, step=1)
    npz = os.path.join(d, "arrays.npz")
    with np.load(npz) as data:
        arrays = {k: data[k] for k in data.files}
    np.savez_compressed(npz, **arrays)
    back = store.restore(str(tmp_path), t)
    for (k, x), (_, y) in zip(tree_flatten_with_path(back),
                              tree_flatten_with_path(t)):
        assert _equal(x, torch.as_tensor(y)), k
    np.savez(npz, **arrays)
    with zipfile.ZipFile(npz) as zf:
        info = zf.getinfo("leaf_0.npy")
    raw = bytearray(open(npz, "rb").read())
    local = info.header_offset
    start = local + 30 + int.from_bytes(raw[local + 26:local + 28],
                                        "little") + \
        int.from_bytes(raw[local + 28:local + 30], "little")
    raw[start + info.file_size - 1] ^= 0xFF    # the member's last byte
    open(npz, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        store.restore(str(tmp_path), t)


class _Got:
    def __init__(self, x):
        self.x = x


@pytest.mark.parametrize("codec", [None, "uniform_amax:7"])
def test_restore_hands_each_leaf_to_the_sink(tmp_path, codec):
    """``sink(key, t)`` sees every leaf once, in the tree's key order, as
    it is read (raw leaves as the stored bytes on the CPU, codec leaves
    decoded), and what it returns takes the leaf's place."""
    t = _small_tree(3)
    store.save(str(tmp_path), t, step=1, codec=codec)
    seen = []

    def sink(key, x):
        seen.append(key)
        return _Got(x)
    back = dict(tree_flatten_with_path(
        store.restore(str(tmp_path), t, sink=sink)))
    plain = tree_flatten_with_path(store.restore(str(tmp_path), t))
    assert seen == [k for k, _ in plain] == list(back)
    for k, x in plain:
        assert _equal(back[k].x, x), k


@pytest.mark.parametrize("spec", ["uniform_amax:7", "log:6", "uniform:7:w8"])
def test_codec_leaves_decode_to_the_plain_round_trip(tmp_path, spec):
    t = _small_tree(2)
    t["v"] = {"a": torch.rand(1000, generator=torch.Generator()
                              .manual_seed(9))}
    t["m"]["one"] = torch.ones(1)     # one element: stored exact
    store.save(str(tmp_path), t, step=1, codec=spec)
    back = store.restore(str(tmp_path), t)
    cd = get_codec(spec)
    for leaf in (("m", "w"), ("v", "a")):
        x = t[leaf[0]][leaf[1]]
        want = cd.encode(x, backend="torch").decode(backend="torch")
        assert _equal(back[leaf[0]][leaf[1]], want), leaf
    assert _equal(back["params"]["w"], t["params"]["w"])
    assert _equal(back["params"]["b"], t["params"]["b"])
    assert _equal(back["m"]["one"], t["m"]["one"])
    man = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    coded = {l["key"] for l in man["leaves"] if "codec" in l}
    assert coded == {"m/w", "v/a"}
    # and the reference decodes the port's codec leaves to the same values
    ref = jstore.restore(str(tmp_path), jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), {"m": {"w": t["m"]["w"]},
                                                  "v": t["v"]}))
    np.testing.assert_array_equal(np.asarray(ref["v"]["a"]),
                                  back["v"]["a"].numpy())


# ---------------------------------------------------------------------------
# across the packages: Algorithm 1's state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return JModel(jget("yi-6b", smoke=True)), TModel(tget("yi-6b",
                                                          smoke=True))


def _loss_fn(tm):
    def loss_fn(p, b):
        s, n = tm.loss(p, b)
        return s / n
    return loss_fn


def _random_like(tree, rng):
    return jax.tree.map(lambda x: rng.standard_normal(
        np.shape(x)).astype(np.float32), tree)


def _by_key(tree):
    """A reference tree's leaves by the reference store's keys."""
    keys, vals, _ = jstore._flatten(tree)
    return {k: np.asarray(v) for k, v in zip(keys, vals)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _layout(man):
    return [(l["key"], l["name"], l["dtype"], l["shape"])
            for l in man["leaves"]]


def _port_alg1_session(tm, ckpt_dir=None, **kw):
    opt = TQA.qadam(TQA.QAdamConfig(**OPT), seed=0)
    return TrainSession.from_optimizer(
        opt, _loss_fn(tm), tm.init(seed=0, device="cpu"),
        tbatches(tm.cfg, 32, 4), SessionConfig(log_every=0,
                                               ckpt_dir=ckpt_dir, **kw),
        log=lambda *_: None)


def test_alg1_reference_checkpoint_restores_in_the_port(tmp_path, models):
    jm, tm = models
    rng = np.random.default_rng(0)
    jp = jm.init(jax.random.PRNGKey(0))
    js = JQA.qadam(JQA.QAdamConfig(**OPT)).init(jp)
    js = js._replace(count=np.int32(3), m=_random_like(js.m, rng),
                     v=_random_like(js.v, rng), e=_random_like(js.e, rng))
    jp = _random_like(jp, rng)
    d = str(tmp_path)
    jstore.save(d, {"params": jp, "opt": js._asdict()}, step=3,
                extra={"batches_consumed": 3})
    sess = _port_alg1_session(tm, d)
    assert sess.resume() == 3 and sess.step == 3
    st = sess.state
    assert st["opt"].count == 3
    want = _by_key({"params": jp, "opt": {"m": js.m, "v": js.v,
                                          "e": js.e}})
    got = dict(tree_flatten_with_path(
        {"params": st["params"], "opt": {"m": st["opt"].m,
                                         "v": st["opt"].v,
                                         "e": st["opt"].e}}))
    assert want.keys() == got.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(want[k], v.numpy(), err_msg=k)
    # the port writes the same layout back: keys, names, shapes, dtypes
    sess.checkpoint(step=4)
    sess.close()
    assert _layout(_manifest(d, 4)) == _layout(_manifest(d, 3))


def test_alg1_port_checkpoint_restores_in_the_reference(tmp_path, models):
    jm, tm = models
    d = str(tmp_path)
    sess = _port_alg1_session(tm, d, ckpt_every=2)
    with sess:
        sess.run(2)
    st = sess.state
    assert st["opt"].count == 2
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = JQA.qadam(JQA.QAdamConfig(**OPT))
    jsess = JSession.from_optimizer(jopt, lambda p, b: 0.0, jp,
                                    itertools.repeat(None),
                                    JSC(log_every=0, ckpt_dir=d, prefetch=0),
                                    log=lambda *_: None)
    assert jsess.resume() == 2 and jsess.step == 2
    js = jsess.state
    assert int(js["opt"].count) == 2
    key = jax.random.PRNGKey(0)     # the port's state key, split twice
    for _ in range(2):
        key = jax.random.split(key)[0]
    np.testing.assert_array_equal(np.asarray(js["opt"].key),
                                  np.asarray(key))
    for name, want in (("params", st["params"]), ("m", st["opt"].m),
                       ("v", st["opt"].v), ("e", st["opt"].e)):
        tree = js["params"] if name == "params" else getattr(js["opt"],
                                                             name)
        got = _by_key(tree)
        for k, v in tree_flatten_with_path(want):
            np.testing.assert_array_equal(got[k], v.numpy(),
                                          err_msg=f"{name}/{k}")
    # the reference writes the same layout the port wrote
    jstore.save(d, jsess._program.to_ckpt(js), step=5)
    assert _layout(_manifest(d, 5)) == _layout(_manifest(d, 2))
    jsess.close()


# ---------------------------------------------------------------------------
# across the packages: the distributed state at one worker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    g = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield g
    TM.close_process_group()


def _reference_dist_state(jm, rng):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    art = j_make_train_step(jm, mesh, JTC(**DIST, worker_axes=("data",)))
    state = jax.tree.map(np.asarray, art.init_state(jax.random.PRNGKey(0)))
    for k in ("master", "m", "v", "e"):
        state[k] = _random_like(state[k], rng)
    state["count"] = np.int32(6)
    return state


def _port_dist_session(tm, group, d, **kw):
    art = t_make_train_step(tm, group, TTC(**DIST))
    return TrainSession.from_artifacts(
        art, tbatches(tm.cfg, 32, 4), SessionConfig(log_every=0,
                                                    ckpt_dir=d, **kw),
        device="cpu", log=lambda *_: None)


def test_dist_reference_checkpoint_restores_in_the_port(tmp_path, models,
                                                        group):
    jm, tm = models
    d = str(tmp_path)
    state = _reference_dist_state(jm, np.random.default_rng(1))
    jstore.save(d, state, step=6, extra={"batches_consumed": 6})
    sess = _port_dist_session(tm, group, d)
    assert sess.resume() == 6
    st = sess.state
    assert st["count"] == 6
    want = _by_key(state)
    got = dict(tree_flatten_with_path({k: v for k, v in st.items()
                                       if k != "count"}))
    assert set(want) - {"count"} == set(got)
    for k, v in got.items():
        assert want[k].shape == (1, 1, v.numel())
        np.testing.assert_array_equal(want[k].reshape(-1), v.numpy(),
                                      err_msg=k)
    sess.checkpoint(step=7)
    sess.close()
    assert _layout(_manifest(d, 7)) == _layout(_manifest(d, 6))


def test_dist_port_checkpoint_restores_in_the_reference(tmp_path, models,
                                                        group):
    jm, tm = models
    d = str(tmp_path)
    sess = _port_dist_session(tm, group, d, ckpt_every=2)
    with sess:
        sess.run(2)
    st = sess.state
    like = _reference_dist_state(jm, np.random.default_rng(2))
    back = jstore.restore(d, like)
    assert int(back["count"]) == 2
    got = _by_key(back)
    for k, v in tree_flatten_with_path({k: v for k, v in st.items()
                                        if k != "count"}):
        np.testing.assert_array_equal(got[k].reshape(-1), v.numpy(),
                                      err_msg=k)
    jstore.save(d, like, step=9)
    assert _layout(_manifest(d, 9)) == _layout(_manifest(d, 2))
