"""The sharded serving step's pieces in one process on the CPU
(``repro_torch.dist.serve``, ``layers.decode_attention``'s combine, the
paged ownership mask, the refusals), against the JAX package. Tier 1.

  * ``_cache_specs_for`` for every arch type, the batch split and not,
    against the reference's ``PartitionSpec``s (the dim each worker and
    the model axis name);
  * ``decode_attention`` with the cache cut into n = 2 and 4 column
    shards, the shards run as threads whose all-reduces meet in a stub
    of ``collectives.all_reduce``, against the unsharded call: rtol 1e-6
    / atol 1e-6 in float32 (the combine rescales each shard's partial
    sums by exp(l - l_max) and adds them across the shards: a few
    float32 roundings of a reassociated sum of O(1) values, at most
    3.6e-7 absolute on outputs that cancel down to ~1e-2, where atol
    1e-7 is below one ulp of 1.0), every shard bitwise the same; hymba's
    meta prefix counted once;
  * planted faults fail those gates: the combine with w = 1 (no rescale
    by exp(l - l_max)), the meta prefix counted on every shard;
  * the paged ownership mask with a scrambled table over 2 pool shards
    counts each page exactly once, and each token's write lands on one
    shard;
  * at one rank (a gloo group of one, ``make_grid(data=1, model=1)``)
    the mesh decode is bitwise the local ``decode_step`` on the tree
    after the one-shard gather's per-leaf Q_x round trip, for every arch
    type, and the mesh prefill bitwise ``Model.prefill`` on it. At one
    shard the layout (the reference's ``build_layout``) replicates every
    leaf but the MoE expert stacks, so only those take the round trip;
    ``test_one_rank_layout_round_trips_only_the_experts`` pins that;
  * the refusals, with the reference's messages: a paged session or
    ``QuantizedParams`` with ``decode_fn``, a sharded ``decode_chunk``,
    an encoder-decoder "prefill";
  * ``ServeConfig``'s fields and defaults are the reference's, and
    ``dist.step`` re-exports ``make_serve_step`` and ``_cache_specs_for``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.serve import ServeConfig, _cache_specs_for
from repro_torch.dist.serve import make_serve_step
from repro_torch.launch import mesh as TM
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

ARCH_OF = {"dense": "yi-6b", "vlm": "llava-next-mistral-7b",
           "moe": "deepseek-moe-16b", "ssm": "mamba2-2.7b",
           "hybrid": "hymba-1.5b", "encdec": "whisper-small"}
# the combine adds each shard's partial sums of O(1) values in another
# order: the outputs, weighted means that cancel down to ~1e-2, carry a
# few ulp of the values' scale (at most 3.6e-7 measured over these
# cases), so the absolute tier is 1e-6 (8 ulp of 1.0), not 1e-7
COMBINE_TOL = dict(rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def _split_of(spec, b0):
    """A reference PartitionSpec -> (worker dim, model dim); the worker
    axes are named by their tuple, or (jax normalizes a one-axis tuple)
    by the axis."""
    entries = tuple(spec)
    names = set()
    if b0:
        names = {tuple(b0)} | ({b0[0]} if len(b0) == 1 else set())
    worker = next((i for i, e in enumerate(entries) if e in names), None)
    model = next((i for i, e in enumerate(entries) if e == "model"), None)
    return worker, model


@pytest.mark.parametrize("b0", [("data",), ("pod", "data"), None],
                         ids=["data", "pod-data", "whole"])
@pytest.mark.parametrize("arch_type", list(ARCH_OF))
def test_cache_specs_match_the_reference(arch_type, b0):
    from repro.configs import get_config as jget
    from repro.dist.serve import _cache_specs_for as j_specs
    arch = ARCH_OF[arch_type]
    cfg = tget(arch, smoke=True)
    assert cfg.arch_type == arch_type
    want = j_specs(jget(arch, smoke=True), b0)
    got = _cache_specs_for(cfg, b0)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name]) == _split_of(spec, b0), name


# ---------------------------------------------------------------------------
# the combine, shards as threads
# ---------------------------------------------------------------------------

class _Rank:
    """A shard's stand-in for its model group: the shared meeting place
    and this shard's place in it."""

    def __init__(self, meet, index):
        self.meet, self.index = meet, index


class _Meet:
    """All-reduces among n threads, summed (or maxed) in rank order."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def all_reduce(self, x, group, op="sum"):
        self.slots[group.index] = x.clone()
        self.barrier.wait()
        acc = self.slots[0]
        for s in self.slots[1:]:
            acc = torch.maximum(acc, s) if op == "max" else acc + s
        self.barrier.wait()
        x.copy_(acc)
        return x


def _attention_case(seed, meta):
    g = torch.Generator().manual_seed(seed)
    B, S, H, K, hd, M = 4, 32, 4, 2, 16, 3
    q = torch.randn(B, 1, H, hd, generator=g)
    kc = torch.randn(B, S, K, hd, generator=g)
    vc = torch.randn(B, S, K, hd, generator=g)
    tl = torch.tensor([32, 17, 5, 1])
    mkv = None
    if meta:
        mkv = (torch.randn(B, M, K, hd, generator=g),
               torch.randn(B, M, K, hd, generator=g))
    return q, kc, vc, tl, mkv


def _sharded(n, q, kc, vc, tl, mkv, kw, monkeypatch):
    meet = _Meet(n)
    monkeypatch.setattr(C, "all_reduce", meet.all_reduce)
    S = kc.shape[1]
    s = S // n
    outs, errs = [None] * n, []

    def run(r):
        try:
            ctx = L.ShardCtx(cp_group=_Rank(meet, r), cp_size=n, cp_rank=r)
            outs[r] = L.decode_attention(
                q, kc[:, r * s:(r + 1) * s], vc[:, r * s:(r + 1) * s],
                total_len=tl, meta_kv=mkv, ctx=ctx, **kw)
        except Exception as e:       # noqa: BLE001 - re-raised below
            errs.append(e)
            meet.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs


def _combine_gate(n, meta, kw, monkeypatch, seed=0) -> bool:
    """Whether every shard's output is bitwise the others' and within
    COMBINE_TOL of the unsharded call."""
    q, kc, vc, tl, mkv = _attention_case(seed, meta)
    want = L.decode_attention(q, kc, vc, total_len=tl, meta_kv=mkv, **kw)
    outs = _sharded(n, q, kc, vc, tl, mkv, kw, monkeypatch)
    same = all(torch.equal(o, outs[0]) for o in outs)
    return same and np.allclose(outs[0].numpy(), want.numpy(),
                                **COMBINE_TOL)


KWS = {"global": {}, "window": dict(window=8),
       "softcap": dict(softcap=5.0, window=12)}


@pytest.mark.parametrize("kw", list(KWS))
@pytest.mark.parametrize("meta", [False, True], ids=["plain", "meta"])
@pytest.mark.parametrize("n", [2, 4])
def test_combine_equals_the_unsharded_call(n, meta, kw, monkeypatch):
    assert _combine_gate(n, meta, KWS[kw], monkeypatch)


@pytest.mark.parametrize("n", [2, 4])
def test_planted_combine_without_rescale_fails(n, monkeypatch):
    def no_rescale(o, denom, l_safe, ctx):
        buf = torch.cat([o.reshape(-1), denom.reshape(-1)])
        C.all_reduce(buf, ctx.cp_group)
        return (buf[:o.numel()].reshape(o.shape),
                buf[o.numel():].reshape(denom.shape))
    monkeypatch.setattr(L, "_combine", no_rescale)
    assert not _combine_gate(n, False, {}, monkeypatch)


@pytest.mark.parametrize("n", [2, 4])
def test_planted_meta_on_every_shard_fails(n, monkeypatch):
    monkeypatch.setattr(L, "_meta_valid", lambda ctx: True)
    assert not _combine_gate(n, True, {}, monkeypatch)


# ---------------------------------------------------------------------------
# the paged ownership mask
# ---------------------------------------------------------------------------

def test_paged_ownership_counts_each_page_once():
    cfg = tget("yi-6b", smoke=True)
    model = Model(cfg)
    B, S, ps, n = 4, 32, 8, 2
    npag = S // ps
    P = B * npag
    perm = np.random.default_rng(7).permutation(P).astype(np.int32)
    ptab = torch.from_numpy(perm.reshape(B, npag))
    ptab[3, 2:] = P                     # a released tail: no shard's page
    q_pos = torch.tensor([[0], [9], [20], [31]], dtype=torch.int32)
    valid = torch.ones_like(q_pos, dtype=torch.bool)
    owns, oks = [], []
    for r in range(n):
        cache = {"pk": torch.zeros(1, P // n, ps, 1, 1), "ptab": ptab}
        write, own, pos, local = model._paged_writes(cache, q_pos, valid,
                                                     r * (P // n))
        assert torch.equal(local, ptab - r * (P // n))
        owns.append(own.to(torch.int32))
        oks.append(write.ok.to(torch.int32))
    held = (ptab < P)[:, :, None].expand(B, npag, ps).reshape(B, -1)
    assert torch.equal(sum(owns), held.to(torch.int32))
    # token 3 sits on its released tail: no shard writes it
    assert sum(oks).tolist() == [1, 1, 1, 0]


# ---------------------------------------------------------------------------
# one rank: the mesh step against the local model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield TM.make_grid(data=1, model=1, device="cpu")
    TM.close_process_group()
    torch.set_num_threads(n)


def _round_trip(step, params, k_x):
    """The tree after a per-leaf Q_x round trip: what one shard's gather
    gives."""
    def one(p, d, s):
        ax = SH.axis_of(d, s)
        return p if ax is None else C.quantized_gather_shard(p, ax, 1, k_x,
                                                             False)
    return tree_map(one, params, step.layout.dims, step.layout.stacked)


@pytest.mark.parametrize("arch_type", list(ARCH_OF))
def test_one_rank_mesh_decode_is_the_local_decode(grid, arch_type):
    cfg = tget(ARCH_OF[arch_type], smoke=True)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    sc = ServeConfig(weight_k=6, worker_axes=("data",))
    step, specs, (ispecs, cspecs) = make_serve_step(model, grid, sc)
    assert set(cspecs) == set(_cache_specs_for(cfg, ("data",)))
    qp = _round_trip(step, params, 6)
    B, S, enc = 4, 32, cfg.encoder_seq or 0
    mesh = step.init_cache(B, S, device="cpu", encoder_seq=enc)
    local = model.init_cache(B, S, device="cpu", encoder_seq_local=enc)
    assert {k: v.shape for k, v in mesh.items()} == \
        {k: v.shape for k, v in local.items()}
    if cfg.arch_type == "encdec":
        audio = torch.randn(B, enc, cfg.d_model,
                            generator=torch.Generator().manual_seed(2))
        step.prefill_encoder(step.shard_params(params), audio, mesh)
        model.prefill_encoder(qp, audio, local)
        assert torch.equal(mesh["ck"], local["ck"])
    rng = np.random.default_rng(5)
    dev = {}
    if cfg.input_mode == "embeddings":
        seq = torch.from_numpy(rng.normal(size=(B, 4, cfg.d_model)).astype(
            np.float32))
        feed = [{"embeds": seq[:, t:t + 1]} for t in range(4)]
    else:
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(B, 4)).astype(np.int32))
        feed = [{"token": toks[:, t:t + 1]} for t in range(4)]
    for t, inp in enumerate(feed):
        pos = torch.full((B,), t, dtype=torch.int32) if t % 2 else t
        a, _ = step(step.shard_params(params), inp, mesh, pos)
        b, _ = model.decode_step(qp, inp, local, pos, **dev)
        assert torch.equal(a, b), (arch_type, t)


@pytest.mark.parametrize("arch_type", list(ARCH_OF))
def test_one_rank_layout_round_trips_only_the_experts(grid, arch_type):
    """The leaves the one-shard gather Q_x's: the expert stacks, as the
    reference's layout at one shard (every other leaf replicated)."""
    from repro.configs import get_config as jget
    from repro.dist import sharding as JSH
    from repro.models.model import Model as JModel
    import jax
    arch = ARCH_OF[arch_type]
    model = Model(tget(arch, smoke=True))
    step, _, _ = make_serve_step(model, grid, ServeConfig(weight_k=6))
    jm = JModel(jget(arch, smoke=True))
    jl = JSH.build_layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), 1)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): d
            for path, d in jax.tree_util.tree_flatten_with_path(jl.dims)[0]}
    got = {"/".join(path): d
           for path, (d, _) in SH.dims_by_path(step.layout).items()}
    assert got == want
    moved = sorted(k for k, d in got.items() if d != SH.REPLICATED)
    assert moved == sorted(k for k in got if "/moe/" in k and "shared"
                           not in k and k.split("/")[-1] in (
                               "w_gate", "w_up", "w_down"))
    assert bool(moved) == (arch_type == "moe")


@pytest.mark.parametrize("arch_type", ["dense", "moe", "hybrid"])
def test_one_rank_mesh_prefill_is_the_local_prefill(grid, arch_type):
    cfg = tget(ARCH_OF[arch_type], smoke=True)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    step, _, (_, cspecs) = make_serve_step(
        model, grid, ServeConfig(weight_k=7), "prefill")
    assert set(cspecs) <= {"k", "v", "ssm", "conv"}
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32))
    lg, cache = step(params, {"tokens": toks})
    wl, wc = model.prefill(_round_trip(step, params, 7), {"tokens": toks},
                           max_seq_local=16)
    assert torch.equal(lg, wl)
    assert sorted(cache) == sorted(wc)
    for k in cache:
        assert torch.equal(cache[k], wc[k]), k


def test_one_rank_mesh_session_drains(grid):
    from repro_torch.serve.session import Request, ServeSession
    cfg = tget("hymba-1.5b", smoke=True)
    model = Model(cfg)
    params = model.init(seed=0, device="cpu")
    step, _, _ = make_serve_step(model, grid, ServeConfig(weight_k=6))
    sess = ServeSession(model, step.shard_params(params), slots=2,
                        max_seq=32, decode_fn=step, device="cpu",
                        prefill="chunked")
    hs = [sess.submit(Request(prompt=[3, 4, 5, 6], max_new_tokens=4))
          for _ in range(3)]
    res = sess.drain()
    assert [len(res[h].tokens) for h in hs] == [4, 4, 4]
    assert res[hs[0]].tokens == res[hs[2]].tokens   # a reused slot
    assert sess.stats["chunk_dispatches"] == 0       # injected


# ---------------------------------------------------------------------------
# refusals, with the reference's messages
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return type(e.value), str(e.value)


@pytest.fixture(scope="module")
def jax_yi():
    import jax
    from repro.configs import get_config as jget
    from repro.models.model import Model as JModel
    jm = JModel(jget("yi-6b", smoke=True))
    return jm, jm.init(jax.random.PRNGKey(0))


def test_paged_session_with_decode_fn_is_refused(jax_yi):
    from repro.serve import ServeSession as JSession
    from repro_torch.serve.session import ServeSession
    jm, jp = jax_yi
    model = Model(tget("yi-6b", smoke=True))
    params = model.init(seed=0, device="cpu")
    want = _message(lambda: JSession(jm, jp, paged=True,
                                     decode_fn=lambda *a: None))
    got = _message(lambda: ServeSession(model, params, paged=True,
                                        decode_fn=lambda *a, **k: None,
                                        device="cpu"))
    assert got == want


def test_quantized_params_with_decode_fn_are_refused(jax_yi):
    from repro.serve import ServeSession as JSession
    from repro.serve.quantized import quantize_params as j_quantize
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.serve.session import ServeSession
    jm, jp = jax_yi
    model = Model(tget("yi-6b", smoke=True))
    params = model.init(seed=0, device="cpu")
    want = _message(lambda: JSession(jm, j_quantize(jp),
                                     decode_fn=lambda *a: None))
    got = _message(lambda: ServeSession(model, quantize_params(params),
                                        decode_fn=lambda *a, **k: None,
                                        device="cpu"))
    assert got == want


def test_sharded_decode_chunk_is_refused(jax_yi):
    import jax.numpy as jnp
    from repro.models.layers import ShardCtx as JCtx
    jm, jp = jax_yi
    model = Model(tget("yi-6b", smoke=True))
    params = model.init(seed=0, device="cpu")
    cache = model.init_cache(1, 16, device="cpu")
    want = _message(lambda: jm.decode_chunk(
        jp, {"token": jnp.zeros((1, 4), jnp.int32)},
        jm.init_cache(1, 16), jnp.zeros(1, jnp.int32),
        jnp.ones(1, jnp.int32), JCtx(cp_axis="model", cp_size=2)))
    got = _message(lambda: model.decode_chunk(
        params, {"token": torch.zeros(1, 4, dtype=torch.int32)}, cache,
        torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
        ctx=L.ShardCtx(cp_group=object(), cp_size=2)))
    assert got == want


def test_encdec_prefill_is_refused(grid):
    import jax
    from repro.configs import get_config as jget
    from repro.dist.serve import make_serve_step as j_make
    from repro.dist.step import ServeConfig as JServeConfig
    from repro.models.model import Model as JModel
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = _message(lambda: j_make(JModel(jget("whisper-small", smoke=True)),
                                   mesh, JServeConfig(), "prefill"))
    got = _message(lambda: make_serve_step(
        Model(tget("whisper-small", smoke=True)), grid, ServeConfig(),
        "prefill"))
    assert got == want


def test_serve_config_and_the_compatibility_hook():
    from repro.dist.step import ServeConfig as JServeConfig
    from repro_torch.dist import serve, step
    want = {f.name: f.default for f in dataclasses.fields(JServeConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert got == want
    assert step.make_serve_step is serve.make_serve_step
    assert step._cache_specs_for is serve._cache_specs_for
    with pytest.raises(AttributeError):
        step.no_such_name
