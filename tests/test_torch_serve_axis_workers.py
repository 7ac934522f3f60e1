"""The sharded serving step (``repro_torch.dist.serve``) on four gloo
ranks (the harness of ``tests/test_torch_dist_hier_workers.py``) against
the JAX package, at smoke size: yi-6b on ``(data=2, model=2)`` and
``(data=1, model=4)``, gemma2-2b (sliding windows of 16 across the
shards' 16-position halves) and whisper-small (its cross caches filled
by the reference's ``prefill_encoder``) on ``(2, 2)``; the SSM, hybrid
and MoE families in ``tests/test_torch_serve_axis_families_workers.py``.
Every run takes ``ServeConfig(weight_k=6, worker_axes=("data",))`` and
the reference's ``model.init(PRNGKey(0))`` through
``convert.params_from_numpy``, each rank its model shard. Tier 1.

The reference's own sharded-serve tests do not run on this jax
(ROADMAP.md queue 3), so the port is held against the reference's
single-device ``Model.decode_step`` and ``Model.prefill`` on the tree
Q_x'd a shard at a time (``tests/dist_scripts/serve_equiv.py``'s
``qx_shardwise``: what the int8 gather gives). Gates:

  * decode: 6 steps of 4 slots, logits within rtol 1e-4 / atol 1e-5
    (the logits tier: the combine reassociates the softmax sums across
    the shards) and bitwise equal across the ranks;
  * paged: the pool split over the model axis, serve_equiv's scrambled
    table (page 8), bitwise the fixed-lane mesh decode (hymba: 1e-5 /
    1e-6, the meta prefix on shard 0 splits the columns differently);
    a planted fault, every shard counting every page (the ownership
    mask dropped), must fail the gate;
  * session: ``ServeSession(decode_fn=step)`` greedy tokens equal a
    batch-synchronous loop over the same step;
  * prefill: kind "prefill" against the reference's unsharded
    ``Model.prefill``, logits and gathered caches at the logits tier;
  * whisper: the mesh ``prefill_encoder`` (frames over the model axis)
    against the reference's on the Q_x tree, at the logits tier.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_dist_hier_workers as H

B, S_MAX, STEPS, PS = 4, 32, 6, 8
K_X = 6
TOL = dict(rtol=1e-4, atol=1e-5)          # the logits tier
META_TOL = dict(rtol=1e-5, atol=1e-6)     # serve_equiv's hymba tier
MAX_NEW = 5
MODULE = "test_torch_serve_axis_workers"
# name -> (arch, (data, model))
RUNS = {"yi-6b@2x2": ("yi-6b", (2, 2)), "yi-6b@1x4": ("yi-6b", (1, 4)),
        "gemma2-2b@2x2": ("gemma2-2b", (2, 2)),
        "whisper-small@2x2": ("whisper-small", (2, 2))}


def _tokens(cfg, seed, S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _audio(cfg):
    rng = np.random.default_rng(2)
    return rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)


def _prefill_cfg(cfg):
    """The prefill's config: MoE with ``capacity_factor=16.0`` (no pair
    dropped; which pairs a shard drops depends on how the sequence is
    split, as the reference's cp_equiv.py notes), else the config."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


# ---------------------------------------------------------------------------
# the reference, in a subprocess
# ---------------------------------------------------------------------------

def _reference_main(out_dir: str, runs) -> None:
    """Subprocess body: for each run its parameters, and the reference's
    single-device decode logits, prefill logits and caches (and
    whisper's cross caches) on the tree Q_x'd a model shard at a time."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.dist import sharding as JSH
    from repro.kernels import ref as KREF
    from repro.models.model import Model as JModel
    for name, (arch, (data, nm)) in runs.items():
        cfg = jget(arch, smoke=True)
        model = JModel(cfg)
        params = model.init(jax.random.PRNGKey(0))
        layout = JSH.build_layout(jax.eval_shape(model.init,
                                                 jax.random.PRNGKey(0)), nm)

        def qx(p):
            scale = jnp.maximum(jnp.max(jnp.abs(p)), 1e-30)
            codes = KREF.uniform_quantize(p, scale, K_X)
            return KREF.uniform_dequantize(codes, scale, K_X).astype(p.dtype)

        def qx_shardwise(p, dim, stk):
            if dim == JSH.REPLICATED:
                return p
            off = 1 if stk else 0
            d = dim + off if dim >= 0 else off
            return jnp.concatenate([qx(h) for h in jnp.split(p, nm, axis=d)],
                                   axis=d)
        qparams = jax.tree.map(qx_shardwise, params, layout.dims,
                               layout.stacked)
        out = {"params": np.array(jax.tree.map(np.asarray, params),
                                  dtype=object)}
        toks = jnp.asarray(_tokens(cfg, 5, STEPS))
        enc = cfg.encoder_seq or 0
        cache = model.init_cache(B, max_seq_local=S_MAX,
                                 encoder_seq_local=enc)
        if cfg.arch_type == "encdec":
            audio = jnp.asarray(_audio(cfg))
            cache = model.prefill_encoder(params, audio, cache)
            out["ck"], out["cv"] = np.asarray(cache["ck"]), \
                np.asarray(cache["cv"])
            qc = model.prefill_encoder(qparams, audio, model.init_cache(
                B, max_seq_local=S_MAX, encoder_seq_local=enc))
            out["qck"], out["qcv"] = np.asarray(qc["ck"]), np.asarray(qc["cv"])
        dec = jax.jit(lambda p, i, c, pos: model.decode_step(p, i, c, pos))
        # MoE: each worker's rows alone, as its slots are routed together
        # (the capacity is a function of the tokens routed in one call)
        groups = data if cfg.moe is not None else 1
        b = B // groups
        for g in range(groups):
            rows = slice(g * b, (g + 1) * b)
            c = jax.tree.map(lambda x: x[:, rows] if x.ndim > 1 else x,
                             cache)
            for t in range(STEPS):
                lg, c = dec(qparams, {"token": toks[rows, t:t + 1]}, c,
                            jnp.int32(t))
                out.setdefault(f"decode{t}", []).append(np.asarray(lg))
        for t in range(STEPS):
            out[f"decode{t}"] = np.concatenate(out[f"decode{t}"])
        if cfg.moe is not None:
            # whether the whole batch routed together drops differently
            c = cache
            full = []
            for t in range(STEPS):
                lg, c = dec(qparams, {"token": toks[:, t:t + 1]}, c,
                            jnp.int32(t))
                full.append(np.max(np.abs(np.asarray(lg)
                                          - out[f"decode{t}"])))
            out["whole_batch_max_abs"] = np.asarray(max(full))
        if cfg.arch_type != "encdec":
            pmodel = JModel(_prefill_cfg(cfg))
            lg, pc = pmodel.prefill(
                qparams, {"tokens": jnp.asarray(_tokens(cfg, 9, S_MAX))},
                max_seq_local=S_MAX)
            out["prefill_logits"] = np.asarray(lg)
            for k, v in pc.items():
                out[f"prefill:{k}"] = np.asarray(v)
        H._save(os.path.join(out_dir, f"ref_{name}.npz"), **out)


def start_reference(tmp_path_factory, runs):
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path.insert(0, {str(H.HERE)!r}); "
            f"import {MODULE} as t; "
            f"t._reference_main({str(out)!r}, {runs!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc


def stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()


# ---------------------------------------------------------------------------
# the port, four gloo ranks
# ---------------------------------------------------------------------------

class _Alive:
    @staticmethod
    def poll():
        return None


def _decode(step, params, cache, toks, steps=STEPS):
    out = []
    for t in range(steps):
        lg, _ = step(params, {"token": torch.from_numpy(toks[:, t:t + 1])},
                     cache, t)
        out.append(lg.numpy().copy())
    return out


def _paged(step, model, params, toks):
    """(fixed-lane logits, paged logits): the same step over fixed lanes
    and over a pool of B * npag pages split over the model axis, with
    serve_equiv's scrambled table."""
    npag = S_MAX // PS
    num_pages = B * npag
    whole = model.init_cache(B, S_MAX, page_pool=(num_pages, PS),
                             device="cpu")
    perm = np.random.default_rng(7).permutation(num_pages).astype(np.int32)
    whole["ptab"].copy_(torch.from_numpy(perm.reshape(B, npag)))
    paged = step.shard_cache(whole)
    fixed = step.init_cache(B, S_MAX, device="cpu")
    return (_decode(step, params, fixed, toks),
            _decode(step, params, paged, toks))


def _batch_sync(step, params, toks):
    """Greedy tokens of a batch-synchronous loop over the step: the
    prompts fed a position at a time, then MAX_NEW generated tokens."""
    cache = step.init_cache(B, S_MAX, device="cpu")
    cur = torch.from_numpy(toks[:, :1])
    got = [[] for _ in range(B)]
    for t in range(toks.shape[1] + MAX_NEW - 1):
        lg, _ = step(params, {"token": cur}, cache, t)
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)
        if t + 1 < toks.shape[1]:
            cur = torch.from_numpy(toks[:, t + 1:t + 2])
        else:
            for i in range(B):
                got[i].append(int(nxt[i]))
            cur = nxt[:, None]
    return np.asarray(got)


def serve_body(rank, out_dir, ref_dir, module, names):
    """Each run ``names`` of ``module``'s RUNS on this rank."""
    import importlib
    from pathlib import Path

    from repro_torch.configs import get_config as tget
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.serve import ServeConfig, make_serve_step
    from repro_torch.launch import mesh as TM
    from repro_torch.models.model import Model
    from repro_torch.serve.session import Request, ServeSession
    runs = importlib.import_module(module).RUNS
    torch.set_grad_enabled(False)
    out = {}
    sc = ServeConfig(weight_k=K_X, worker_axes=("data",))
    for name in names:
        arch, (data, nm) = runs[name]
        cfg = tget(arch, smoke=True)
        model = Model(cfg)
        grid = TM.make_grid(data=data, model=nm, device="cpu")
        step, _, _ = make_serve_step(model, grid, sc, "decode")
        ref = np.load(H.wait_for(Path(ref_dir) / f"ref_{name}.npz",
                                 _Alive()), allow_pickle=True)
        params = params_from_numpy(ref["params"].item(), "cpu",
                                   layout=step.layout, index=grid.model_index)
        toks = _tokens(cfg, 5, STEPS)
        enc = cfg.encoder_seq or 0
        cache = step.init_cache(B, S_MAX, device="cpu", encoder_seq=enc)
        if cfg.arch_type == "encdec":
            part = step.shard_cache({k: torch.from_numpy(ref[k])
                                     for k in ("ck", "cv")})
            cache["ck"].copy_(part["ck"])
            cache["cv"].copy_(part["cv"])
            mine = step.init_cache(B, S_MAX, device="cpu", encoder_seq=enc)
            step.prefill_encoder(params, torch.from_numpy(_audio(cfg)), mine)
            whole = step.gather_cache({k: mine[k] for k in ("ck", "cv")})
            out[f"{name}:qck"] = whole["ck"].numpy()
            out[f"{name}:qcv"] = whole["cv"].numpy()
        for t, lg in enumerate(_decode(step, params, cache, toks)):
            out[f"{name}:decode{t}"] = lg
        if cfg.arch_type not in ("ssm", "encdec"):
            fixed, paged = _paged(step, model, params, toks)
            out.update({f"{name}:fixed{t}": x for t, x in enumerate(fixed)})
            out.update({f"{name}:paged{t}": x for t, x in enumerate(paged)})
            # the planted fault: every shard counts every page
            honest = Model._paged_writes

            def every_page(self, *a, **kw):
                w, own, pos, ptab = honest(self, *a, **kw)
                return w, torch.ones_like(own), pos, ptab
            Model._paged_writes = every_page
            try:
                _, bad = _paged(step, model, params, toks)
            finally:
                Model._paged_writes = honest
            out.update({f"{name}:planted{t}": x for t, x in enumerate(bad)})
        if cfg.arch_type != "encdec":
            out[f"{name}:loop"] = _batch_sync(step, params, toks)
            sess = ServeSession(model, params, slots=B, max_seq=S_MAX,
                                decode_fn=step, device="cpu")
            hs = [sess.submit(Request(prompt=[int(x) for x in row],
                                      max_new_tokens=MAX_NEW))
                  for row in toks]
            res = sess.drain()
            out[f"{name}:session"] = np.asarray([res[h].tokens for h in hs])
            out[f"{name}:session_stats"] = np.asarray(
                [sess.stats["dispatches"], sess.stats["admitted"]])
            pmodel = Model(_prefill_cfg(cfg))
            pstep, _, _ = make_serve_step(pmodel, grid, sc, "prefill")
            lg, pc = pstep(params, {"tokens": torch.from_numpy(
                _tokens(cfg, 9, S_MAX))})
            out[f"{name}:prefill_logits"] = lg.numpy()
            for k, v in pc.items():
                out[f"{name}:prefill:{k}"] = v.numpy()
    return out


def start_serve(tmp_path_factory, module, runs):
    """The reference subprocess and four spawned ranks for ``runs``:
    yields (ranks, ref_dir)."""
    ref, proc = start_reference(tmp_path_factory, runs)
    try:
        ranks = H.spawn(module, "serve_body",
                        tmp_path_factory.mktemp("port"),
                        (str(ref), module, tuple(runs)))
        for name in runs:
            H.wait_for(ref / f"ref_{name}.npz", proc)
        yield ranks, ref
    finally:
        stop(proc)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    yield from start_serve(tmp_path_factory, MODULE, RUNS)


def _ref(ref_dir, name):
    return np.load(ref_dir / f"ref_{name}.npz", allow_pickle=True)


# ---------------------------------------------------------------------------
# gates, shared with the families' module
# ---------------------------------------------------------------------------

def check_decode(ranks, ref_dir, name):
    ref = _ref(ref_dir, name)
    worst = 0.0
    for t in range(STEPS):
        got = ranks[0][f"{name}:decode{t}"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{name}:decode{t}"], got)
        want = ref[f"decode{t}"]
        np.testing.assert_allclose(got, want, err_msg=f"{name} t={t}", **TOL)
        worst = max(worst, float(np.max(np.abs(got - want))))
    print(f"{name}: decode max abs {worst:.3e}", end="")
    if "whole_batch_max_abs" in ref.files:
        print(f"; the whole batch routed together differs by "
              f"{float(ref['whole_batch_max_abs']):.3e}", end="")
    print()


def paged_equal(ranks, name, cfg_meta: bool, key: str = "paged") -> bool:
    """Whether the ranks' ``key`` logits equal the fixed-lane mesh
    decode (bitwise; with meta tokens within META_TOL)."""
    for r in ranks:
        for t in range(STEPS):
            a, b = r[f"{name}:fixed{t}"], r[f"{name}:{key}{t}"]
            ok = (np.allclose(b, a, **META_TOL) if cfg_meta
                  else np.array_equal(a, b))
            if not ok:
                return False
    return True


def check_prefill(ranks, ref_dir, name):
    ref = _ref(ref_dir, name)
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}:prefill_logits"],
                                   ref["prefill_logits"], err_msg=name, **TOL)
        keys = [k for k in ref.files if k.startswith("prefill:")]
        assert keys and sorted(keys) == sorted(
            k[len(name) + 1:] for k in r if k.startswith(f"{name}:prefill:"))
        for k in keys:
            np.testing.assert_allclose(r[f"{name}:{k}"], ref[k],
                                       err_msg=f"{name} {k}", **TOL)


def check_session(ranks, name):
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}:session"], r[f"{name}:loop"])
        np.testing.assert_array_equal(r[f"{name}:session"],
                                      ranks[0][f"{name}:session"])
    assert ranks[0][f"{name}:session_stats"][1] == B


# ---------------------------------------------------------------------------
# this module's tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_decode_matches_the_reference(served, name):
    ranks, ref = served
    check_decode(ranks, ref, name)


@pytest.mark.parametrize("name", [n for n in RUNS if "whisper" not in n])
def test_paged_mesh_decode_is_the_fixed_lane_decode(served, name):
    ranks, _ = served
    assert paged_equal(ranks, name, False)


@pytest.mark.parametrize("name", [n for n in RUNS if "whisper" not in n])
def test_planted_fault_every_shard_counts_every_page(served, name):
    ranks, _ = served
    assert not paged_equal(ranks, name, False, "planted")


@pytest.mark.parametrize("name", [n for n in RUNS if "whisper" not in n])
def test_session_tokens_equal_the_batch_synchronous_loop(served, name):
    ranks, _ = served
    check_session(ranks, name)


@pytest.mark.parametrize("name", [n for n in RUNS if "whisper" not in n])
def test_prefill_matches_the_reference(served, name):
    ranks, ref = served
    check_prefill(ranks, ref, name)


def test_whisper_prefill_encoder_matches_the_reference(served):
    ranks, ref_dir = served
    ref = _ref(ref_dir, "whisper-small@2x2")
    for r in ranks:
        for k in ("qck", "qcv"):
            np.testing.assert_allclose(r[f"whisper-small@2x2:{k}"], ref[k],
                                       err_msg=k, **TOL)
