"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped where there is no GPU).

Run on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``. Tiers: quantize and dequantize codes,
scales, page gathers (one pool, a layer's K and V in one launch, and a
pool split over the model axis through ``ptab - page0``),
the Adam+EF passes (moments, Delta+e, amax, codes, residuals, decoded
updates), the wire's encodes and decodes
(K7, #5, K6) and the blockwise codes and scales (#14, #8) bitwise, and
the baselines' training steps through their kernels; the dequant-matmul
in both orientations (K1, K1t) within float32 summation-order tolerance
(f32 activations) or one bf16 ulp plus a floor of K1_FLOOR sqrt(K)
2^-24 |x*w|_2 near zero (bf16 activations), the tier of
``chip_smoke.py``; flash attention (#17) within rtol 1e-4 / atol 1e-5
(float32, 3xTF32 on tensor cores) or one bf16 ulp plus 1e-5 (bfloat16
outputs) of its plain version, both taking float32 sums in orders of
their own. The serving session's decode step as one CUDA graph is
bitwise its eager step (tokens, cache and state), and a capture that
fails raises. The MoE family: a code-resident expert stack's at-use
dequantize through K12 bitwise its plain version, K1 at the routers'
shapes, and ``layers.moe`` bitwise its CUDA graph under both
dispatches; a closed graphed training session gives back its memory
with no garbage collection. The SSM and hybrid family: K1 at mamba2's
and hymba's projection shapes (int8 and 3/4/6-bit lanes, #9's packing
bitwise on the 6,482-wide rows that fill no whole 3- or 6-bit group),
K1t over their 50,280- and 32,001-row heads, and their sessions' decode
step graphed (in the session test above). The reference's random
streams: the threefry kernels (uniform, keys, truncated normal, the
sampling step and its fold) bitwise their plain versions, and the
sampled decode step graphed bitwise eager.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

K1_FLOOR = 8.0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs().to(torch.float32).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("rows,n,k_x", [(1, 4096, 6), (3, 1001, 6),
                                        (4, 2048, 7), (2, 37, 12)])
def test_amax_and_quantize_bitwise(dev, rows, n, k_x):
    from repro_torch.comm import kernels as K
    g = torch.Generator(device=dev).manual_seed(rows * n)
    x = torch.randn(rows, n, generator=g, device=dev) * 3.0
    x[0, 5] = 0.0
    a_k = K.amax_rows(x, backend="cuda")
    a_p = K.amax_rows(x, backend="torch")
    assert torch.equal(a_k, a_p)
    s = torch.clamp_min(a_k, 1e-30)
    c_k = K.uniform_quantize_rows(x, s, k_x, backend="cuda")
    c_p = K.uniform_quantize_rows(x, s, k_x, backend="torch")
    assert c_k.dtype == c_p.dtype and torch.equal(c_k, c_p)


def test_zero_layers_quantize_bitwise(dev):
    """A stacked leaf whose layers are all zero but one (qwen2.5-14b's
    QKV biases at init) through quantize_params on the card: K3's amax
    0 floored to the reference's 1e-30 scale, K4's codes 0, no NaN, the
    other layer's codes and scale bitwise the plain versions'."""
    from repro_torch.serve.quantized import quantize_params
    g = torch.Generator(device=dev).manual_seed(4)
    bq = torch.zeros((48, 5120), dtype=torch.float32, device=dev)
    bq[1] = torch.randn(5120, generator=g, device=dev)
    tree = {"blocks": {"attn": {"bq": bq}}}
    got = quantize_params(tree, k_x=6)["blocks"]["attn"]["bq"]
    want = quantize_params({"blocks": {"attn": {"bq": bq.cpu()}}},
                           k_x=6)["blocks"]["attn"]["bq"]
    assert torch.equal(got.codes.cpu(), want.codes)
    assert torch.equal(got.scale.cpu(), want.scale)
    assert float(got.scale[0]) == float(torch.tensor(1e-30))
    assert not got.codes[0].any() and got.codes[1].any()
    deq = got.layer(0).dequantize()
    assert bool(torch.isfinite(deq).all()) and not deq.any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_pages_bitwise(dev, dtype):
    from repro_torch.serve import paged
    g = torch.Generator(device=dev).manual_seed(0)
    pool = torch.randn(10, 16, 4, 128, generator=g, device=dev).to(dtype)
    tab = torch.tensor([[3, 1, 9, 10], [0, 10, 10, 10], [7, 2, 5, 4]],
                       dtype=torch.int32, device=dev)
    n0 = paged.launches
    a = paged.gather_pages(pool, tab, backend="cuda")
    assert paged.launches == n0 + 1      # one launch, the clamp inside
    b = paged.gather_pages(pool, tab, backend="torch")
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("slots,npag,pages,ps", [
    (3, 4, 10, 16),      # the smoke table, sentinels among the ids
    (4, 8, 32, 16),      # the serving cell's table
    (4, 264, 1056, 16),  # gemma2's 4224-position slots
    (2, 3, 7, 5),        # bf16 pages of 120 bytes: no whole 16-byte words
])
def test_gather_pages_kv_bitwise(dev, dtype, slots, npag, pages, ps):
    """K and V of a layer in one launch, each bitwise the plain gather
    (sentinel ids past the pool and below 0 read a clamped page)."""
    from repro_torch.serve import paged
    g = torch.Generator(device=dev).manual_seed(slots * npag + ps)
    hd = 128 if ps == 16 else 3
    pk = torch.randn(pages, ps, 4, hd, generator=g, device=dev).to(dtype)
    pv = torch.randn(pages, ps, 4, hd, generator=g, device=dev).to(dtype)
    tab = torch.randint(0, pages, (slots, npag), generator=g, device=dev,
                        dtype=torch.int32)
    tab[0, npag // 2:] = pages           # RELEASED sentinel tail
    tab[-1, 0] = -1
    n0, kv0 = paged.launches, paged.launches_kv
    kc, vc = paged.gather_pages_kv(pk, pv, tab, backend="cuda")
    assert (paged.launches, paged.launches_kv) == (n0 + 1, kv0 + 1)
    assert torch.equal(kc, paged.gather_pages(pk, tab, backend="torch"))
    assert torch.equal(vc, paged.gather_pages(pv, tab, backend="torch"))
    assert paged.launches == n0 + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_gather_pages_kv_sharded_pool_bitwise(dev, dtype, n_shards):
    """A pool split over the model axis (``dist.serve``): each shard
    gathers through ``ptab - page0``, whose ids run below 0 and past its
    P / n pages; K2 clamps both ends, bitwise the plain gather."""
    from repro_torch.serve import paged
    slots, npag, ps = 4, 8, 16
    pages = slots * npag
    P = pages // n_shards
    g = torch.Generator(device=dev).manual_seed(n_shards)
    perm = torch.randperm(pages, generator=g, device=dev).to(torch.int32)
    ptab = perm.reshape(slots, npag)
    ptab[1, -2:] = pages                 # RELEASED sentinel tail
    for shard in range(n_shards):
        pk = torch.randn(P, ps, 4, 128, generator=g, device=dev).to(dtype)
        pv = torch.randn(P, ps, 4, 128, generator=g, device=dev).to(dtype)
        local = ptab - shard * P
        assert bool((local < 0).any()) or shard == 0
        assert bool((local >= P).any())
        n0 = paged.launches
        kc, vc = paged.gather_pages_kv(pk, pv, local, backend="cuda")
        assert paged.launches == n0 + 1
        assert torch.equal(kc, paged.gather_pages(pk, local, backend="torch"))
        assert torch.equal(vc, paged.gather_pages(pv, local, backend="torch"))


@pytest.mark.parametrize("bits", [0, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M,K,N", [(1, 256, 512), (4, 512, 96),
                                   (33, 300, 70), (5, 128, 11)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul(dev, bits, M, K, N, x_dtype):
    from repro_torch.comm import bits as B
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(M * K + N + bits)
    k_x = {0: 6, 16: 7}.get(bits, {2: 0, 3: 1, 4: 2, 6: 4}.get(bits))
    lim = 2 ** k_x
    codes = torch.randint(-lim, lim + 1, (K, N), generator=g, device=dev)
    pack_bits = bits if bits in (2, 3, 4, 6) else 0
    if pack_bits:
        codes = torch.clamp(codes, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
        codes = B.pack_rows(codes, bits)
    else:
        codes = codes.to(torch.int16 if bits == 16 else torch.int8)
    scale = torch.tensor(0.37, device=dev)
    x = torch.randn(M, K, generator=g, device=dev).to(x_dtype)
    cast = "bfloat16" if x_dtype == torch.bfloat16 else None
    kw = dict(k_x=k_x, n=N, pack_bits=pack_bits, cast_dtype=cast)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype and a.shape == (M, N)
    if x_dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 ulp, plus a floor at the scale of fp32 summation-order
        # noise (it matters only where the sum cancels to near zero)
        w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=pack_bits,
                             w_dtype="float32", cast_dtype=cast).float()
        norm = (x.float() ** 2 @ w ** 2).sqrt()
        tol = _bf16_ulp(b.float()) + K1_FLOOR * K ** 0.5 * 2.0 ** -24 * norm
        assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.parametrize("bits", [0, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M,V,d", [(1, 256, 512), (4, 1001, 96),
                                   (6, 300, 70), (3, 77, 2304)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_transposed(dev, bits, M, V, d, x_dtype):
    """K1t: x @ W.T from (V, d) code rows, ragged V and d, M past one
    4-row tile."""
    from repro_torch.comm import bits as B
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(M * V + d + bits)
    k_x = {0: 6, 16: 7}.get(bits, {2: 0, 3: 1, 4: 2, 6: 4}.get(bits))
    lim = 2 ** k_x
    codes = torch.randint(-lim, lim + 1, (V, d), generator=g, device=dev)
    pack_bits = bits if bits in (2, 3, 4, 6) else 0
    if pack_bits:
        codes = torch.clamp(codes, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
        codes = B.pack_rows(codes, bits)
    else:
        codes = codes.to(torch.int16 if bits == 16 else torch.int8)
    scale = torch.tensor(0.37, device=dev)
    x = torch.randn(M, d, generator=g, device=dev).to(x_dtype)
    cast = "bfloat16" if x_dtype == torch.bfloat16 else None
    kw = dict(k_x=k_x, n=d, pack_bits=pack_bits, cast_dtype=cast,
              transpose=True)
    n0 = MM.t_launches
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert MM.t_launches == n0 + 1
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype and a.shape == (M, V)
    if x_dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        w = MM.dequant_codes(codes, scale, k_x=k_x, n=d, pack_bits=pack_bits,
                             w_dtype="float32", cast_dtype=cast).float()
        norm = (x.float() ** 2 @ (w ** 2).T).sqrt()
        tol = _bf16_ulp(b.float()) + K1_FLOOR * d ** 0.5 * 2.0 ** -24 * norm
        assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("case", [
    dict(B=2, Sq=130, Skv=130, H=4, K=2, causal=True, window=0,
         softcap=None),
    dict(B=1, Sq=70, Skv=200, H=4, K=1, causal=True, window=0,
         softcap=30.0, q_offset=130),
    dict(B=1, Sq=150, Skv=150, H=2, K=2, causal=True, window=33,
         softcap=50.0),
    dict(B=2, Sq=65, Skv=97, H=4, K=4, causal=False, window=0,
         softcap=None),
    dict(B=1, Sq=40, Skv=100, H=2, K=1, causal=False, window=20,
         softcap=None, q_offset=30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, hd, case, dtype):
    """#17 against its plain version: GQA, causal, window (skipped tiles
    on both sides), softcap, q_offset, ragged Sq and Skv."""
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(hd + case["Sq"])
    q = torch.randn(case["B"], case["Sq"], case["H"], hd, generator=g,
                    device=dev).to(dtype)
    k = torch.randn(case["B"], case["Skv"], case["K"], hd, generator=g,
                    device=dev).to(dtype)
    v = torch.randn(case["B"], case["Skv"], case["K"], hd, generator=g,
                    device=dev).to(dtype)
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["softcap"], q_offset=case.get("q_offset", 0))
    n0 = FA.launches
    a = FA.flash_attention(q, k, v, backend="cuda", **kw)
    assert FA.launches == n0 + 1
    b = FA.flash_attention(q, k, v, backend="torch", **kw)
    assert a.dtype == b.dtype == dtype and a.shape == q.shape
    if dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    else:
        tol = _bf16_ulp(b.float()) + 1e-5
        assert bool(((a.float() - b.float()).abs() <= tol).all())


def test_gemma2_session_runs_through_kernels(dev):
    """The tied head runs K1t from the embedding's codes; no plain
    version on the card."""
    from repro_torch.comm import matmul as MM
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.serve.session import Request, ServeSession
    model = Model(get_config("gemma2-2b", smoke=True))
    params = quantize_params(model.init(seed=0, device=dev), k_x=6,
                             min_numel=256)
    n0, p0 = MM.t_launches, MM.plain_on_cuda
    sess = ServeSession(model, params, slots=2, max_seq=48, paged=True,
                        page_size=8, prefill_chunk=4, device=dev)
    hs = [sess.submit(Request(prompt=list(range(3, 23)), max_new_tokens=5))
          for _ in range(2)]
    res = sess.drain()
    assert all(len(res[h].tokens) == 5 for h in hs)
    assert MM.t_launches > n0 and MM.plain_on_cuda == p0
    assert res[hs[0]].tokens == res[hs[1]].tokens


def test_session_runs_through_kernels(dev):
    from repro_torch.comm import kernels as K
    from repro_torch.comm import matmul as MM
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve import paged
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.serve.session import Request, ServeSession
    model = Model(get_config("yi-6b", smoke=True))
    params = quantize_params(model.init(seed=0, device=dev), k_x=6,
                             min_numel=256)
    n0 = (MM.launches, paged.launches, K.amax_launches)
    sess = ServeSession(model, params, slots=2, max_seq=48, paged=True,
                        page_size=8, prefill_chunk=4, device=dev)
    hs = [sess.submit(Request(prompt=[5, 6, 7, 8, 9], max_new_tokens=5))
          for _ in range(3)]
    res = sess.drain()
    assert all(len(res[h].tokens) == 5 for h in hs)
    assert MM.launches > n0[0] and paged.launches > n0[1]
    assert K.amax_launches > 0
    assert res[hs[0]].tokens == res[hs[1]].tokens == res[hs[2]].tokens
    np.testing.assert_array_equal(sess.free_pages, sess.num_pages)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


def _adam_inputs(dev, n, seed, zero=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    t = [torch.randn(n, generator=g, device=dev) * s
         for s in (1.0, 0.3, 1.0, 1e-4)]
    t[2] = t[2].abs()
    if zero:
        t = [torch.zeros(n, device=dev) for _ in t]
    return t


@pytest.mark.parametrize("n", [1, 127, 1000003])
@pytest.mark.parametrize("k_g", [2, 4, 6, 30, 126])
@pytest.mark.parametrize("zero", [False, True])
def test_adam_ef_passes_bitwise(dev, n, k_g, zero):
    """K15 moments + amax, the scale guard, K16 codes + residual and K11
    decode, each against its plain version on the same inputs."""
    from repro_torch.comm import kernels as K
    from repro_torch.kernels import adam_ef as A
    from repro_torch.opt import engine as E
    g, m, v, e = _adam_inputs(dev, n, n + k_g, zero)
    hp = E.hyperparams(3e-3, 0.99, 1.0 - 0.999 / 3.0, 1e-5, dev)
    a = A.adam_moments(g, m, v, e, hp, backend="cuda")
    b = A.adam_moments(g, m, v, e, hp, backend="torch")
    for x, y in zip(a, b):
        _bits_equal(x, y)
    scale = E.amax_scale(a[3])
    if zero:
        assert float(scale) == 1.0
    c_k, e_k = A.ef_quantize(a[2], scale, k_g, backend="cuda")
    c_p, e_p = A.ef_quantize(a[2], scale, k_g, backend="torch")
    _bits_equal(c_k, c_p)
    _bits_equal(e_k, e_p)
    for s in (scale, -scale):
        _bits_equal(K.log_dequantize(c_k, s, k_g, backend="cuda"),
                    K.log_dequantize(c_k, s, k_g, backend="torch"))


@pytest.mark.parametrize("n", [1, 127, 1000003])
@pytest.mark.parametrize("k_g", [2, 4, 6, 30, 126])
def test_ef_quantize_decision_points_bitwise(dev, n, k_g):
    """K16 on values placed within a few ulps of the grid's decision
    points, zeros, subnormals and values above the scale."""
    from repro_torch.kernels import adam_ef as A
    from repro_torch.opt import grids
    pts = torch.tensor(grids.log_thresholds(k_g) + [0.0, 1e-40, 1.5, 7.0],
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, pts.numel(), (n,), generator=gen, device=dev)
    x = pts[idx].view(torch.int32) + torch.randint(
        -3, 4, (n,), generator=gen, device=dev, dtype=torch.int32)
    x = x.view(torch.float32) * torch.where(
        torch.rand(n, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    scale = torch.tensor(1.0, device=dev)
    for kernel, plain in zip(A.ef_quantize(x, scale, k_g, backend="cuda"),
                             A.ef_quantize(x, scale, k_g, backend="torch")):
        _bits_equal(kernel, plain)


@pytest.mark.parametrize("n", [1, 127, 1000003])
@pytest.mark.parametrize("k_x", [6, 7])
@pytest.mark.parametrize("rows", [1, 3])
def test_uniform_dequantize_bitwise(dev, n, k_x, rows):
    from repro_torch.comm import kernels as K
    from repro_torch.opt import grids
    gen = torch.Generator(device=dev).manual_seed(n + k_x)
    lim = 2 ** k_x
    codes = torch.randint(-lim, lim + 1, (rows, n), generator=gen,
                          device=dev).to(grids.uniform_code_dtype(k_x))
    scale = torch.rand(rows, generator=gen, device=dev) + 0.01
    _bits_equal(K.uniform_dequantize_rows(codes, scale, k_x, backend="cuda"),
                K.uniform_dequantize_rows(codes, scale, k_x,
                                          backend="torch"))


def test_training_runs_through_kernels(dev):
    """Three Algorithm 1 steps of the smoke model on the card: every
    training kernel launches, no plain version runs, the steady step
    makes no host sync, and one update and the Q_x forward params through
    the kernels equal the plain versions' bit for bit."""
    from repro_torch.comm import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import QAdamConfig, apply_updates, qadam
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.kernels import adam_ef as A
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    model = Model(get_config("yi-6b", smoke=True))
    cfg = QAdamConfig(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
                      weight_q_min_numel=2 ** 14)

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt
    K.amax_launches = K.quantize_launches = K.dequantize_launches = 0
    K.log_dequantize_launches = A.moments_launches = 0
    A.ef_quantize_launches = K.plain_on_cuda = A.plain_on_cuda = 0
    sess = TrainSession.from_optimizer(
        qadam(cfg), loss_fn, model.init(seed=0, device=dev),
        batch_for_model(model.cfg, 32, 2), SessionConfig(log_every=3),
        log=lambda *_: 0)
    with sess:
        sess.run(3)
    assert sess.stats["syncs"] == 2 and len(sess.history) == 2
    assert min(K.amax_launches, K.quantize_launches, K.dequantize_launches,
               K.log_dequantize_launches, A.moments_launches,
               A.ef_quantize_launches) > 0
    assert K.plain_on_cuda == A.plain_on_cuda == 0
    st = sess.state
    p = {"embed": st["params"]["embed"]}
    grads = {"embed": p["embed"] * 0.01 + 1e-3}
    outs = []
    for backend in ("cuda", "torch"):
        # update consumes its state (in place): each backend gets a copy
        sub = type(st["opt"])(count=st["opt"].count,
                              key=st["opt"].key.clone(), **{
            f: {"embed": getattr(st["opt"], f)["embed"].clone()}
            for f in ("m", "v", "e")})
        upd, s2 = qadam(dataclasses.replace(cfg, backend=backend)).update(
            grads, sub)
        outs.append((apply_updates(p, upd)["embed"], s2.m["embed"],
                     s2.v["embed"], s2.e["embed"]))
    for x, y in zip(*outs):
        _bits_equal(x, y)
    # the Q_x forward copy of every trained leaf (K3, K4, K12 on the
    # large ones), kernels against plain versions
    fk, fp = (qadam(dataclasses.replace(cfg, backend=backend))
              .forward_params(st["params"]) for backend in ("cuda", "torch"))
    for x, y in zip(tree_leaves(fk), tree_leaves(fp)):
        _bits_equal(x, y)


# the adaptive plan's lanes among them: log:2, log:6, log:30 (6-bit
# lanes), log:126 (8-bit lanes) and k_x = 14 on 16-bit lanes
WIRE_CODECS = [("log", 2), ("log", 4), ("log", 6), ("log", 8),
               ("log", 30), ("log", 126),
               ("uniform", 3), ("uniform", 6), ("uniform", 7),
               ("uniform", 14)]


def _wire_codec(kind, k, absolute=True):
    from repro_torch.comm import codec as CD
    return CD.LogCodec(k_g=k) if kind == "log" else \
        CD.uniform_wire_codec(k, absolute)


def _wire_input(dev, n, seed, kind, zero=False):
    """x and its scale: K15's guarded amax for the log grid, 0.5 for the
    absolute uniform grid with values past it (the lane clip)."""
    from repro_torch.opt import engine as E
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev) * (
        1.0 if kind == "log" else 0.3)
    if zero:
        x.zero_()
    if kind == "log":
        return x, E.amax_scale(x.abs().amax())
    return x, torch.tensor(0.5, device=dev)


@pytest.mark.parametrize("kind,k", WIRE_CODECS, ids=lambda v: str(v))
@pytest.mark.parametrize("c", [1, 7, 1000003])
@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_wire_encode_decode_bitwise(dev, kind, k, c, n_rows):
    """K7 (payload rows, residual) and K6 (decoded rows, a distinct scale
    per row; and straight into a leaf of n elements) against their plain
    versions, the last row short by n_rows - 1 elements."""
    from repro_torch.comm import kernels as K
    codec = _wire_codec(kind, k)
    n = n_rows * c - (n_rows - 1)
    x, scale = _wire_input(dev, n, n_rows * 100 + c + k, kind)
    pk, ek = K.ef_encode_rows(x, scale, codec, n_rows, backend="cuda")
    pp, ep = K.ef_encode_rows(x, scale, codec, n_rows, backend="torch")
    _bits_equal(pk, pp)
    _bits_equal(ek, ep)
    gen = torch.Generator(device=dev).manual_seed(c)
    scales = (torch.rand(n_rows, generator=gen, device=dev) + 0.5) * scale
    dk = K.decode_rows(pk, scales, codec, c, backend="cuda")
    _bits_equal(dk, K.decode_rows(pk, scales, codec, c, backend="torch"))
    out = torch.full((n,), float("nan"), device=dev)
    K.decode_rows(pk, scales, codec, c, backend="cuda", out=out)
    _bits_equal(out, dk.reshape(-1)[:n])


@pytest.mark.parametrize("kind,k", WIRE_CODECS, ids=lambda v: str(v))
def test_wire_zero_and_in_place(dev, kind, k):
    """All-zero input (scale 1 for the log grid), the amax uniform grid,
    and K7's residual written over its input."""
    from repro_torch.comm import kernels as K
    codec = _wire_codec(kind, k)
    x, scale = _wire_input(dev, 4099, k, kind, zero=True)
    for a, b in zip(K.ef_encode_rows(x, scale, codec, 2, backend="cuda"),
                    K.ef_encode_rows(x, scale, codec, 2, backend="torch")):
        _bits_equal(a, b)
    x, scale = _wire_input(dev, 4099, k + 1, kind)
    if kind == "uniform":
        codec = _wire_codec(kind, k, absolute=False)
        scale = x.abs().amax()
    pp, ep = K.ef_encode_rows(x, scale, codec, 3, backend="torch")
    pk, ek = K.ef_encode_rows(x, scale, codec, 3, backend="cuda", out=x)
    assert ek is x
    _bits_equal(pk, pp)
    _bits_equal(ek, ep)


def test_distributed_step_runs_through_kernels(dev):
    """Three steps of the distributed step (one NCCL rank) on the smoke
    model: K7 and K6 of both kinds and K15 launch, no plain version runs,
    the session reads the device only at its two harvests, and the
    master, m, v, e and losses equal Algorithm 1's session (uniform:7
    Q_x, the same init and batches) bit for bit."""
    import torch.distributed as dist
    from repro_torch.comm import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import QAdamConfig, qadam
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.kernels import adam_ef as A
    from repro_torch.launch import mesh
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    model = Model(get_config("yi-6b", smoke=True))
    group = mesh.make_process_group(dev, store=dist.HashStore())
    # both runs with the deterministic kernels PyTorch has (embedding and
    # gather backward); a warning, not an error, where it has none
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tc = TrainConfig(alpha=1e-3, grad_k=6, weight_k=7,
                         weight_absolute=True)
        art = make_train_step(model, group, tc)
        K.ef_encode_log_launches = K.ef_encode_uniform_launches = 0
        K.decode_log_launches = K.decode_uniform_launches = 0
        A.moments_launches = K.plain_on_cuda = A.plain_on_cuda = 0
        sess = TrainSession.from_artifacts(
            art, batch_for_model(model.cfg, 32, 2), SessionConfig(
                log_every=3), device=dev, log=lambda *_: 0)
        with sess:
            sess.run(3)
        assert sess.stats["syncs"] == 2
        assert min(K.ef_encode_log_launches, K.ef_encode_uniform_launches,
                   K.decode_log_launches, K.decode_uniform_launches,
                   A.moments_launches) > 0
        assert K.plain_on_cuda == A.plain_on_cuda == 0
    finally:
        mesh.close_process_group()

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt
    try:
        ref = TrainSession.from_optimizer(
            qadam(QAdamConfig(alpha=1e-3, grad_q="log:6",
                              weight_q="uniform:7",
                              weight_q_min_numel=2 ** 14)),
            loss_fn, model.init(seed=0, device=dev),
            batch_for_model(model.cfg, 32, 2), SessionConfig(log_every=3),
            log=lambda *_: 0)
        with ref:
            ref.run(3)
    finally:
        torch.use_deterministic_algorithms(False)
    assert [h["loss"] for h in sess.history] == \
        [h["loss"] for h in ref.history]
    for a, b in zip(tree_leaves(sess.state["master"]),
                    tree_leaves(ref.state["params"])):
        _bits_equal(a, b.reshape(-1))
    for f in ("m", "v", "e"):
        for a, b in zip(tree_leaves(sess.state[f]),
                        tree_leaves(getattr(ref.state["opt"], f))):
            _bits_equal(a, b.reshape(-1))


ENCODE_CODECS = [("log", 2, False), ("log", 6, False), ("log", 8, False),
                 ("log", 30, False), ("log", 126, False),
                 ("uniform", 3, True), ("uniform", 7, True),
                 ("uniform", 6, False), ("uniform", 7, False),
                 ("uniform", 14, False), ("ternary", 0, False)]


def _encode_codec(kind, k, absolute):
    from repro_torch.comm import codec as CD
    if kind == "ternary":
        return CD.TernaryCodec()
    return _wire_codec(kind, k, absolute)


@pytest.mark.parametrize("kind,k,absolute", ENCODE_CODECS, ids=str)
@pytest.mark.parametrize("c", [1, 7, 1000003])
@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_fused_encode_bitwise(dev, kind, k, absolute, c, n_rows):
    """#5 (K3's amax launch then the encode launch, or the encode alone
    with the absolute scale) against its plain version: payload rows and
    scale, the ternary kind on uniforms from one seeded generator; K6
    decodes the rows bitwise, the ternary kind included; zero input."""
    from repro_torch.comm import kernels as K
    codec = _encode_codec(kind, k, absolute)
    n = n_rows * c - (n_rows - 1)
    for zero in (False, True):
        x, _ = _wire_input(dev, n, n_rows * 100 + c + k, "log", zero)
        gen = torch.Generator(device=dev).manual_seed(c + n_rows)
        u = torch.rand(n, generator=gen, device=dev)
        pk, sk = K.encode_rows(x, codec, n_rows, u=u, backend="cuda")
        pp, sp = K.encode_rows(x, codec, n_rows, u=u, backend="torch")
        _bits_equal(pk, pp)
        _bits_equal(sk, sp)
        scales = (torch.rand(n_rows, generator=gen, device=dev) + 0.5) * sk
        _bits_equal(K.decode_rows(pk, scales, codec, c, backend="cuda"),
                    K.decode_rows(pk, scales, codec, c, backend="torch"))


@pytest.mark.parametrize("block", [1, 2, 4, 8, 32, 64, 128, 256, 1024,
                                   4096, 2 ** 16])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 1000003])
def test_blockwise_kernels_bitwise(dev, n, block):
    """#14 (codes, scales) and #8 (2-bit payload, scales) against their
    plain versions at every shape of the kernel's layout (a lane holding
    several blocks, a block across 1 .. 32 lanes, across chunks of a
    lane), the tail block padded, zeros among the inputs, and an
    unaligned view of x (scalar loads); one launch a call."""
    from repro_torch.comm import kernels as K
    gen = torch.Generator(device=dev).manual_seed(n + block)
    base = torch.randn(n + 1, generator=gen, device=dev) * 3.0
    base[::7] = 0.0
    for x in (base[:n], base[1:]):
        n14, n8 = K.blockwise_quantize_launches, K.blockwise_encode_launches
        for a, b in zip(K.blockwise_quantize(x, block, backend="cuda"),
                        K.blockwise_quantize(x, block, backend="torch")):
            _bits_equal(a, b)
        for a, b in zip(K.blockwise_encode(x, block, backend="cuda"),
                        K.blockwise_encode(x, block, backend="torch")):
            _bits_equal(a, b)
        assert (K.blockwise_quantize_launches,
                K.blockwise_encode_launches) == (n14 + 1, n8 + 1)


@pytest.mark.parametrize("mode", ["dp_adam", "efadam", "terngrad", "ef_sgd"])
def test_baseline_modes_run_through_kernels(dev, mode):
    """Three steps of each baseline (one NCCL rank) on the smoke model:
    its kernels launch, no plain version runs, the session reads the
    device only at its two harvests, and the losses are finite."""
    import math
    import torch.distributed as dist
    from repro_torch.comm import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.kernels import adam_ef as A
    from repro_torch.launch import mesh
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    counters = {"dp_adam": [(A, "moments_launches")],
                "efadam": [(A, "moments_launches"), (K, "amax_launches"),
                           (K, "ef_encode_uniform_launches"),
                           (K, "ef_encode_log_launches"),
                           (K, "decode_uniform_launches")],
                "terngrad": [(K, "amax_launches"),
                             (K, "encode_ternary_launches"),
                             (K, "decode_ternary_launches")],
                "ef_sgd": [(K, "blockwise_quantize_launches"),
                           (K, "pack_launches"), (K, "unpack_launches")]}[mode]
    kw = {"dp_adam": dict(grad_k=None, weight_k=None),
          "efadam": dict(grad_k=6, weight_k=7, weight_absolute=False),
          "terngrad": dict(alpha=2e-2, grad_k=None, weight_k=None),
          "ef_sgd": dict(alpha=1e-2, beta=0.9, grad_k=None,
                         weight_k=None)}[mode]
    model = Model(get_config("yi-6b", smoke=True))
    group = mesh.make_process_group(dev, store=dist.HashStore())
    try:
        art = make_train_step(model, group, TrainConfig(mode=mode, **kw))
        for mod, name in counters:
            setattr(mod, name, 0)
        K.plain_on_cuda = A.plain_on_cuda = 0
        sess = TrainSession.from_artifacts(
            art, batch_for_model(model.cfg, 32, 2), SessionConfig(
                log_every=3), device=dev, log=lambda *_: 0)
        with sess:
            sess.run(3)
        assert sess.stats["syncs"] == 2
        assert all(getattr(mod, name) > 0 for mod, name in counters)
        assert K.plain_on_cuda == A.plain_on_cuda == 0
        assert all(math.isfinite(h["loss"]) for h in sess.history)
    finally:
        mesh.close_process_group()


# ---------------------------------------------------------------------------
# #10 log quantize, #13 ternary quantize, #9 lane pack/unpack, and the
# Algorithm 1 baselines and the paper protocol through them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_g", [1, 2, 3, 4, 5, 6, 7, 8, 30, 126])
@pytest.mark.parametrize("n", [1, 3, 4099, 1000003])
def test_log_quantize_bitwise(dev, k_g, n):
    """#10 against its plain version: random values, zeros, the zero
    input, values exactly on the decision points (and one float below),
    an unaligned view (scalar loads)."""
    from repro_torch.comm import kernels as K
    from repro_torch.opt import grids
    gen = torch.Generator(device=dev).manual_seed(n * 10 + k_g)
    base = torch.randn(n + 1, generator=gen, device=dev)
    base[::5] = 0.0
    t = torch.tensor(grids.log_thresholds(k_g), device=dev)
    m = min(n, 2 * t.numel())
    base[:m] = torch.cat([t, torch.nextafter(t, torch.zeros_like(t))])[:m]
    s = torch.tensor(1.0, device=dev)
    for x in (base[:n], base[1:], torch.zeros(n, device=dev)):
        _bits_equal(K.log_quantize(x, s, k_g, backend="cuda"),
                    K.log_quantize(x, s, k_g, backend="torch"))
    s = base.abs().amax()
    _bits_equal(K.log_quantize(base, s, k_g, backend="cuda"),
                K.log_quantize(base, s, k_g, backend="torch"))


@pytest.mark.parametrize("n", [1, 3, 5, 4099, 2 ** 20 + 7])
def test_threefry_uniform_bitwise(dev, n):
    """rt_threefry_uniform against its plain version
    (``core.threefry.uniform``): aligned (float4 stores and a tail) and
    at an offset output (scalar stores), at a start whose counters cross
    into the high word, and leaf 2 of a key table; one launch a call."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng
    keys = torch.stack([TF.prng_key(s, dev) for s in (0, 7, 2 ** 31 - 1)])
    buf = torch.full((n + 1,), -1.0, device=dev)
    for leaf, start in ((0, 0), (2, 0), (1, 2 ** 32 - 3)):
        want = prng.uniform(keys, leaf, n, start, backend="torch")
        before = prng.uniform_launches
        got = prng.uniform(keys, leaf, n, start, backend="cuda")
        assert prng.uniform_launches == before + 1
        _bits_equal(got, want)
        off = prng.uniform(keys, leaf, n, start, backend="cuda",
                           out=buf[1:])
        _bits_equal(off, want)
    assert float(buf[0]) == -1.0
    assert float(want.min()) >= 0.0 and float(want.max()) < 1.0


@pytest.mark.parametrize("n_leaves", [0, 1, 7, 300])
def test_threefry_keys_bitwise(dev, n_leaves):
    """rt_threefry_keys against its plain versions: the distributed chain
    (t read from device memory, t past 2^31, workers 0 and 3) and
    Algorithm 1's (the table and the state key advanced in place; 300
    leaves run past one pass of the block's threads)."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng
    if n_leaves:
        for t in (1, 2 ** 31 + 5):
            tt = torch.tensor([t], dtype=torch.int64, device=dev)
            for worker in (0, 3):
                _bits_equal(prng.step_keys(9, tt, n_leaves, worker,
                                           backend="cuda"),
                            prng.step_keys(9, tt, n_leaves, worker,
                                           backend="torch"))
    ka, kb = TF.prng_key(11, dev), TF.prng_key(11, dev)
    for _ in range(3):
        _bits_equal(prng.advance_keys(ka, n_leaves, backend="cuda"),
                    prng.advance_keys(kb, n_leaves, backend="torch"))
        _bits_equal(ka, kb)


@pytest.mark.parametrize("L", [1, 3, 64])
@pytest.mark.parametrize("n", [1, 3, 4099, 65536])
def test_threefry_trunc_normal_bitwise(dev, L, n):
    """rt_threefry_trunc_normal against its plain version
    (``core.threefry.truncated_normal`` times std): an (L, 2) key table
    drawn in one launch (float4 rows where every row is aligned, scalar
    rows where n is not a multiple of 4 or the output sits at an offset),
    a start past 2^32, both stds of ``Model.init``."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng
    keys = TF.split(TF.prng_key(L * n, dev), L)
    buf = torch.full((L * n + 1,), -1.0, device=dev)
    for start, std in ((0, 0.02), (2 ** 32 - 5, 0.2)):
        want = prng.trunc_normal(keys, (n,), std, start, backend="torch")
        before = prng.trunc_normal_launches
        got = prng.trunc_normal(keys, (n,), std, start, backend="cuda")
        assert prng.trunc_normal_launches == before + 1
        _bits_equal(got, want)
        off = prng.trunc_normal(keys, (n,), std, start, backend="cuda",
                                out=buf[1:].view(L, n))
        _bits_equal(off, want)
        assert float(want.abs().max()) < 2 * std
    assert float(buf[0]) == -1.0
    one = prng.trunc_normal(keys[0], (n,), 0.02, backend="cuda")
    _bits_equal(one, prng.trunc_normal(keys[:1], (n,), 0.02,
                                       backend="cuda")[0])


@pytest.mark.parametrize("B,V", [(1, 7), (4, 4099), (1, 64000),
                                 (4, 64000), (3, 152064), (4, 262144),
                                 (9, 50280)])
def test_threefry_categorical_bitwise(dev, B, V):
    """rt_threefry_categorical and its fold against the plain sampling
    step over 8 steps: greedy and sampled tokens and the keys written
    back bitwise, greedy temperatures (0) beside hot ones, V not a
    multiple of the 4096-element chunk, ties planted across chunks (the
    lower index wins), and a row of equal logits."""
    from repro_torch.core import threefry as TF
    from repro_torch.kernels import prng
    gen = torch.Generator(device=dev).manual_seed(B * V)
    temp = torch.tensor([(0.0, 0.8, 1.3, 1e-9)[b % 4] for b in range(B)],
                        device=dev)
    ka = TF.split(TF.prng_key(V, dev), B)
    kb = ka.clone()
    for step in range(8):
        lg = 3 * torch.randn(B, V, generator=gen, device=dev)
        top = float(lg.max()) + 1.0
        lg[:, V // 2] = top
        lg[:, V - 1] = top
        if step == 3:
            lg[0] = 0.5
        before = prng.categorical_launches
        ga, sa = prng.categorical_step(lg, temp, ka, backend="cuda")
        assert prng.categorical_launches == before + 1
        gb, sb = prng.categorical_step(lg, temp, kb, backend="torch")
        _bits_equal(ga, gb)
        _bits_equal(sa, sb)
        _bits_equal(ka, kb)
        flat = B == 1 and step == 3
        assert int(ga[-1]) == (0 if flat else V // 2)
        assert step != 3 or int(ga[0]) == 0


def test_session_sampled_step_graph_equals_eager(dev, monkeypatch):
    """Every request hot: the sampled decode step as its CUDA graph gives
    the eager session's tokens and keys bitwise; the categorical kernel
    launched and no plain version ran on the card."""
    from repro_torch.kernels import prng
    from repro_torch.serve.session import Request, ServeSession
    model, params = _served_smoke(dev, "yi-6b")

    def run():
        sess = ServeSession(model, params, slots=3, max_seq=48, seed=6,
                            prefill_chunk=4, device=dev)
        hs = [sess.submit(Request(prompt=list(range(2 + i, 9 + i)),
                                  max_new_tokens=12, temperature=0.6 + i / 4))
              for i in range(5)]
        res = sess.drain()
        return sess, [res[h].tokens for h in hs]
    plain = prng.plain_on_cuda
    before = prng.categorical_launches
    graphed, tokens = run()
    assert True in graphed._graphs and graphed.stats["replays"] > 0
    assert prng.categorical_launches > before
    assert prng.plain_on_cuda == plain
    monkeypatch.setattr(ServeSession, "_dispatch",
                        lambda self, sample: self._decode(sample))
    eager, want = run()
    assert tokens == want
    assert torch.equal(graphed._state["rng"], eager._state["rng"])


@pytest.mark.parametrize("n", [1, 3, 4099, 1000003])
def test_ternary_quantize_bitwise(dev, n):
    """#13 against its plain version: u exactly at p = |x| / s (code 0),
    just below it, x = 0, a zero scale (the 1e-30 floor), unaligned
    views."""
    from repro_torch.comm import kernels as K
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n + 1, generator=gen, device=dev)
    x[::7] = 0.0
    u = torch.rand(n + 1, generator=gen, device=dev)
    s = x.abs().amax()
    p = x.abs() / s
    u[1::3] = p[1::3]
    u[2::3] = torch.nextafter(p[2::3], torch.zeros_like(p[2::3]))
    for xx, uu in ((x[:n], u[:n]), (x[1:], u[1:])):
        for scale in (s, torch.tensor(0.0, device=dev)):
            a = K.ternary_quantize(xx, uu, scale, backend="cuda")
            _bits_equal(a, K.ternary_quantize(xx, uu, scale,
                                              backend="torch"))
    a = K.ternary_quantize(x, u, s, backend="cuda")
    assert not a[1::3].any()


@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("R,c", [(1, 1), (2, 7), (4, 1000003), (3, 8)])
def test_pack_rows_bitwise(dev, bits, R, c):
    """#9 against its plain version at every width, ragged rows, each
    code type; the round trip returns the codes."""
    from repro_torch.comm import kernels as K
    gen = torch.Generator(device=dev).manual_seed(R * c + bits)
    lim = 2 ** (bits - 1)
    for dt in (torch.int8, torch.int16):
        if bits == 16 and dt == torch.int8:
            continue
        codes = torch.randint(-lim, lim, (R, c), generator=gen,
                              device=dev).to(dt)
        pk = K.pack_rows(codes, bits, backend="cuda")
        _bits_equal(pk, K.pack_rows(codes, bits, backend="torch"))
        uk = K.unpack_rows(pk, bits, c, backend="cuda")
        _bits_equal(uk, K.unpack_rows(pk, bits, c, backend="torch")
                    .contiguous())
        assert torch.equal(uk.to(torch.int32), codes.to(torch.int32))


@pytest.mark.parametrize("spec", ["log:2", "log:6", "uniform_amax:5",
                                  "uniform:7:wire", "terngrad"])
def test_codec_primitives_on_cuda(dev, spec):
    """The codecs' compute_scale / quantize / dequantize through the
    kernels (K3, #10, K11; K4, K12; #13) equal the plain versions."""
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    cd = CD.get_codec(spec)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(4099, generator=gen, device=dev) * 0.3
    u = torch.rand(4099, generator=gen, device=dev) if cd.stochastic \
        else None
    K.plain_on_cuda = 0
    sk = cd.compute_scale(x)
    ck = cd.quantize(x, sk, u=u)
    dk = cd.dequantize(ck, sk)
    assert K.plain_on_cuda == 0
    sp = cd.compute_scale(x, backend="torch")
    cp = cd.quantize(x, sp, u=u, backend="torch")
    for a, b in ((sk, sp), (ck, cp), (dk, cd.dequantize(cp, sp,
                                                       backend="torch"))):
        _bits_equal(a, b)


def test_blockwise_any_power_of_two_on_cuda(dev):
    """blockwise:64 runs through #14 on the card (it raised before the
    kernel took every power of two); a block that is no power of two
    raises, naming the reason."""
    from repro_torch.comm import kernels as K
    from repro_torch.core.quantizers import get_quantizer
    from repro_torch.opt import engine
    x = torch.randn(1000, device=dev)
    n0 = K.blockwise_quantize_launches
    qt = get_quantizer("blockwise:64").encode(x)
    assert K.blockwise_quantize_launches == n0 + 1
    codes, scales = engine.quantize_blockwise(x, 64, backend="torch")
    _bits_equal(qt.codes, codes)
    _bits_equal(qt.scale, scales)
    for bad in (48, 3, 0):
        with pytest.raises(ValueError, match="power-of-two"):
            engine.quantize_blockwise(x, bad)


@pytest.mark.parametrize("name", ["ef_sgdm", "terngrad_sgd",
                                  "qadam_terngrad", "qadam_blockwise",
                                  "ef_sgdm_blockwise64"])
def test_algorithm1_baselines_run_through_kernels(dev, name):
    """Three steps of each baseline of Algorithm 1 on the smoke model on
    the card: its kernels launch (the threefry keys every step), no plain
    version runs, the session reads the device only at its harvests; one
    update on the trained state through the kernels equals the plain
    versions' (the same draws: each from a copy of the state key)."""
    from repro_torch.comm import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import qadam as Q
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.kernels import adam_ef as A
    from repro_torch.kernels import prng
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    build = {"ef_sgdm": lambda b: Q.ef_sgdm(alpha=1e-2, backend=b),
             "terngrad_sgd": lambda b: Q.terngrad_sgd(alpha=1e-2, backend=b),
             "qadam_terngrad": lambda b: Q.qadam(Q.QAdamConfig(
                 grad_q="terngrad", backend=b)),
             "ef_sgdm_blockwise64": lambda b: Q.ef_sgdm(
                 alpha=1e-2, grad_q="blockwise:64", backend=b),
             "qadam_blockwise": lambda b: Q.qadam(Q.QAdamConfig(
                 grad_q="blockwise:256", backend=b))}[name]
    counters = {"ef_sgdm": ["blockwise_quantize_launches"],
                "ef_sgdm_blockwise64": ["blockwise_quantize_launches"],
                "qadam_blockwise": ["blockwise_quantize_launches"]}.get(
        name, ["amax_launches", "ternary_quantize_launches"])
    model = Model(get_config("yi-6b", smoke=True))

    def loss_fn(p, b):
        ls, nt = model.loss(p, b)
        return ls / nt
    for c in counters:
        setattr(K, c, 0)
    K.plain_on_cuda = A.plain_on_cuda = prng.plain_on_cuda = 0
    prng.keys_launches = 0
    sess = TrainSession.from_optimizer(
        build(None), loss_fn, model.init(seed=0, device=dev),
        batch_for_model(model.cfg, 32, 2), SessionConfig(log_every=3),
        log=lambda *_: 0)
    with sess:
        sess.run(3)
    assert sess.stats["syncs"] == 2
    assert all(getattr(K, c) > 0 for c in counters)
    assert prng.keys_launches == 3
    assert K.plain_on_cuda == A.plain_on_cuda == prng.plain_on_cuda == 0
    st = sess.state
    grads = {"embed": st["params"]["embed"] * 0.01 + 1e-3}
    outs = []
    for backend in ("cuda", "torch"):
        s = st["opt"]
        sub = s._replace(**{f: {"embed": getattr(s, f)["embed"].clone()}
                            for f in ("m", "v", "e")}, key=s.key.clone())
        upd, s2 = build(backend).update(grads, sub)
        outs.append((upd["embed"], s2.m["embed"], s2.e["embed"], s2.key))
    for x, y in zip(*outs):
        _bits_equal(x, y)


def test_wquan_through_kernels(dev):
    from repro_torch.comm import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import wquan
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    params = Model(get_config("yi-6b", smoke=True)).init(seed=0, device=dev)
    K.amax_launches = K.quantize_launches = K.dequantize_launches = 0
    K.plain_on_cuda = 0
    got = wquan(params, k_x=7, absolute=False)
    assert min(K.amax_launches, K.quantize_launches,
               K.dequantize_launches) > 0 and K.plain_on_cuda == 0
    want = wquan(params, k_x=7, absolute=False, backend="torch")
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        _bits_equal(a, b)


def test_paper_protocol_on_cuda(dev):
    """A few steps of every method of the paper protocol on the card, both
    modes: #13, #14 and (efadam) #10 launch, no plain version runs."""
    import importlib.util
    import math
    import os
    from repro_torch.comm import kernels as K
    from repro_torch.kernels import adam_ef as A
    spec = importlib.util.spec_from_file_location(
        "paper_repro_torch", os.path.join(os.path.dirname(__file__), "..",
                                          "examples", "paper_repro_torch.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    for mode, names in (("qadam", ["ternary_quantize_launches",
                                   "blockwise_quantize_launches"]),
                        ("efadam", ["log_quantize_launches"])):
        for c in names:
            setattr(K, c, 0)
        K.plain_on_cuda = A.plain_on_cuda = 0
        rows = ex.compare(mode, steps=3, seeds=1, workers=2, device=dev,
                          log=lambda *_: None)
        assert all(math.isfinite(a) for _, a, _ in rows)
        assert all(getattr(K, c) > 0 for c in names)
        assert K.plain_on_cuda == A.plain_on_cuda == 0


# ---------------------------------------------------------------------------
# the tensor-core routes of K1 and #17
# ---------------------------------------------------------------------------

# k_x of each code width: the widest grid the lane holds (packed lanes
# hold codes in [-2^(b-1), 2^(b-1) - 1])
_TC_K_X = {8: 6, 16: 7, 2: 0, 3: 1, 4: 2, 6: 4}


def _k1_tc_case(dev, M, K, N, bits, seed):
    """x (M, K) bf16 and codes (K, N) of one width: int8, int16, or rows
    of packed lanes; returns (x, codes, scale, k_x, pack_bits)."""
    from repro_torch.comm import bits as B
    g = torch.Generator(device=dev).manual_seed(seed)
    k_x = _TC_K_X[bits]
    lim = 2 ** k_x
    codes = torch.randint(-lim, lim + 1, (K, N), generator=g, device=dev)
    if bits < 8:
        codes = B.pack_rows(torch.clamp(codes, -(2 ** (bits - 1)),
                                        2 ** (bits - 1) - 1), bits)
    else:
        codes = codes.to(torch.int8 if bits == 8 else torch.int16)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    return (x, codes, torch.tensor(0.0371, device=dev), k_x,
            bits if bits < 8 else 0)


def _k1_bf16_tol(MM, x, codes, scale, k_x, b, pack_bits=0):
    K, N = x.shape[1], b.shape[1]
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=pack_bits,
                         w_dtype="float32", cast_dtype="bfloat16").float()
    norm = (x.float() ** 2 @ w ** 2).sqrt()
    return _bf16_ulp(b.float()) + K1_FLOOR * K ** 0.5 * 2.0 ** -24 * norm


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("M,K,N", [
    (16, 300, 70), (17, 1000, 1001), (32, 4095, 300), (33, 2304, 2049),
    (64, 333, 513),                  # K no multiple of the 64-row stage
    (4, 11008, 64), (1, 4096, 512),  # split K
    (100, 700, 260)])                # two row tiles
def test_dequant_matmul_tensor_cores(dev, bits, M, K, N):
    """K1's tensor-core route (bf16 activations, int8/int16 codes) within
    one bf16 ulp plus the floor of the plain product; two calls bitwise
    equal; the route's counter moves, the other's does not."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, _ = _k1_tc_case(dev, M, K, N, bits,
                                          M * K + N + bits)
    kw = dict(k_x=k_x, n=N, cast_dtype="bfloat16")
    n_tc, n_fma = MM.launches_tc, MM.launches_fma
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    a2 = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert (MM.launches_tc, MM.launches_fma) == (n_tc + 2, n_fma)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == (M, N)
    assert torch.equal(a, a2)
    tol = _k1_bf16_tol(MM, x, codes, scale, k_x, b)
    assert bool(((a.float() - b.float()).abs() <= tol).all())


def test_dequant_matmul_tensor_cores_float32_out(dev):
    """A bf16 leaf without a pending cast: bf16 weights, float32 output."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, _ = _k1_tc_case(dev, 5, 640, 96, 8, 1)
    kw = dict(k_x=k_x, n=96, w_dtype="bfloat16", cast_dtype="float32")
    assert MM.route(x.dtype, codes.dtype, 0, "bfloat16", "float32") == "tc"
    n_tc = MM.launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert MM.launches_tc == n_tc + 1
    assert a.dtype == b.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_fma_route_counts(dev):
    """float32 activations, or a float32 weight, stay on the CUDA-core
    route, on int8 codes and on packed lanes alike."""
    from repro_torch.comm import bits as B
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(5)
    c = torch.randint(-8, 8, (256, 96), generator=g, device=dev)
    packed = B.pack_rows(c, 4)
    x = torch.randn(4, 256, generator=g, device=dev)
    scale = torch.tensor(0.37, device=dev)
    n_tc, n_fma = MM.launches_tc, MM.launches_fma
    MM.dequant_matmul(x, packed, scale, k_x=2, n=96, pack_bits=4,
                      backend="cuda")
    MM.dequant_matmul(x, c.to(torch.int8), scale, k_x=2, n=96,
                      backend="cuda")
    MM.dequant_matmul(x.to(torch.bfloat16), packed, scale, k_x=2, n=96,
                      pack_bits=4, backend="cuda")   # float32 weight
    assert (MM.launches_tc, MM.launches_fma) == (n_tc, n_fma + 3)


def test_dequant_matmul_packed_lanes_count_on_tensor_cores(dev):
    """bf16 activations against packed lanes with a bf16 weight move
    ``launches_tc`` and ``launches_tc_packed``, and not ``launches_fma``."""
    from repro_torch.comm import matmul as MM
    counts = (MM.launches_tc, MM.launches_tc_packed, MM.launches_fma)
    for bits in (2, 3, 4, 6):
        x, codes, scale, k_x, pb = _k1_tc_case(dev, 4, 256, 96, bits, bits)
        MM.dequant_matmul(x, codes, scale, k_x=k_x, n=96, pack_bits=pb,
                          cast_dtype="bfloat16", backend="cuda")
    assert (MM.launches_tc, MM.launches_tc_packed, MM.launches_fma) == (
        counts[0] + 4, counts[1] + 4, counts[2])


@pytest.mark.parametrize("bits", [2, 3, 4, 6])
@pytest.mark.parametrize("M", [1, 5, 17, 33, 64, 100])
@pytest.mark.parametrize("K,N", [
    (1024, 2304),    # rows of whole 16-byte words: cp.async copies
    (1000, 1001),    # ragged rows staged byte by byte, K past a stage
    (4096, 512),     # split K
    (300, 70)])      # one column tile, part of it past N
def test_dequant_matmul_tensor_cores_packed(dev, bits, M, K, N):
    """K1's tensor-core route on packed 2/3/4/6-bit lanes within one bf16
    ulp plus the floor of the plain product; two calls bitwise equal; the
    route's counters move, the CUDA-core route's does not."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, pb = _k1_tc_case(dev, M, K, N, bits,
                                           M * K + N + bits)
    kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype="bfloat16")
    n_tc, n_p, n_fma = MM.launches_tc, MM.launches_tc_packed, \
        MM.launches_fma
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    a2 = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert (MM.launches_tc, MM.launches_tc_packed, MM.launches_fma) == (
        n_tc + 2, n_p + 2, n_fma)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == (M, N)
    assert torch.equal(a, a2)
    tol = _k1_bf16_tol(MM, x, codes, scale, k_x, b, pb)
    assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.parametrize("case", [
    # Sq no multiple of the 64-query tile, rep 2 (gemma2's)
    dict(B=1, Sq=200, Skv=200, H=8, K=4, causal=True, window=0,
         softcap=50.0),
    # a window edge inside a 32-key tile, rep 1, q_offset
    dict(B=2, Sq=77, Skv=160, H=4, K=4, causal=True, window=45,
         softcap=None, q_offset=83),
    # rep 4, ragged Skv, window and softcap
    dict(B=1, Sq=130, Skv=333, H=8, K=2, causal=True, window=100,
         softcap=30.0, q_offset=203),
    # not causal, a window
    dict(B=1, Sq=65, Skv=97, H=2, K=1, causal=False, window=20,
         softcap=None, q_offset=30)])
def test_flash_attention_tensor_cores(dev, case):
    """#17's bf16 route at hd 256 within one bf16 ulp plus 1e-5 of the
    plain version; two calls bitwise equal; the route's counter moves,
    the float32 route's does not."""
    from repro_torch.kernels import flash_attention as FA
    hd = 256
    g = torch.Generator(device=dev).manual_seed(case["Sq"] + case["Skv"])
    q = torch.randn(case["B"], case["Sq"], case["H"], hd, generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn(case["B"], case["Skv"], case["K"], hd, generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=case["causal"], window=case["window"],
              softcap=case["softcap"], q_offset=case.get("q_offset", 0))
    n_tc, n_tc32 = FA.launches_tc, FA.launches_tc32
    a = FA.flash_attention(q, k, v, backend="cuda", **kw)
    a2 = FA.flash_attention(q, k, v, backend="cuda", **kw)
    assert (FA.launches_tc, FA.launches_tc32) == (n_tc + 2, n_tc32)
    b = FA.flash_attention(q, k, v, backend="torch", **kw)
    assert torch.equal(a, a2)
    tol = _bf16_ulp(b.float()) + 1e-5
    assert bool(((a.float() - b.float()).abs() <= tol).all())


def test_flash_attention_float32_route_counts(dev):
    from repro_torch.kernels import flash_attention as FA
    q = torch.randn(1, 40, 2, 64, device=dev)
    k = torch.randn(1, 40, 1, 64, device=dev)
    n_tc, n_tc32 = FA.launches_tc, FA.launches_tc32
    a = FA.flash_attention(q, k, k, backend="cuda")
    b = FA.flash_attention(q, k, k, backend="torch")
    assert (FA.launches_tc, FA.launches_tc32) == (n_tc, n_tc32 + 1)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# K1t on tensor cores, #17 in float32 on tensor cores (3xTF32)
# ---------------------------------------------------------------------------

def _k1t_case(dev, M, V, d, bits, seed):
    """x (M, d) bf16 and code rows (V, d) of one width, as _k1_tc_case."""
    x, codes, scale, k_x, pb = _k1_tc_case(dev, M, V, d, bits, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(M, d, generator=g, device=dev).to(torch.bfloat16)
    return x, codes, scale, k_x, pb


def _k1t_bf16_tol(MM, x, codes, scale, k_x, b, pack_bits=0):
    d = x.shape[1]
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=d, pack_bits=pack_bits,
                         w_dtype="float32", cast_dtype="bfloat16").float()
    norm = (x.float() ** 2 @ (w ** 2).T).sqrt()
    return _bf16_ulp(b.float()) + K1_FLOOR * d ** 0.5 * 2.0 ** -24 * norm


@pytest.mark.parametrize("bits", [8, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M", [1, 2, 4, 5, 8, 17])
@pytest.mark.parametrize("V,d", [
    (512, 2304),     # aligned: whole 16-byte spans, whole 16-row tiles
    (1001, 2304),    # ragged V
    (256, 1000),     # ragged d (a chunk part past the row)
    (77, 37)])       # both, rows of no whole 16 bytes
def test_dequant_matmul_t_tensor_cores(dev, bits, M, V, d):
    """K1t's tensor-core route (bf16 activations, every code type) within
    K1's tier: one bf16 ulp plus the floor of the plain product; two calls
    bitwise equal; t_launches_tc moves, t_launches_fma does not."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, pb = _k1t_case(dev, M, V, d, bits,
                                         M * V + d + bits)
    kw = dict(k_x=k_x, n=d, pack_bits=pb, cast_dtype="bfloat16",
              transpose=True)
    n = (MM.t_launches, MM.t_launches_tc, MM.t_launches_fma)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    a2 = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert (MM.t_launches, MM.t_launches_tc, MM.t_launches_fma) == (
        n[0] + 2, n[1] + 2, n[2])
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == (M, V)
    assert torch.equal(a, a2)
    tol = _k1t_bf16_tol(MM, x, codes, scale, k_x, b, pb)
    assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matmul_t_tier_catches_a_dropped_column(dev, bits):
    """The planted fault: the plain product with the last d column dropped
    fails the tier the kernel passes."""
    from repro_torch.comm import matmul as MM
    M, V, d = 4, 1001, 2304
    x, codes, scale, k_x, pb = _k1t_case(dev, M, V, d, bits, 99 + bits)
    kw = dict(k_x=k_x, n=d, pack_bits=pb, cast_dtype="bfloat16",
              transpose=True)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    tol = _k1t_bf16_tol(MM, x, codes, scale, k_x, b, pb)
    assert bool(((a.float() - b.float()).abs() <= tol).all())
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=d, pack_bits=pb,
                         w_dtype="float32", cast_dtype="bfloat16").float()
    bad = (x[:, :-1].float() @ w[:, :-1].T).to(torch.bfloat16)
    assert bool(((bad.float() - b.float()).abs() > tol).any())


def test_dequant_matmul_t_route_counts(dev):
    """bf16 activations against a bf16 weight move t_launches_tc; float32
    activations, or a float32 weight, move t_launches_fma; t_launches
    counts both, and K1's counters stay."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, _ = _k1t_case(dev, 3, 300, 256, 8, 7)
    kw = dict(k_x=k_x, n=256, transpose=True)
    n = (MM.t_launches, MM.t_launches_tc, MM.t_launches_fma, MM.launches)
    MM.dequant_matmul(x, codes, scale, cast_dtype="bfloat16",
                      backend="cuda", **kw)
    MM.dequant_matmul(x, codes, scale, w_dtype="bfloat16",
                      cast_dtype="float32", backend="cuda", **kw)
    assert (MM.t_launches, MM.t_launches_tc, MM.t_launches_fma) == (
        n[0] + 2, n[1] + 2, n[2])
    a = MM.dequant_matmul(x.float(), codes, scale, backend="cuda", **kw)
    MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)  # f32 weight
    assert (MM.t_launches, MM.t_launches_tc, MM.t_launches_fma,
            MM.launches) == (n[0] + 4, n[1] + 2, n[2] + 2, n[3])
    b = MM.dequant_matmul(x.float(), codes, scale, backend="torch", **kw)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dequant_matmul_t_tensor_cores_float32_out(dev):
    """A bf16 leaf without a pending cast: bf16 weights, float32 output."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, _ = _k1t_case(dev, 5, 640, 96, 8, 1)
    kw = dict(k_x=k_x, n=96, w_dtype="bfloat16", cast_dtype="float32",
              transpose=True)
    n_tc = MM.t_launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert MM.t_launches_tc == n_tc + 1
    assert a.dtype == b.dtype == torch.float32 and a.shape == (5, 640)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# the four cases of tests/test_kernels.py (TestFlashAttention) and a
# ragged one (Sq, Skv no multiple of any tile, window, softcap, offset)
F32_FLASH_CASES = {
    "causal": dict(B=2, Sq=256, Skv=256, H=4, K=2, causal=True, window=0,
                   softcap=None),
    "suffix": dict(B=1, Sq=128, Skv=384, H=8, K=2, causal=True, window=0,
                   softcap=None, q_offset=256),
    "swa_softcap": dict(B=1, Sq=256, Skv=256, H=2, K=2, causal=True,
                        window=96, softcap=50.0),
    "bidirectional": dict(B=2, Sq=128, Skv=128, H=4, K=4, causal=False,
                          window=0, softcap=None),
    "ragged": dict(B=1, Sq=100, Skv=150, H=4, K=2, causal=True, window=40,
                   softcap=30.0, q_offset=50),
}


def _flash_f32_inputs(dev, c, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(c["B"], c["Sq"], c["H"], hd, generator=g, device=dev)
    k, v = (torch.randn(c["B"], c["Skv"], c["K"], hd, generator=g,
                        device=dev) for _ in range(2))
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"],
              q_offset=c.get("q_offset", 0))
    return q, k, v, kw


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("case", sorted(F32_FLASH_CASES))
def test_flash_attention_float32_tensor_cores(dev, case, hd):
    """#17's float32 route (3xTF32) within rtol 1e-4 / atol 1e-5 of the
    plain version at every head dim; two calls bitwise equal; launches_tc32
    moves, the bf16 route's counter does not."""
    from repro_torch.kernels import flash_attention as FA
    c = F32_FLASH_CASES[case]
    q, k, v, kw = _flash_f32_inputs(dev, c, hd, hd + c["Sq"] + c["Skv"])
    assert FA.route(q.dtype) == "tc32"
    n_tc, n_tc32 = FA.launches_tc, FA.launches_tc32
    a = FA.flash_attention(q, k, v, backend="cuda", **kw)
    a2 = FA.flash_attention(q, k, v, backend="cuda", **kw)
    assert (FA.launches_tc, FA.launches_tc32) == (n_tc, n_tc32 + 2)
    b = FA.flash_attention(q, k, v, backend="torch", **kw)
    assert a.dtype == torch.float32 and a.shape == q.shape
    assert torch.equal(a, a2)
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["swa_softcap", "ragged"])
def test_flash_attention_float32_tier_catches_window_off_by_one(dev, case):
    """The planted fault: the plain version with the window one wider
    fails the tier the kernel passes."""
    from repro_torch.kernels import flash_attention as FA
    c = F32_FLASH_CASES[case]
    q, k, v, kw = _flash_f32_inputs(dev, c, 256, 5)
    a = FA.flash_attention(q, k, v, backend="cuda", **kw)
    b = FA.flash_attention(q, k, v, backend="torch", **kw)
    tol = 1e-5 + 1e-4 * b.abs()
    assert bool(((a - b).abs() <= tol).all())
    bad = FA.flash_attention(q, k, v, backend="torch",
                             **dict(kw, window=kw["window"] + 1))
    assert bool(((bad - b).abs() > tol).any())


# ---------------------------------------------------------------------------
# K6 fused decode: a row's head, 16-byte body and tail, every lane width
# ---------------------------------------------------------------------------

# (kind, k, lane bits): the uniform kind at every lane width (its wire
# lanes pinned), k = 30 the finest grid; the log kind at its 3-, 4- and
# 6-bit lanes; the ternary kind's 2-bit lanes
K6_CASES = ([("uniform", k, b) for b, k in ((2, 1), (3, 2), (4, 3), (6, 5),
                                            (8, 7), (16, 15))]
            + [("uniform", 30, 16)]
            + [("uniform", 14, 16)]
            + [("log", k, None) for k in (1, 4, 6, 8, 30, 126)]
            + [("ternary", 0, 2)])


def _k6_codec(kind, k, bits):
    from repro_torch.comm import codec as CD
    if kind == "log":
        return CD.LogCodec(k_g=k)
    if kind == "ternary":
        return CD.TernaryCodec()
    return CD.UniformCodec(k_x=k, absolute=True, wire_bits=bits)


@pytest.mark.parametrize("kind,k,bits", K6_CASES, ids=str)
@pytest.mark.parametrize("c", [1, 3, 4, 7, 16, 4099, 1000003])
@pytest.mark.parametrize("n_rows", [1, 2, 3, 5])
def test_decode_rows_head_body_tail_bitwise(dev, kind, k, bits, c, n_rows):
    """K6 against its plain version, bitwise: codes over the whole lane,
    a distinct scale per row, into rows; into a flat output shorter than
    n_rows * c by 1, 3 and 5 elements; into an output that starts 4 bytes
    past a 16-byte boundary; from a payload that starts one byte past one.
    One launch a call."""
    from repro_torch.comm import bits as B
    from repro_torch.comm import kernels as K
    codec = _k6_codec(kind, k, bits)
    g = torch.Generator(device=dev).manual_seed(c * 8 + n_rows + codec.bits)
    half = 2 ** (codec.bits - 1)
    codes = torch.randint(-half, half, (n_rows, c), generator=g, device=dev,
                          dtype=torch.int32)
    if kind == "ternary":
        codes = codes.clamp(-1, 1)
    payload = B.pack_rows(codes, codec.bits)
    scales = torch.rand(n_rows, generator=g, device=dev) + 0.5
    plain = K.decode_rows(payload, scales, codec, c, backend="torch")
    counter = f"decode_{kind}_launches"
    n0 = getattr(K, counter)
    _bits_equal(K.decode_rows(payload, scales, codec, c, backend="cuda"),
                plain)
    assert getattr(K, counter) == n0 + 1
    flat = plain.reshape(-1)
    for short in (1, 3, 5):
        n = n_rows * c - short
        if n < 1:
            continue
        out = torch.full((n,), float("nan"), device=dev)
        K.decode_rows(payload, scales, codec, c, backend="cuda", out=out)
        _bits_equal(out, flat[:n])
    buf = torch.full((n_rows * c + 4,), float("nan"), device=dev)
    out = buf[1:1 + n_rows * c]
    K.decode_rows(payload, scales, codec, c, backend="cuda", out=out)
    _bits_equal(out, flat)
    assert torch.isnan(buf[0]) and bool(torch.isnan(buf[1 + n_rows * c:]).all())
    store = torch.empty(payload.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = store[1:].view(payload.shape)
    shifted.copy_(payload)
    _bits_equal(K.decode_rows(shifted, scales, codec, c, backend="cuda"),
                plain)


# ---------------------------------------------------------------------------
# K7 fused EF encode and #5's encode launch: a warp a chunk of 512 codes;
# every lane width and kind, x at float offsets 0-3, rows whose payload
# bytes are no multiple of 16, chunk - 1, chunk, chunk + 1 codes
# ---------------------------------------------------------------------------

ENC_CHUNK = 512
ENC_CS = [1, ENC_CHUNK - 1, ENC_CHUNK, ENC_CHUNK + 1, 1100]
# (kind, k, absolute, lane bits): the uniform grid on every lane width and
# with the amax scale on 8 and 16 bits; the log grid at k_g 1, 2 (3-bit
# lanes), 6 (4-bit), 30 (6-bit), 126 (8-bit); the ternary kind (#5 only)
ENC_CASES = ([("uniform", k, True, b) for b, k in ((2, 1), (3, 2), (4, 3),
                                                   (6, 5), (8, 7), (16, 15))]
             + [("uniform", 7, False, 8), ("uniform", 14, False, 16)]
             + [("log", k, True, None) for k in (1, 2, 6, 30, 126)]
             + [("ternary", 0, True, None)])


def _enc_codec(kind, k, absolute, bits):
    from repro_torch.comm import codec as CD
    if kind == "log":
        return CD.LogCodec(k_g=k)
    if kind == "ternary":
        return CD.TernaryCodec()
    return CD.UniformCodec(k_x=k, absolute=absolute, wire_bits=bits)


def _at(dev, values, off):
    """values copied into a fresh buffer ``off`` floats past its start
    (16-byte aligned), NaN around them."""
    buf = torch.full((values.numel() + 8,), float("nan"), device=dev)
    view = buf[off:off + values.numel()]
    view.copy_(values)
    return view


@pytest.mark.parametrize("kind,k,absolute,bits", ENC_CASES, ids=str)
@pytest.mark.parametrize("c", ENC_CS)
@pytest.mark.parametrize("n_rows", [1, 2, 3, 4, 5])
def test_encode_chunk_geometry_bitwise(dev, kind, k, absolute, bits, c,
                                       n_rows):
    """K7 (log and uniform kinds: payload rows and e') and #5 (every kind:
    payload rows and scale) against their plain versions, bitwise, from x
    at float offsets 0-3 of a buffer: e' into a fresh tensor, into one
    aligned unlike x, and over x itself (``out=x``); #5's ternary kind on
    uniforms at another offset. One launch a call (#5: K3's amax launch
    besides, for an amax scale); nothing past the view is written."""
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine as E
    codec = _enc_codec(kind, k, absolute, bits)
    n = n_rows * c - (n_rows - 1 if c > 1 else 0)
    g = torch.Generator(device=dev).manual_seed(n_rows * 7000 + c + k)
    base = torch.randn(n, generator=g, device=dev) * (
        0.3 if kind == "uniform" else 1.0)
    base[::13] = 0.0
    scale = (torch.tensor(0.5, device=dev) if codec.static_scale is not None
             else E.amax_scale(base.abs().amax()))
    u = torch.rand(n, generator=g, device=dev)
    counter = f"encode_{kind}_launches"
    for off in range(4):
        x = _at(dev, base, off)
        n0 = getattr(K, counter)
        pk, sk = K.encode_rows(x, codec, n_rows, u=_at(dev, u, 3 - off),
                               backend="cuda")
        assert getattr(K, counter) == n0 + 1
        pp, sp = K.encode_rows(base, codec, n_rows, u=u, backend="torch")
        _bits_equal(pk, pp)
        _bits_equal(sk, sp)
        if kind == "ternary":
            continue
        pp, ep = K.ef_encode_rows(base, scale, codec, n_rows, backend="torch")
        ef_counter = f"ef_encode_{kind}_launches"
        for out_off in (None, (off + 2) % 4, "x"):
            out = (None if out_off is None else x if out_off == "x"
                   else _at(dev, torch.zeros_like(base), out_off))
            n0 = getattr(K, ef_counter)
            pk, ek = K.ef_encode_rows(x, scale, codec, n_rows,
                                      backend="cuda", out=out)
            assert getattr(K, ef_counter) == n0 + 1
            _bits_equal(pk, pp)
            _bits_equal(ek, ep)
            if out is not None:
                assert ek is out
        buf = x._base if x._base is not None else x
        assert bool(torch.isnan(buf[:off]).all())
        assert bool(torch.isnan(buf[off + n:]).all())


@pytest.mark.parametrize("kind,k,absolute,bits", ENC_CASES, ids=str)
def test_encode_zero_chunks_bitwise(dev, kind, k, absolute, bits):
    """All-zero input over a chunk and a half, three rows, x one float
    past a 16-byte boundary: K7's residual all zero, #5's scale the zero
    guard's 1 for the amax kinds."""
    from repro_torch.comm import kernels as K
    codec = _enc_codec(kind, k, absolute, bits)
    n = 3 * (ENC_CHUNK + ENC_CHUNK // 2)
    x = _at(dev, torch.zeros(n, device=dev), 1)
    u = torch.rand(n, device=dev)
    for a, b in zip(K.encode_rows(x, codec, 3, u=u, backend="cuda"),
                    K.encode_rows(x, codec, 3, u=u, backend="torch")):
        _bits_equal(a, b)
    if kind != "ternary":
        scale = torch.tensor(1.0, device=dev)
        pk, ek = K.ef_encode_rows(x, scale, codec, 3, backend="cuda")
        _bits_equal(pk, K.ef_encode_rows(x, scale, codec, 3,
                                         backend="torch")[0])
        assert not bool(ek.any())


# ---------------------------------------------------------------------------
# K1's CUDA-core route: float32 activations, every code type, split K
# ---------------------------------------------------------------------------

def _k1_fma_case(dev, M, K, N, bits, seed, x_dtype=torch.float32):
    """x (M, K) and codes (K, N) of one width for the CUDA-core route."""
    x, codes, scale, k_x, pb = _k1_tc_case(dev, M, K, N, bits, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(M, K, generator=g, device=dev).to(x_dtype)
    return x, codes, scale, k_x, pb


def _k1_f32_floor(MM, x, codes, scale, k_x, N, pack_bits, cast=None,
                  w_dtype="float32"):
    """K1_FLOOR units of sqrt(K) 2^-24 |x*w|_2: the tier of two fp32
    summation orders of the same products."""
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=pack_bits,
                         w_dtype=w_dtype, cast_dtype=cast).float()
    norm = (x.float() ** 2 @ w ** 2).sqrt()
    return K1_FLOOR * x.shape[1] ** 0.5 * 2.0 ** -24 * norm


@pytest.mark.parametrize("bits", [8, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M", [1, 4, 5, 8, 9, 16, 32, 33, 64])
@pytest.mark.parametrize("K,N", [
    (300, 70),       # one column tile, part of it past N
    (1000, 1001),    # ragged rows loaded byte by byte
    (4095, 384),     # K no multiple of 4: x staged element by element
    (4096, 512),     # split K
    (2304, 1024)])   # gemma2's wk/wv: split K
def test_dequant_matmul_float32_route(dev, bits, M, K, N):
    """K1's CUDA-core route (float32 activations and weights) within
    rtol/atol 1e-5 and the fp32 summation-order floor of the plain
    product; two calls bitwise equal; one CUDA-core launch a call and no
    tensor-core launch."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, pb = _k1_fma_case(dev, M, K, N, bits,
                                            M * K + N + bits)
    kw = dict(k_x=k_x, n=N, pack_bits=pb)
    n_fma, n_tc = MM.launches_fma, MM.launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert (MM.launches_fma, MM.launches_tc) == (n_fma + 1, n_tc)
    a2 = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.float32 and a.shape == (M, N)
    assert torch.equal(a, a2)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    floor = _k1_f32_floor(MM, x, codes, scale, k_x, N, pb)
    assert bool(((a - b).abs() <= floor).all())


@pytest.mark.parametrize("bits", [8, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M", [4, 32])
@pytest.mark.parametrize("variant", ["x_bf16", "w_bf16", "cast_bf16"])
def test_dequant_matmul_float32_route_bf16_sides(dev, bits, M, variant):
    """The route's other instances: bf16 activations against a float32
    weight, and float32 activations against a weight rounded to bf16 (a
    bf16 leaf, or a pending cast), each within the fp32 floor."""
    from repro_torch.comm import matmul as MM
    K, N = 2304, 1001
    x, codes, scale, k_x, pb = _k1_fma_case(
        dev, M, K, N, bits, 7 * M + bits,
        torch.bfloat16 if variant == "x_bf16" else torch.float32)
    w_dtype = "bfloat16" if variant == "w_bf16" else "float32"
    cast = "bfloat16" if variant == "cast_bf16" else None
    kw = dict(k_x=k_x, n=N, pack_bits=pb, w_dtype=w_dtype, cast_dtype=cast)
    assert MM.route(x.dtype, codes.dtype, pb, w_dtype, cast) == "fma"
    n_fma = MM.launches_fma
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert MM.launches_fma == n_fma + 1
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.float32
    floor = _k1_f32_floor(MM, x, codes, scale, k_x, N, pb, cast, w_dtype)
    assert bool(((a - b).abs() <= floor).all())


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matmul_float32_tier_catches_a_dropped_row(dev, bits):
    """The planted fault at the chunk's M = 32: the plain product with its
    last K row dropped fails the float32 tier the kernel passes."""
    from repro_torch.comm import matmul as MM
    M, K, N = 32, 4096, 1024
    x, codes, scale, k_x, pb = _k1_fma_case(dev, M, K, N, bits, 123 + bits)
    kw = dict(k_x=k_x, n=N, pack_bits=pb)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    floor = _k1_f32_floor(MM, x, codes, scale, k_x, N, pb)
    assert bool(((a - b).abs() <= floor).all())
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=pb,
                         w_dtype="float32", cast_dtype=None)
    bad = x[:, :-1] @ w[:-1]
    assert bool(((bad - b).abs() > floor).any())


# ---------------------------------------------------------------------------
# K1t on CUDA cores (float32), the session's CUDA graphs
# ---------------------------------------------------------------------------

def _k1t_f32_case(dev, M, V, d, bits, seed, variant="f32"):
    """x (M, d) float32 (bf16 for ``x_bf16``) and code rows (V, d) of one
    width; the kwargs of the CUDA-core route and the floor of its tier,
    K1_FLOOR sqrt(d) 2^-24 |x*w|_2."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, pb = _k1t_case(dev, M, V, d, bits, seed)
    x = x.to(torch.bfloat16 if variant == "x_bf16" else torch.float32)
    w_dtype = "bfloat16" if variant == "w_bf16" else "float32"
    kw = dict(k_x=k_x, n=d, pack_bits=pb, w_dtype=w_dtype, transpose=True)
    w = MM.dequant_codes(codes, scale, k_x=k_x, n=d, pack_bits=pb,
                         w_dtype=w_dtype, cast_dtype=None).float()
    floor = K1_FLOOR * d ** 0.5 * 2.0 ** -24 * (
        x.float() ** 2 @ (w ** 2).T).sqrt()
    return x, codes, scale, kw, w, floor


@pytest.mark.parametrize("variant", ["f32", "x_bf16", "w_bf16"])
@pytest.mark.parametrize("bits", [8, 16, 2, 3, 4, 6])
@pytest.mark.parametrize("M", [1, 3, 4, 5, 8, 17])
@pytest.mark.parametrize("V,d", [(512, 2304), (1001, 2304), (256, 1000),
                                 (77, 37)])
def test_dequant_matmul_t_float32_tier(dev, variant, bits, M, V, d):
    """K1t's CUDA-core route (float32 activations or weights, every code
    type, every row tile of ``matmul.t_fma_plan``) within the floor of
    the plain product; two calls bitwise equal; t_launches_fma moves."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, kw, _, floor = _k1t_f32_case(
        dev, M, V, d, bits, M * V + d + bits, variant)
    assert MM.route(x.dtype, codes.dtype, kw["pack_bits"], kw["w_dtype"],
                    None) == "fma"
    n = (MM.t_launches_tc, MM.t_launches_fma)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    a2 = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert (MM.t_launches_tc, MM.t_launches_fma) == (n[0], n[1] + 2)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.dtype == b.dtype == torch.float32 and a.shape == (M, V)
    assert torch.equal(a, a2)
    assert bool(((a - b).abs() <= floor).all())


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_matmul_t_float32_tier_catches_a_dropped_column(dev, bits):
    """The planted fault: the plain float32 product with its last d column
    dropped fails the tier the CUDA-core kernel passes."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, kw, w, floor = _k1t_f32_case(dev, 4, 1001, 2304, bits,
                                                  77 + bits)
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert bool(((a - b).abs() <= floor).all())
    bad = x[:, :-1] @ w[:, :-1].T
    assert bool(((bad - b).abs() > floor).any())


def _smoke_training(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import QAdamConfig, qadam
    from repro_torch.models.model import Model
    cfg = get_config("yi-6b", smoke=True)
    model = Model(cfg)
    opt = qadam(QAdamConfig(alpha=1e-3, grad_q="log:6",
                            weight_q="uniform_amax:7",
                            weight_q_min_numel=2 ** 14))

    def loss_fn(p, b):
        s, n = model.loss(p, b)
        return s / n
    return cfg, model, opt, loss_fn


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def test_session_scan_chunk_graph_equals_eager(dev, deterministic):
    """``scan_chunk=3`` on the card: the first chunk eager, the second
    captured and replayed, the third replayed, a tail of one eager; losses
    and parameters bitwise the step-by-step session's."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    cfg, model, opt, loss_fn = _smoke_training(dev)

    def run(chunk):
        sess = TrainSession.from_optimizer(
            opt, loss_fn, model.init(seed=0, device=dev),
            batch_for_model(cfg, 32, 4), SessionConfig(log_every=3,
                                                       scan_chunk=chunk),
            log=lambda *_: None)
        losses = {}
        harvest = sess.harvest_losses

        def keep():
            out = harvest()
            losses.update(out)
            return out
        sess.harvest_losses = keep
        for n in (9, 1):
            sess.run(n)
        sess.close()
        return sess, losses

    ref, ref_losses = run(1)
    got, losses = run(3)
    assert sorted(losses) == list(range(1, 11))
    assert losses == ref_losses
    assert (got.stats["graph_captures"], got.stats["graph_replays"],
            got.stats["dispatches"]) == (1, 2, 4)
    for a, b in zip(tree_leaves(got.state["params"]),
                    tree_leaves(ref.state["params"])):
        assert torch.equal(a, b)
    for f in ("m", "v", "e"):
        for a, b in zip(tree_leaves(getattr(got.state["opt"], f)),
                        tree_leaves(getattr(ref.state["opt"], f))):
            assert torch.equal(a, b)
    assert got.state["opt"].count == ref.state["opt"].count == 10


def test_chunked_train_step_graph_equals_eager(dev, deterministic):
    """``make_chunked_train_step`` on the card: three calls of 2 steps on
    the same (donated) tensors (eager, captured and replayed, replayed)
    give the step-by-step session's losses and parameters bitwise."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           make_chunked_train_step,
                                           stack_batches, stage_batch)
    from repro_torch.tree import tree_leaves
    cfg, model, opt, loss_fn = _smoke_training(dev)
    ref = TrainSession.from_optimizer(
        opt, loss_fn, model.init(seed=0, device=dev),
        batch_for_model(cfg, 32, 4), SessionConfig(log_every=1),
        log=lambda *_: None)
    ref.run(6)
    ref.close()
    fn = make_chunked_train_step(opt, loss_fn)
    params = model.init(seed=0, device=dev)
    state = opt.init(params)
    gen = batch_for_model(cfg, 32, 4)
    losses = []
    for _ in range(3):
        stacked = stack_batches([stage_batch(next(gen), dev)
                                 for _ in range(2)])
        params, state, ls = fn(params, state, stacked)
        losses += ls.tolist()
    assert fn.stats == {"graph_captures": 1, "graph_replays": 2}
    assert losses == [h["loss"] for h in ref.history]
    assert state.count == 6
    for a, b in zip(tree_leaves(params), tree_leaves(ref.state["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["terngrad_sgd", "qadam-terngrad"])
def test_session_graph_equals_eager_for_terngrad(dev, deterministic, name):
    """TernGrad under CUDA graphs: the draws' keys come from the state key,
    split in place on the device, so one eager chunk, one capture and two
    replays give the step-by-step session's losses and every state tensor
    (the key too) bitwise; the threefry kernels launch and no plain
    version runs."""
    from repro_torch.core.qadam import QAdamConfig, qadam, terngrad_sgd
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.kernels import prng
    from repro_torch.train.session import SessionConfig, TrainSession
    cfg, model, _, loss_fn = _smoke_training(dev)
    make_opt = {"terngrad_sgd": lambda: terngrad_sgd(alpha=1e-3, seed=3),
                "qadam-terngrad": lambda: qadam(QAdamConfig(
                    alpha=1e-3, grad_q="terngrad"), seed=3)}[name]
    k0, u0, p0 = prng.keys_launches, prng.uniform_launches, \
        prng.plain_on_cuda
    _graph_vs_eager(lambda k: TrainSession.from_optimizer(
        make_opt(), loss_fn, model.init(seed=0, device=dev),
        batch_for_model(cfg, 32, 4),
        SessionConfig(log_every=2, scan_chunk=k), log=lambda *_: None))
    assert prng.keys_launches > k0 and prng.uniform_launches > u0
    assert prng.plain_on_cuda == p0


def test_terngrad_checkpoint_resume_on_the_card(dev, tmp_path):
    """An Algorithm 1 TernGrad session checkpointed after 2 steps (its
    state key as uint32) and resumed in a new session for 2 more is
    bitwise 4 unbroken steps, the key included."""
    from repro_torch.core.qadam import terngrad_sgd
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           _tensor_leaves)
    cfg, model, _, loss_fn = _smoke_training(dev)

    def sess(**kw):
        return TrainSession.from_optimizer(
            terngrad_sgd(alpha=1e-3, seed=5), loss_fn,
            model.init(seed=0, device=dev), batch_for_model(cfg, 32, 4),
            SessionConfig(log_every=0, ckpt_dir=str(tmp_path), **kw),
            log=lambda *_: None)
    whole = sess()
    whole.run(4)
    first = sess(ckpt_every=2)
    first.run(2)
    first.wait_for_checkpoints()
    first.close()
    second = sess()
    assert second.resume() == 2
    second.run(2)
    for (k, x), (_, y) in zip(_tensor_leaves(whole.state),
                              _tensor_leaves(second.state)):
        assert torch.equal(x, y), k
    whole.close()
    second.close()


def _graph_vs_eager(make, runs=(6,), chunk=2):
    """Losses and state of ``make(scan_chunk=chunk)`` against
    ``make(scan_chunk=1)`` over ``runs``: every step's loss from the
    session's own harvests."""
    from repro_torch.train.session import _tensor_leaves

    def go(k):
        sess = make(k)
        losses = {}
        harvest = sess.harvest_losses

        def keep():
            out = harvest()
            losses.update(out)
            return out
        sess.harvest_losses = keep
        for n in runs:
            sess.run(n)
        sess.close()
        return sess, losses
    ref, ref_losses = go(1)
    got, losses = go(chunk)
    assert losses == ref_losses
    assert sorted(losses) == list(range(1, sum(runs) + 1))
    assert (got.stats["graph_captures"], got.stats["graph_replays"]) == (
        1, sum(runs) // chunk - 1)
    a, b = _tensor_leaves(got.state), _tensor_leaves(ref.state)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("name", ["ef_sgdm", "qadam-blockwise",
                                  "qadam-no-ef"])
def test_session_graph_equals_eager_for_each_optimizer(dev, deterministic,
                                                       name):
    """The other single-machine optimizers allowed under graphs: one
    eager chunk, one capture, two replays; losses and every state tensor
    bitwise the step-by-step session's."""
    from repro_torch.core.qadam import QAdamConfig, ef_sgdm, qadam
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import SessionConfig, TrainSession
    cfg, model, _, loss_fn = _smoke_training(dev)
    base = dict(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
                weight_q_min_numel=2 ** 14)
    make_opt = {
        "ef_sgdm": lambda: ef_sgdm(alpha=1e-3),
        "qadam-blockwise": lambda: qadam(QAdamConfig(
            **dict(base, grad_q="blockwise:256"))),
        "qadam-no-ef": lambda: qadam(QAdamConfig(
            **dict(base, error_feedback=False))),
    }[name]
    _graph_vs_eager(lambda k: TrainSession.from_optimizer(
        make_opt(), loss_fn, model.init(seed=0, device=dev),
        batch_for_model(cfg, 32, 4),
        SessionConfig(log_every=2, scan_chunk=k), log=lambda *_: None))


@pytest.fixture(scope="module")
def nccl_group(dev):
    from repro_torch.launch import mesh as TM
    group = TM.make_process_group(dev, store=torch.distributed.HashStore())
    yield group
    TM.close_process_group()


@pytest.mark.parametrize("mode,kw", [
    ("qadam", dict(grad_k=6, weight_k=7)),
    ("dp_adam", dict(grad_k=None, weight_k=None)),
    ("efadam", dict(grad_k=6, weight_k=7, weight_absolute=False)),
    ("ef_sgd", dict(beta=0.9, grad_k=None, weight_k=None)),
    ("terngrad", dict(alpha=2e-2, grad_k=None, weight_k=None)),
])
def test_distributed_session_graph_equals_eager(dev, deterministic,
                                                nccl_group, mode, kw):
    """Each distributed mode under graphs on one NCCL rank (the
    collectives in the graph; TernGrad's threefry keys folded from each
    step's t in the device step table): losses and every state tensor
    bitwise the step-by-step session's."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.train.session import SessionConfig, TrainSession
    cfg, model, _, _ = _smoke_training(dev)
    art = make_train_step(model, nccl_group,
                          TrainConfig(**dict(dict(alpha=1e-3, mode=mode),
                                             **kw)))
    _graph_vs_eager(lambda k: TrainSession.from_artifacts(
        art, batch_for_model(cfg, 32, 4),
        SessionConfig(log_every=2, scan_chunk=k), device=dev,
        log=lambda *_: None))


@pytest.mark.parametrize("chunk", [1, 2])
def test_hierarchical_one_by_one_is_the_flat_step(dev, deterministic,
                                                  nccl_group, chunk):
    """``HierarchicalTopology(1, 1)`` on a (pod=1, data=1, model=1) grid
    of one NCCL rank runs the tiered path (the intra gather, the
    exchange over the inter tier, the inter-first broadcast) and is
    bitwise the flat step on the plain group: losses, master, m, v and
    e, eager and with ``scan_chunk=2`` (one CUDA graph a chunk); K15, K7
    and K6 launch and no plain version runs. A flat session that swaps
    in the 1x1 step half way (``swap_artifacts``: the old graph
    released, the new step captured) is bitwise the flat run."""
    from repro_torch.comm import kernels as K
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist import topology as T
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.kernels import adam_ef as A
    from repro_torch.launch import mesh as TM
    from repro_torch.train.session import SessionConfig, TrainSession
    from repro_torch.tree import tree_leaves
    cfg, model, _, _ = _smoke_training(dev)
    tc = TrainConfig(alpha=1e-3, grad_k=6, weight_k=7)
    arts = {"flat": make_train_step(model, nccl_group, tc),
            "1x1": make_train_step(
                model, TM.make_grid(pod=1, data=1, model=1, device=dev),
                dataclasses.replace(tc,
                                    topology=T.HierarchicalTopology(1, 1)))}
    assert arts["1x1"].tiers.hierarchical
    assert not arts["flat"].tiers.hierarchical

    def session(name):
        return TrainSession.from_artifacts(
            arts[name], batch_for_model(cfg, 32, 4),
            SessionConfig(log_every=2, scan_chunk=chunk), device=dev,
            log=lambda *_: None)
    sessions = {}
    for name in ("flat", "1x1"):
        K.ef_encode_log_launches = K.decode_log_launches = 0
        A.moments_launches = 0
        plain = K.plain_on_cuda + A.plain_on_cuda
        with session(name) as sess:
            sess.run(8)
        assert min(K.ef_encode_log_launches, K.decode_log_launches,
                   A.moments_launches) > 0
        assert K.plain_on_cuda + A.plain_on_cuda == plain
        sessions[name] = sess
    with session("flat") as sess:
        sess.run(4)
        before = [(x.data_ptr(), x.clone())
                  for x in tree_leaves(sess.state["master"])]
        sess.swap_artifacts(arts["1x1"])
        for (ptr, x), y in zip(before, tree_leaves(sess.state["master"])):
            assert ptr == y.data_ptr() and torch.equal(x, y)
        sess.run(4)
    assert sess.stats["graph_captures"] == (2 if chunk == 2 else 0)
    sessions["swapped"] = sess
    b = sessions["flat"]
    want = {h["step"]: h["loss"] for h in b.history}
    for name in ("1x1", "swapped"):
        a = sessions[name]
        # the swapped session's second run() also logs its first step
        # (a run's first dispatch is read): compare the losses by step
        got = {h["step"]: h["loss"] for h in a.history}
        assert set(want) <= set(got), name
        assert {s: got[s] for s in want} == want, name
        for f in ("master", "m", "v", "e"):
            for x, y in zip(tree_leaves(a.state[f]),
                            tree_leaves(b.state[f])):
                assert torch.equal(x, y), (name, f)


ADAPTIVE_PLAN = ("blockwise:256", "log:2", "log:6", "log:30", "log:126",
                 "uniform_amax:14:w16") * 2


def test_adaptive_session_graph_equals_eager(dev, deterministic,
                                             nccl_group):
    """The adaptive mode with every lane of the plan (the 2-bit blockwise
    lanes among them) under CUDA graphs on one NCCL rank: losses, every
    state tensor and every step's stats rows bitwise the step-by-step
    session's; no plain version on the card."""
    from repro_torch.comm import kernels as K
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.train.session import SessionConfig, TrainSession
    cfg, model, _, _ = _smoke_training(dev)
    art = make_train_step(model, nccl_group, TrainConfig(
        alpha=1e-3, grad_k=6, weight_k=7, mode="adaptive",
        bit_plan=ADAPTIVE_PLAN))
    rows = {}

    def make(k):
        sess = TrainSession.from_artifacts(
            art, batch_for_model(cfg, 32, 4),
            SessionConfig(log_every=2, scan_chunk=k, stats_ring=6),
            device=dev, log=lambda *_: None)
        harvest = sess.harvest_losses

        def keep():
            rows.setdefault(k, {}).update(
                {s: r for s, r in sess.harvest_stats()})
            return harvest()
        sess.harvest_losses = keep
        return sess
    plain = K.plain_on_cuda
    _graph_vs_eager(make)
    assert K.plain_on_cuda == plain
    assert sorted(rows[1]) == sorted(rows[2]) and len(rows[1]) == 6
    for s in rows[1]:
        np.testing.assert_array_equal(rows[1][s], rows[2][s])


def test_adaptive_controller_swaps_graphs_on_the_card(dev, nccl_group):
    """The controller at scan_chunk=2, a replan every 4 steps: the state
    carries over every swap (the same tensors), each plan is captured
    after one eager dispatch, one host sync a window, and the accounting
    of every plan is exact against payloads encoded on the card."""
    from repro_torch.adapt.controller import AdaptConfig, AdaptiveController
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig
    from repro_torch.train.session import SessionConfig, _tensor_leaves
    cfg, model, _, _ = _smoke_training(dev)
    ctl = AdaptiveController(
        model, nccl_group, TrainConfig(alpha=1e-3, grad_k=6, weight_k=7),
        batch_for_model(cfg, 32, 4), AdaptConfig(replan_every=4),
        SessionConfig(log_every=0, scan_chunk=2), device=dev,
        log=lambda *_: None, verify=True)
    with ctl:
        ptrs = [x.data_ptr() for _, x in _tensor_leaves(ctl.state)]
        ctl.run(12)
        assert [x.data_ptr() for _, x in _tensor_leaves(ctl.state)] == ptrs
        assert ctl.stats["syncs"] == 3
        n_plans = len(ctl.plan_log)
        assert n_plans >= 2
        # a capture for each plan that ran two dispatches of its own
        assert ctl.stats["graph_captures"] == n_plans
        for e in ctl.plan_log:
            assert e["verify"]["measured"] == \
                e["comm"]["update_exchange_bytes"]


def test_resume_on_the_card_holds_one_state(dev, tmp_path):
    """resume() on the card writes into the state's tensors: the device
    holds the state and nothing more while it restores, and the restored
    state equals the saved one bitwise."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import (SessionConfig, TrainSession,
                                           _replaced, _tensor_leaves)
    cfg, model, opt, loss_fn = _smoke_training(dev)

    def make():
        return TrainSession.from_optimizer(
            opt, loss_fn, model.init(seed=0, device=dev),
            batch_for_model(cfg, 32, 4),
            SessionConfig(log_every=0, ckpt_dir=str(tmp_path)),
            log=lambda *_: None)
    with make() as a:
        a.run(2)
        a.checkpoint()
    b = make()
    before = _tensor_leaves(b.state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    assert b.resume() == 2
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == base
    assert _replaced(before, b.state) == []
    for (k, x), (_, y) in zip(_tensor_leaves(a.state), before):
        assert torch.equal(x, y), k
    b.close()


def _served_smoke(dev, arch, seed=5):
    """A smoke model of ``arch`` with random QKV biases and qk-norm
    weights (zeros and ones would hide a missing term), quantized at
    k_x = 6 on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import quantize_params
    model = Model(get_config(arch, smoke=True))
    params = model.init(seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    attn = params["blocks"].get("attn", {})
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = 0.5 * torch.randn(attn[name].shape, generator=g,
                                           device=dev)
    for name in ("q_norm", "k_norm"):
        if name in attn:
            attn[name] = 1 + 0.3 * torch.randn(attn[name].shape, generator=g,
                                               device=dev)
    return model, quantize_params(params, k_x=6, min_numel=256)


def _serve_mixed(model, params, dev, **kw):
    """Two greedy requests for 5 steps (the greedy step's warm-up,
    capture and replays), then a sampled interactive arrival that
    preempts a batch-class one (the sampling step's), and more requests
    than slots (admission mid flight), greedy and sampled."""
    from repro_torch.serve.session import Request, ServeSession
    sess = ServeSession(model, params, slots=2, max_seq=48, seed=3,
                        prefill_chunk=4, device=dev, **kw)
    reqs = [Request(prompt=list(range(3 + i, 9 + 2 * i)),
                    max_new_tokens=16 if i < 2 else 6,
                    temperature=0.7 if i == 3 else 0.0, slo="batch")
            for i in range(4)]
    hs = [sess.submit(r) for r in reqs[:2]]
    for _ in range(5):
        sess.step()
    hs.append(sess.submit(Request(prompt=[11, 12, 13], max_new_tokens=6,
                                  temperature=0.9, slo="interactive")))
    hs += [sess.submit(r) for r in reqs[2:]]
    res = sess.drain()
    return sess, [res[h].tokens for h in hs]


@pytest.mark.parametrize("arch,kw", [
    ("gemma3-4b", dict(paged=True, page_size=8)),
    ("qwen2.5-14b", dict(paged=True, page_size=8)),
    ("yi-6b", dict()),
    ("yi-6b", dict(prefill="inject")),
    ("gemma3-4b", dict(prefill="whole")),
    ("mamba2-2.7b", dict()),
    ("hymba-1.5b", dict(paged=True, page_size=8))], ids=str)
def test_session_decode_graph_equals_eager(dev, arch, kw, monkeypatch):
    """The decode step as one CUDA graph (a capture per kind, greedy and
    sampling, then replays) gives the eager session's tokens and cache
    bitwise, across admission mid flight and a preemption."""
    from repro_torch.serve.session import ServeSession
    model, params = _served_smoke(dev, arch)
    graphed, tokens = _serve_mixed(model, params, dev, **kw)
    assert graphed.stats["captures"] == 2 and graphed.stats["replays"] > 0
    assert graphed.stats["preemptions"] == 1
    monkeypatch.setattr(ServeSession, "_dispatch",
                        lambda self, sample: self._decode(sample))
    eager, want = _serve_mixed(model, params, dev, **kw)
    assert eager.stats["captures"] == eager.stats["replays"] == 0
    assert tokens == want
    for name, t in graphed._state["cache"].items():
        assert torch.equal(t, eager._state["cache"][name]), name
    for name in ("out", "gen", "pos", "cur", "rng"):
        assert torch.equal(graphed._state[name], eager._state[name]), name


def test_session_decode_capture_failures_raise(dev, monkeypatch):
    """A host read inside the step breaks its capture, and a step that
    rebinds a state tensor would replay against the old one: both
    raise."""
    from repro_torch.serve.session import Request, ServeSession
    model, params = _served_smoke(dev, "yi-6b")
    real = ServeSession._decode

    def run():
        sess = ServeSession(model, params, slots=2, max_seq=48, device=dev)
        sess.submit(Request(prompt=[5, 6, 7], max_new_tokens=8))
        sess.drain()

    def host_read(self, sample):
        real(self, sample)
        int(self._state["pos"][0])
    monkeypatch.setattr(ServeSession, "_decode", host_read)
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        run()

    def rebinds(self, sample):
        real(self, sample)
        self._state["gen"] = self._state["gen"] + 0
    monkeypatch.setattr(ServeSession, "_decode", rebinds)
    with pytest.raises(RuntimeError, match="replaced the state tensors"):
        run()


# ---------------------------------------------------------------------------
# the MoE family: the expert stacks on K12, the router on K1, the layer
# graphed, and a closed training session's memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,k_x", [(torch.int8, 6), (torch.int16, 10)])
def test_expert_stack_dequantize_through_k12(dev, dtype, k_x):
    """``QuantizedLeaf.dequantize()`` of a code-resident (L, E, d, f)
    expert stack and of one sliced layer, with and without a pending
    bf16 cast: one K12 launch a call, bitwise the plain version (which
    counts as a plain version on the card)."""
    from repro_torch.comm import kernels as K
    from repro_torch.serve import quantized as Q
    g = torch.Generator(device=dev).manual_seed(k_x)
    lim = 2 ** k_x
    codes = torch.randint(-lim, lim + 1, (3, 8, 64, 44), generator=g,
                          device=dev).to(dtype)
    scale = torch.rand(3, generator=g, device=dev) + 0.01
    leaf = Q.QuantizedLeaf(codes=codes, scale=scale, k_x=k_x,
                           shape=tuple(codes.shape), dtype="float32")
    for one in (leaf, leaf.layer(1), leaf.astype(torch.bfloat16),
                leaf.layer(2).astype(torch.bfloat16)):
        n, p = K.dequantize_launches, Q.plain_on_cuda
        a = one.dequantize()
        assert K.dequantize_launches == n + 1 and Q.plain_on_cuda == p
        b = one.dequantize(backend="torch")
        assert Q.plain_on_cuda == p + 1
        assert a.dtype == b.dtype and a.shape == b.shape
        _bits_equal(a, b)


@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("K,N", [(2048, 64), (5120, 16)])
def test_dequant_matmul_router_shapes(dev, M, K, N):
    """K1 at the MoE routers' shapes (deepseek-moe-16b's (2048, 64),
    llama4-maverick's cut to 16 experts, (5120, 16)) with int8 codes: on
    tensor cores for bf16 activations within one bf16 ulp plus the
    floor, on CUDA cores for float32 within the fp32 floor."""
    from repro_torch.comm import matmul as MM
    x, codes, scale, k_x, _ = _k1_tc_case(dev, M, K, N, 8, M + K + N)
    kw = dict(k_x=k_x, n=N, cast_dtype="bfloat16")
    n_tc = MM.launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert MM.launches_tc == n_tc + 1
    assert bool(((a.float() - b.float()).abs()
                 <= _k1_bf16_tol(MM, x, codes, scale, k_x, b)).all())
    xf = x.float()
    n_fma = MM.launches_fma
    a = MM.dequant_matmul(xf, codes, scale, backend="cuda", k_x=k_x, n=N)
    b = MM.dequant_matmul(xf, codes, scale, backend="torch", k_x=k_x, n=N)
    assert MM.launches_fma == n_fma + 1
    floor = _k1_f32_floor(MM, xf, codes, scale, k_x, N, 0)
    assert bool(((a - b).abs() <= floor).all())


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_graph_equals_eager(dev, dispatch):
    """``layers.moe`` on the card, bf16 activations, with drops (4
    tokens, 8 experts top-3: capacity 2; every token prefers expert 0):
    two eager runs and a replay of its CUDA graph bitwise equal (the
    sorts are stable, the dispatch gathers, the combine sums in a fixed
    order)."""
    from repro_torch.models import layers as L
    from repro_torch.models.config import MoEConfig
    g = torch.Generator(device=dev).manual_seed(3)
    E, d, fe = 8, 256, 128
    mcfg = MoEConfig(n_experts=E, top_k=3, n_shared=1, d_ff_expert=fe,
                     dispatch=dispatch)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.05
    params = {"router": w(d, E), "w_gate": w(E, d, fe), "w_up": w(E, d, fe),
              "w_down": w(E, fe, d),
              "shared": {"w_gate": w(d, fe), "w_up": w(d, fe),
                         "w_down": w(fe, d)}}
    v = torch.randn(d, generator=g, device=dev)
    params["router"][:, 0] = v / d
    x = (v + 0.3 * torch.randn(4, 1, d, generator=g, device=dev)).to(
        torch.bfloat16)
    with torch.no_grad():
        y1, a1 = L.moe(params, x, mcfg)
        y2, a2 = L.moe(params, x, mcfg)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg, ag = L.moe(params, x, mcfg)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(yg, y1) and torch.equal(ag, a1)
    _, _, idx = L.moe_route(params, x.reshape(4, d), mcfg)
    load = torch.bincount(idx.reshape(-1), minlength=E)
    assert int(load.max()) > L.capacity(4, mcfg)      # a pair is dropped


def test_close_frees_graph_memory(dev):
    """A ``scan_chunk=4`` session (eager, capture and replay, replay)
    closed and dropped: the allocated bytes return to their level before
    it, with no ``gc.collect()`` (the session keeps no reference cycle,
    and ``close()`` drops the graph and its static buffers). A first
    session of the same kind warms the process-wide caches (the log
    grid tables); cuBLAS's workspaces are given back before each
    reading."""
    import gc
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.train.session import SessionConfig, TrainSession
    cfg, model, opt, loss_fn = _smoke_training(dev)
    params = model.init(seed=0, device=dev)

    def run():
        sess = TrainSession.from_optimizer(
            opt, loss_fn, params, batch_for_model(cfg, 32, 4),
            SessionConfig(log_every=4, scan_chunk=4), log=lambda *_: None)
        sess.run(12)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        assert sess.stats["graph_captures"] == 1
        sess.close()
        assert sess._chunks is None
        return held

    def allocated():     # cuBLAS's workspaces given back first
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    run()
    gc.collect()
    before = allocated()
    gc.disable()
    try:
        held = run()
        after = allocated()
    finally:
        gc.enable()
    print(f"allocated before {before} B, while open {held} B, after close "
          f"{after} B")
    assert held > before and after == before


# ---------------------------------------------------------------------------
# the SSM and hybrid family: K1 and K1t at the new shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 3, 4, 6])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("K,N", [(2560, 10576), (5120, 2560), (1600, 6482),
                                 (3200, 1600)])
def test_dequant_matmul_ssm_shapes(dev, bits, M, K, N):
    """K1 on tensor cores at mamba2-2.7b's and hymba-1.5b's in_proj and
    out_proj (M = 4: a decode step; 128: a prefill chunk), int8 codes and
    3/4/6-bit lanes: the lanes packed by #9 bitwise the plain packing and
    unpacked back to the codes (6,482 codes fill no whole 3- or 6-bit
    group), the product within one bf16 ulp plus the floor."""
    from repro_torch.comm import bits as B
    from repro_torch.comm import kernels as KN
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(M + K + N + bits)
    k_x = _TC_K_X[bits]
    lim = 2 ** k_x
    raw = torch.randint(-lim, lim + 1, (K, N), generator=g, device=dev)
    if bits < 8:
        raw = torch.clamp(raw, -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
        codes = KN.pack_rows(raw.to(torch.int8), bits, backend="cuda")
        assert torch.equal(codes, B.pack_rows(raw, bits))
        assert torch.equal(KN.unpack_rows(codes, bits, N, backend="cuda"),
                           raw.to(torch.int8))
    else:
        codes = raw.to(torch.int8)
    pb = bits if bits < 8 else 0
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.tensor(0.0371, device=dev)
    kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype="bfloat16")
    n_tc = MM.launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert MM.launches_tc == n_tc + 1
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.shape == b.shape == (M, N)
    tol = _k1_bf16_tol(MM, x, codes, scale, k_x, b, pb)
    assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.parametrize("V,d", [(50280, 2560), (32001, 1600)])
@pytest.mark.parametrize("M", [1, 4])
def test_dequant_matmul_t_ssm_heads(dev, V, d, M):
    """K1t on tensor cores over the tied heads of mamba2-2.7b (50,280
    rows) and hymba-1.5b (32,001: odd) with int8 codes, within one bf16
    ulp plus the floor."""
    from repro_torch.comm import matmul as MM
    g = torch.Generator(device=dev).manual_seed(V + M)
    codes = torch.randint(-64, 65, (V, d), generator=g, device=dev).to(
        torch.int8)
    x = torch.randn(M, d, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.tensor(0.0371, device=dev)
    kw = dict(k_x=6, n=d, cast_dtype="bfloat16", transpose=True)
    n_t = MM.t_launches_tc
    a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
    assert MM.t_launches_tc == n_t + 1
    b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
    assert a.shape == b.shape == (M, V)
    w = MM.dequant_codes(codes, scale, k_x=6, n=d, pack_bits=0,
                         w_dtype="float32", cast_dtype="bfloat16").float()
    norm = (x.float() ** 2 @ (w ** 2).T).sqrt()
    tol = _bf16_ulp(b.float()) + K1_FLOOR * d ** 0.5 * 2.0 ** -24 * norm
    assert bool(((a.float() - b.float()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# the performance tooling's launch geometries (repro_torch.perf)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["log:6", "uniform_amax:7:w8", "log:2"])
@pytest.mark.parametrize("n_rows,numel", [(1, 4096 * 9 + 3), (2, 1),
                                          (3, 1100), (4, 513 * 7),
                                          (5, 11008 * 3 + 1)])
def test_codec_blocks_per_sm_bitwise(dev, spec, n_rows, numel):
    """K7, #5 and K6 write the same bits at every blocks-an-SM value
    (``set_enc_rows``): payloads, residuals and decodes, ragged chunks
    and n_rows 1-5, against the default grid and the plain versions."""
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    codec = CD.get_codec(spec)
    g = torch.Generator(device=dev).manual_seed(n_rows * 7 + numel)
    x = torch.randn(numel, generator=g, device=dev)
    c = -(-numel // n_rows)

    def run():
        payload, scale = K.encode_rows(x, codec, n_rows)
        e = torch.empty_like(x)
        ef, _ = K.ef_encode_rows(x, scale.reshape(1), codec, n_rows, out=e)
        scales = scale.reshape(1).expand(n_rows).contiguous()
        return payload, ef, e, K.decode_rows(payload, scales, codec, c)

    want = run()
    plain_payload, _ = K.encode_rows(x, codec, n_rows, backend="torch")
    assert torch.equal(want[0], plain_payload)
    try:
        for b in (1, 2, 4, 8, 16):
            K.set_enc_rows(b)
            for a, w in zip(run(), want):
                assert a.dtype == w.dtype and torch.equal(
                    a.view(torch.uint8), w.view(torch.uint8)), b
    finally:
        K.set_enc_rows(None)


@pytest.mark.parametrize("plan", [(128, 1), (256, 2), (128, 8), (256, 40)])
def test_dequant_matmul_tuned_plan_tier(dev, plan):
    """K1 on tensor cores under an installed plan (``set_mm_cols``) within
    one bf16 ulp plus the K1_FLOOR term of the plain version; a dropped K
    row still fails that tier."""
    from repro_torch.comm import matmul as MM
    from repro_torch.perf.autotune import k1_operands
    m, k, n = 4, 4096, 6482
    x, codes, scale = k1_operands(m, k, n, 6, dev, seed=sum(plan))
    kw = dict(k_x=6, n=n, pack_bits=0, w_dtype="float32",
              cast_dtype="bfloat16")
    key = MM.mm_key(m, k, n, 8)
    MM.set_mm_cols(plan, key=key)
    try:
        assert MM.k1_plan(m, k, n, 8).tile_n == plan[0]
        got = MM.dequant_matmul(x, codes, scale, **kw).float()
    finally:
        MM.set_mm_cols(None, key=key)
    want = MM.dequant_matmul(x, codes, scale, backend="torch", **kw).float()
    w = MM.dequant_codes(codes, scale, k_x=6, n=n, pack_bits=0,
                         w_dtype="float32", cast_dtype="bfloat16").float()
    unit = k ** 0.5 * 2.0 ** -24 * (x.float() ** 2 @ w ** 2).sqrt()
    tol = _bf16_ulp(want) + K1_FLOOR * unit
    assert bool(((got - want).abs() <= tol).all())
    dropped = codes.clone()
    dropped[k // 2] = 0
    bad = MM.dequant_matmul(x, dropped, scale, backend="torch", **kw).float()
    assert not bool(((bad - want).abs() <= tol).all())


def test_aot_library_round_trip(dev, tmp_path):
    """The kernel library saved as an AOT artifact loads with ctypes in
    place of the built one and launches the same bits; a torn artifact is
    a miss."""
    from repro_torch import build
    from repro_torch.comm import kernels as K
    from repro_torch.perf import aot
    build.library()
    x = torch.randn(3, 1000, device=dev)
    want = K.amax_rows(x)
    stats = {}
    aot.load_or_compile(len, (x,), aot_dir=str(tmp_path), facts="t",
                        stats=stats, device=dev)
    assert stats.get("aot_saves") == 1
    saved = (build._lib, build._lib_path, build.origin)
    build._lib = None
    try:
        stats = {}
        aot.load_or_compile(len, (x,), aot_dir=str(tmp_path), facts="t",
                            stats=stats, device=dev)
        assert stats == {"aot_loads": 1} and build.origin == "aot"
        assert torch.equal(K.amax_rows(x), want)
        key = aot.step_key("t", (x,))
        with open(aot.artifact_path(str(tmp_path), key), "wb") as f:
            f.write(b"torn")
        assert aot.load(str(tmp_path), key) is None
    finally:
        build._lib, build._lib_path, build.origin = saved
