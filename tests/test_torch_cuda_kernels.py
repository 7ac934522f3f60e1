"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; skipped where there is no GPU).

Run on a GPU machine with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``. Tiers: quantize codes, scales and
page gathers bitwise; the dequant-matmul within float32 summation-order
tolerance (f32 activations) or one bf16 ulp plus a floor of
K1_FLOOR sqrt(K) 2^-24 |x*w|_2 near zero (bf16 activations), the tier of
``chip_smoke.py``.
"""
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_pages_bitwise(dev, dtype):
    from repro_torch.serve import paged
    g = torch.Generator(device=dev).manual_seed(0)
    pool = torch.randn(10, 16, 4, 128, generator=g, device=dev).to(dtype)
    tab = torch.tensor([[3, 1, 9, 10], [0, 10, 10, 10], [7, 2, 5, 4]],
                       dtype=torch.int32, device=dev)
    a = paged.gather_pages(pool, tab, backend="cuda")
    b = paged.gather_pages(pool, tab, backend="torch")
    assert torch.equal(a, b)


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
