"""K2 page gather wrapper (plain version on the CPU), the PagePool
allocator, and cache accounting against the JAX package.

Tier: bitwise (gathered views, allocation sequences, byte counts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import Model as JModel
from repro.serve import paged as JP
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.models.model import Model as TModel
from repro_torch.serve import paged as TP
from repro_torch.serve import quantized as TQ


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_matches_reference_bitwise(backend, dtype):
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((10, 4, 2, 8)).astype(np.float32)
    tab = rng.integers(0, 10, size=(3, 5)).astype(np.int32)
    tab[1, 3:] = 10                     # RELEASED sentinel: clipped
    jpool = jnp.asarray(pool)
    tpool = torch.from_numpy(pool)
    if dtype == "bfloat16":
        jpool, tpool = jpool.astype(jnp.bfloat16), tpool.to(torch.bfloat16)
    ref = JP.gather_pages(jpool, jnp.asarray(tab), backend=backend)
    out = TP.gather_pages(tpool, torch.from_numpy(tab))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                  out.float().numpy())


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_gather_pages_kv_matches_reference_bitwise(backend, dtype):
    """K and V of a layer through one table (one launch on the card)
    against the reference's gather_pages called once per pool, with
    RELEASED-sentinel rows (clipped to the last page) and a released
    slot."""
    rng = np.random.default_rng(1)
    pk = rng.standard_normal((12, 4, 2, 8)).astype(np.float32)
    pv = rng.standard_normal((12, 4, 2, 8)).astype(np.float32)
    tab = rng.integers(0, 12, size=(4, 6)).astype(np.int32)
    tab[1, 2:] = 12                     # RELEASED sentinel tail
    tab[3, :] = 12                      # a released slot
    jk, jv = jnp.asarray(pk), jnp.asarray(pv)
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    if dtype == "bfloat16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    n0 = (TP.launches, TP.launches_kv)
    kc, vc = TP.gather_pages_kv(tk, tv, torch.from_numpy(tab))
    assert (TP.launches, TP.launches_kv) == n0     # the CPU never launches
    for ref, out in ((JP.gather_pages(jk, jnp.asarray(tab), backend=backend),
                      kc),
                     (JP.gather_pages(jv, jnp.asarray(tab), backend=backend),
                      vc)):
        assert out.shape == ref.shape and out.dtype == tk.dtype
        np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                      out.float().numpy())


def test_gather_pages_kv_refuses_mismatched_pools():
    tab = torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        TP.gather_pages_kv(torch.zeros(2, 2, 1, 2), torch.zeros(3, 2, 1, 2),
                           tab)
    with pytest.raises(ValueError, match="differ"):
        TP.gather_pages_kv(torch.zeros(2, 2, 1, 2),
                           torch.zeros(2, 2, 1, 2, dtype=torch.bfloat16), tab)
    with pytest.raises(ValueError):
        TP.gather_pages_kv(torch.zeros(2, 2, 1, 2), torch.zeros(2, 2, 1, 2),
                           tab, backend="cuda")


def test_gather_never_launches_on_cpu():
    n0 = TP.launches
    TP.gather_pages(torch.zeros(2, 2, 1, 2), torch.zeros(1, 3, dtype=torch.int32))
    assert TP.launches == n0
    with pytest.raises(ValueError):
        TP.gather_pages(torch.zeros(2, 2, 1, 2),
                        torch.zeros(1, 3, dtype=torch.int32), backend="cuda")


def test_page_pool_sequences_match_reference():
    rng = np.random.default_rng(3)
    a, b = JP.PagePool(16, 4), TP.PagePool(16, 4)
    held_a, held_b = [], []
    for _ in range(300):
        if held_a and rng.random() < 0.5:
            i = int(rng.integers(len(held_a)))
            a.free(held_a.pop(i))
            b.free(held_b.pop(i))
        else:
            n = int(rng.integers(1, 5))
            ga, gb = a.alloc(n), b.alloc(n)
            assert ga == gb
            if ga is not None:
                held_a.append(ga)
                held_b.append(gb)
        assert (a.free_pages, a.used_pages) == (b.free_pages, b.used_pages)
    for n in (0, 1, 4, 5, 100):
        assert TP.pages_for(n, 4) == JP.pages_for(n, 4)
    assert a.nbytes(3, 512) == b.nbytes(3, 512)


def test_page_pool_errors():
    pool = TP.PagePool(4, 2)
    pages = pool.alloc(2)
    with pytest.raises(ValueError):
        pool.free([99])
    pool.free(pages)
    with pytest.raises(RuntimeError):
        pool.free(pages + pool.alloc(2))
    with pytest.raises(ValueError):
        TP.PagePool(0, 2)


@pytest.mark.parametrize("page_pool", [None, (12, 8)])
def test_cache_nbytes_matches_reference(page_pool):
    jm = JModel(jget("yi-6b", smoke=True))
    tm = TModel(tget("yi-6b", smoke=True))
    jc = jm.init_cache(3, 48, page_pool=page_pool)
    tc = tm.init_cache(3, 48, page_pool=page_pool, device="cpu")
    assert TQ.cache_nbytes(tc) == JQ.cache_nbytes(jc)
    for k, v in jc.items():
        np.testing.assert_array_equal(np.asarray(v).astype(np.float32)
                                      if v.dtype != jnp.int32 else np.asarray(v),
                                      tc[k].float().numpy() if tc[k].is_floating_point()
                                      else tc[k].numpy())
