"""The port's threefry2x32 (``repro_torch.core.threefry``) and the plain
versions of its kernels (``repro_torch.kernels.prng``, which the wrappers
run on the CPU) against ``jax.random`` at jax's default
``jax_threefry_partitionable``, on the CPU. Tier: bitwise, every word and
every float.

  * ``threefry2x32`` against ``jax._src.prng.threefry_2x32``;
    ``prng_key``, ``fold_in`` (data 0, 1, 2^31, 2^32 - 1), ``split``
    (n = 1..7) and ``uniform`` (n = 1, 3, 4, 4099, a 2-D shape) against
    ``jax.random``; ``random_bits`` at a ``start`` whose counters reach
    the high word against threefry over ``iota`` counters; random keys
    and data (hypothesis);
  * the key tables: ``step_keys`` (the distributed chain, t a device
    tensor) against ``repro/dist/step.py``'s folds, ``advance_keys``
    (Algorithm 1's, the key advanced in place) against
    ``repro/core/qadam.py``'s splits, ``draw_uniform`` against
    ``jax.random.uniform`` under the distributed chain.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax._src import prng as JP

from repro_torch.core import threefry as TF
from repro_torch.core import uniforms
from repro_torch.kernels import prng

U32 = st.integers(0, 2 ** 32 - 1)


def _words(key) -> np.ndarray:
    """A jax key (or the port's) -> its two words as uint32."""
    if isinstance(key, torch.Tensor):
        return key.numpy().view(np.uint32)
    return np.asarray(key).astype(np.uint32)


def _jkey(words) -> jax.Array:
    return jnp.asarray(np.asarray(words, np.uint32))


def _eq(want, got):
    np.testing.assert_array_equal(_words(want), _words(got))


def test_threefry2x32_bitwise():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 1000), dtype=np.uint32)
    want = JP.threefry_2x32(_jkey(k), jnp.asarray(x.reshape(-1)))
    want = np.asarray(want).reshape(2, -1)
    y0, y1 = TF.threefry2x32(int(k[0]), int(k[1]),
                             torch.from_numpy(x[0].astype(np.int64)),
                             torch.from_numpy(x[1].astype(np.int64)))
    np.testing.assert_array_equal(want[0], y0.numpy())
    np.testing.assert_array_equal(want[1], y1.numpy())


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, -1, -2 ** 31])
def test_prng_key_bitwise(seed):
    _eq(jax.random.PRNGKey(seed), TF.prng_key(seed))
    assert TF.prng_key(seed).dtype == torch.int32


@pytest.mark.parametrize("data", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_bitwise(data):
    for seed in (0, 42):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        _eq(want, TF.fold_in(TF.prng_key(seed), data))
        _eq(want, TF.fold_in(TF.prng_key(seed),
                             torch.tensor([data], dtype=torch.int64)))


@pytest.mark.parametrize("n", range(1, 8))
def test_split_bitwise(n):
    key = jax.random.PRNGKey(3)
    _eq(jax.random.split(key, n), TF.split(TF.prng_key(3), n))
    assert TF.split(TF.prng_key(3), n).shape == (n, 2)


@pytest.mark.parametrize("shape", [1, 3, 4, 4099, (7, 13)])
def test_uniform_bitwise(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    want = np.asarray(jax.random.uniform(key, shape if isinstance(
        shape, tuple) else (shape,)))
    got = TF.uniform(TF.key_from_uint32(np.asarray(key)), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_random_bits_past_the_low_word():
    """``start`` puts the element counters across 2^32: the high word of
    the counter pair is live, as jax's 64-bit iota makes it."""
    key = jax.random.PRNGKey(11)
    start, n = 2 ** 32 - 3, 8
    i = np.arange(start, start + n, dtype=np.uint64)
    hi, lo = (i >> 32).astype(np.uint32), (i & 0xFFFFFFFF).astype(np.uint32)
    k = np.asarray(key)
    y0, y1 = JP.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                    jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(y0) ^ np.asarray(y1)
    got = TF.random_bits(TF.prng_key(11), n, start)
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    # and the low elements of the same call are the plain draw's
    flat = np.asarray(jax.random.bits(key, (4,)))
    np.testing.assert_array_equal(flat.astype(np.int64),
                                  TF.random_bits(TF.prng_key(11), 4).numpy())
    u = TF.uniform(TF.prng_key(11), n, start).numpy()
    bits = ((want >> 9) | np.uint32(0x3F800000)).view(np.float32) - 1.0
    np.testing.assert_array_equal(bits, u)


@settings(max_examples=40, deadline=None)
@given(k0=U32, k1=U32, data=U32, n=st.integers(1, 40))
def test_random_keys_and_data(k0, k1, data, n):
    jk, tk = _jkey([k0, k1]), TF.key_from_uint32([k0, k1])
    _eq(jax.random.fold_in(jk, data), TF.fold_in(tk, data))
    _eq(jax.random.split(jk, n), TF.split(tk, n))
    want = np.asarray(jax.random.uniform(jk, (n,)))
    np.testing.assert_array_equal(want.view(np.int32),
                                  TF.uniform(tk, n).numpy().view(np.int32))


def test_key_round_trip():
    words = np.array([0xFFFFFFFF, 0x80000000], np.uint32)
    key = TF.key_from_uint32(words)
    assert key.dtype == torch.int32 and key.shape == (2,)
    np.testing.assert_array_equal(TF.uint32_key(key), words)
    np.testing.assert_array_equal(key.view(torch.uint32).numpy(), words)


# ---------------------------------------------------------------------------
# the key tables and the draws, the kernels' plain versions
# ---------------------------------------------------------------------------

def _dist_key(seed, t, leaf, worker):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    return jax.random.fold_in(jax.random.fold_in(key, leaf), worker)


@pytest.mark.parametrize("t,worker", [(1, 0), (7, 3), (2 ** 31 + 5, 1)])
def test_step_keys_are_the_distributed_chain(t, worker):
    tt = torch.tensor([t], dtype=torch.int64)
    keys = prng.step_keys(4, tt, 12, worker)
    assert keys.shape == (12, 2) and keys.dtype == torch.int32
    for leaf in range(12):
        _eq(_dist_key(4, t, leaf, worker), keys[leaf])


def test_advance_keys_is_algorithm_1s_chain():
    """Three steps of ``key, sub = split(key)``, ``split(sub, L)``: the
    tables and the key (advanced in place) the reference's; L = 0 moves
    the key alone."""
    jkey, key = jax.random.PRNGKey(2), TF.prng_key(2)
    addr = key.data_ptr()
    for n_leaves in (5, 0, 3):
        jkey, sub = jax.random.split(jkey)
        table = prng.advance_keys(key, n_leaves)
        assert table.shape == (n_leaves, 2) and key.data_ptr() == addr
        _eq(jkey, key)
        if n_leaves:
            _eq(jax.random.split(sub, n_leaves), table)


def test_draw_uniform_is_the_reference_draw():
    """``draw_uniform(seed, t, leaf, worker, n)`` is the reference's
    distributed draw, and ``uniforms.draw`` over a table the same, at a
    start offset too."""
    want = np.asarray(jax.random.uniform(_dist_key(0, 3, 5, 1), (4099,)))
    got = uniforms.draw_uniform(0, 3, 5, 1, 4099, "cpu")
    np.testing.assert_array_equal(want.view(np.int32),
                                  got.numpy().view(np.int32))
    keys = uniforms.step_keys(0, uniforms.step_tensor(3, "cpu"), 6, 1)
    np.testing.assert_array_equal(
        want, uniforms.draw(keys, 5, 4099).numpy())
    np.testing.assert_array_equal(
        want[100:], prng.uniform(keys, 5, 3999, start=100).numpy())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    key = TF.prng_key(0)
    with pytest.raises(ValueError):
        prng.advance_keys(key.to(torch.int64), 2)
    with pytest.raises(ValueError):
        prng.step_keys(0, torch.tensor([1], dtype=torch.int32), 2, 0)
    with pytest.raises(ValueError):
        prng.uniform(TF.split(key, 2), 2, 10)
    with pytest.raises(ValueError):
        prng.uniform(TF.split(key, 2), 0, 10, out=torch.empty(9))
    with pytest.raises(ValueError, match="CUDA"):
        prng.uniform(TF.split(key, 2), 0, 10, backend="cuda")
