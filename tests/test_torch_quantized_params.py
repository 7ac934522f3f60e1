"""The port's ``quantize_params`` / ``QuantizedLeaf`` against the JAX
package's on the yi-6b and gemma2-2b smoke parameters (gemma2: the tied
``embed`` table and the post-sublayer norm leaves).

Tier: bitwise (codes, scales, dequantized weights, row lookups, resident
byte counts); the tied head's ``matmul_t`` within rtol 1e-5 / atol 1e-6
of the reference's (float32 summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import Model as JModel
from repro.serve import quantized as JQ
from repro_torch.convert import params_from_numpy
from repro_torch.serve import quantized as TQ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _smoke_params(arch):
    return JModel(jget(arch, smoke=True)).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def smoke_params():
    return _smoke_params("yi-6b")


@pytest.mark.parametrize("k_x,pack", [(6, False), (6, True), (2, True),
                                      (3, True), (1, True), (7, False)])
def test_quantize_params_bitwise(smoke_params, k_x, pack):
    jq = JQ.quantize_params(smoke_params, k_x=k_x, min_numel=256, pack=pack)
    tp = params_from_numpy(jax.tree.map(np.asarray, smoke_params), "cpu")
    tq = TQ.quantize_params(tp, k_x=k_x, min_numel=256, pack=pack)
    jl = jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda l: isinstance(l, JQ.QuantizedLeaf))[0]
    n_q = 0
    for path, leaf in jl:
        keys = [k.key for k in path]
        node = tq
        for k in keys:
            node = node[k]
        if isinstance(leaf, JQ.QuantizedLeaf):
            n_q += 1
            assert isinstance(node, TQ.QuantizedLeaf), keys
            _eq(leaf.codes, node.codes)
            _eq(leaf.scale, node.scale)
            assert (leaf.k_x, leaf.shape, leaf.dtype, leaf.pack_bits) == \
                (node.k_x, node.shape, node.dtype, node.pack_bits)
            _eq(leaf.dequantize(), node.dequantize())
            if len(leaf.shape) == 3:
                _eq(jax.tree.map(lambda a: a[1], leaf).dequantize(),
                    node.layer(1).dequantize())
        else:
            _eq(leaf, node)
    assert n_q >= 9
    if "unembed" not in smoke_params:      # gemma2: one tied table
        assert TQ.is_qleaf(tq["embed"])
        assert TQ.is_qleaf(tq["blocks"]["ln1_post"]["w"])
        assert TQ.is_qleaf(tq["blocks"]["ln2_post"]["w"])
    assert TQ.params_nbytes(tq) == JQ.params_nbytes(jq)
    assert TQ.params_nbytes(tp) == JQ.params_nbytes(smoke_params)


def test_take_matches_full_dequant(smoke_params):
    jq = JQ.quantize_params(smoke_params, k_x=2, min_numel=256, pack=True)
    tq = TQ.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, smoke_params), "cpu"),
        k_x=2, min_numel=256, pack=True)
    idx = np.array([[3, 511, 0], [7, 7, 100]], np.int32)
    _eq(jq["embed"].astype(jnp.float32).take(jnp.asarray(idx)),
        tq["embed"].astype(torch.float32).take(torch.from_numpy(idx)))
    full = tq["embed"].dequantize()
    assert torch.equal(tq["embed"].take(torch.from_numpy(idx)),
                       full[torch.from_numpy(idx).long()])


def test_dequant_gather_keeps_matmul_leaves_as_codes(smoke_params):
    tq = TQ.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, smoke_params), "cpu"),
        k_x=6, min_numel=256)
    g = TQ.make_dequant_gather()
    static = g(tq, "static")
    assert TQ.is_qleaf(static["embed"])
    assert TQ.is_qleaf(static.get("unembed", static["embed"]))
    assert TQ.is_qleaf(static["blocks"]["attn"]["q"])
    blk = g(TQ.layer_slice(tq["blocks"], 0), "blocks")
    assert TQ.is_qleaf(blk["attn"]["q"]) and TQ.is_qleaf(blk["mlp"]["w_down"])
    assert isinstance(blk["ln1"]["w"], torch.Tensor)
    plain = TQ.make_dequant_gather(fused=False)(
        TQ.layer_slice(tq["blocks"], 0), "blocks")
    assert isinstance(plain["attn"]["q"], torch.Tensor)


@pytest.mark.parametrize("k_x,pack", [(6, False), (2, True)])
def test_tied_head_from_the_embedding_codes(smoke_params, k_x, pack):
    """``matmul_t`` of the one ``embed`` leaf against the reference's;
    the table is held once (no second copy for the head)."""
    jq = JQ.quantize_params(smoke_params, k_x=k_x, min_numel=256, pack=pack)
    tq = TQ.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, smoke_params), "cpu"),
        k_x=k_x, min_numel=256, pack=pack)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    ref = jq["embed"].astype(jnp.float32).matmul_t(jnp.asarray(x))
    g = TQ.make_dequant_gather()(tq, "static")
    assert g["embed"] is tq["embed"]            # the same codes, not a copy
    out = g["embed"].astype(torch.float32).matmul_t(torch.from_numpy(x))
    assert out.shape == (3, 512)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    tables = [l for l in TQ.tree_leaves(tq) if TQ.is_qleaf(l)
              and 512 in l.shape]
    assert len(tables) == (2 if "unembed" in tq else 1)


class TestGemma2:
    """The checks that take ``smoke_params``, on gemma2-2b."""

    @pytest.fixture(scope="class")
    def smoke_params(self):
        return _smoke_params("gemma2-2b")

    test_quantize_params_bitwise = staticmethod(test_quantize_params_bitwise)
    test_take_matches_full_dequant = staticmethod(
        test_take_matches_full_dequant)
    test_dequant_gather_keeps_matmul_leaves_as_codes = staticmethod(
        test_dequant_gather_keeps_matmul_leaves_as_codes)
    test_tied_head_from_the_embedding_codes = staticmethod(
        test_tied_head_from_the_embedding_codes)
