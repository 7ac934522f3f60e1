"""The port's ``quantize_params`` / ``QuantizedLeaf`` against the JAX
package's on the yi-6b smoke parameters.

Tier: bitwise (codes, scales, dequantized weights, row lookups, resident
byte counts).
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


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def smoke_params():
    cfg = jget("yi-6b", smoke=True)
    return JModel(cfg).init(jax.random.PRNGKey(0))


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
    assert TQ.is_qleaf(static["embed"]) and TQ.is_qleaf(static["unembed"])
    assert TQ.is_qleaf(static["blocks"]["attn"]["q"])
    blk = g(TQ.layer_slice(tq["blocks"], 0), "blocks")
    assert TQ.is_qleaf(blk["attn"]["q"]) and TQ.is_qleaf(blk["mlp"]["w_down"])
    assert isinstance(blk["ln1"]["w"], torch.Tensor)
    plain = TQ.make_dequant_gather(fused=False)(
        TQ.layer_slice(tq["blocks"], 0), "blocks")
    assert isinstance(plain["attn"]["q"], torch.Tensor)
