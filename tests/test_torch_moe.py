"""The MoE layer (``repro_torch.models.layers.moe``) against the JAX
package's ``repro.models.layers.moe``, both dispatches, in float32.

Tiers: the router's gate indices and the capacity keep mask bitwise
(inputs whose top-k margins exceed the logits' float32 noise, checked
in the test), planted exact ties in the indices ``jax.lax.top_k``
gives; y within the reference's own sort-vs-einsum tolerance, rtol
1e-5 / atol 1e-6; aux within rtol 1e-6; gradients within rtol 2e-4 /
atol 1e-5 (the reference's ``test_sort_grads_match``); the port's eager
results bitwise equal from run to run. Also the capacity's Python
arithmetic, and code-resident expert stacks dequantized from views.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.config import MoEConfig as JMoE
from repro_torch.models import layers as TL
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.opt import grids
from repro_torch.serve import quantized as TQ

# (top_k, capacity_factor, shared experts); the last two drop pairs
CASES = [(2, 1.25, 0), (1, 1.0, 1), (6, 0.5, 0), (2, 0.5, 1)]
MARGIN = 1e-5     # top-k gaps the routes are compared at (probs units)


def _case(topk, cf, n_shared, seed, B=2, S=16, d=32, E=8, fe=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    p = {"router": rng.normal(size=(d, E), scale=0.5).astype(np.float32),
         "w_gate": rng.normal(size=(E, d, fe), scale=0.1).astype(np.float32),
         "w_up": rng.normal(size=(E, d, fe), scale=0.1).astype(np.float32),
         "w_down": rng.normal(size=(E, fe, d), scale=0.1).astype(np.float32)}
    if n_shared:
        fs = n_shared * fe
        p["shared"] = {
            "w_gate": rng.normal(size=(d, fs), scale=0.1).astype(np.float32),
            "w_up": rng.normal(size=(d, fs), scale=0.1).astype(np.float32),
            "w_down": rng.normal(size=(fs, d), scale=0.1).astype(np.float32)}
    cfg = dict(n_experts=E, top_k=topk, n_shared=n_shared, d_ff_expert=fe,
               capacity_factor=cf)
    return x, p, cfg


def _jax(p):
    return jax.tree.map(jnp.asarray, p)


def _torch(p):
    return jax.tree.map(torch.from_numpy, p)


def _ref_routes(p, x, mcfg):
    """The reference's gate indices (T, k) and keep mask in the pairs'
    token-major order, from its own router and sort dispatch."""
    T, d = x.shape[0] * x.shape[1], x.shape[2]
    xt = jnp.asarray(x.reshape(T, d))
    logits = JL.pmatmul(xt, jnp.asarray(p["router"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    vals, idx = jax.lax.top_k(probs, mcfg.top_k)
    C = max(1, int(np.ceil(T * mcfg.top_k / mcfg.n_experts
                           * mcfg.capacity_factor)))
    _, (st, dest, keep, gv) = JL._moe_dispatch_sort(
        xt, idx, vals, mcfg.n_experts, C)
    order = np.argsort(np.asarray(idx).reshape(-1), kind="stable")
    keep_pairs = np.empty(T * mcfg.top_k, bool)
    keep_pairs[order] = np.asarray(keep)
    return np.asarray(probs), np.asarray(idx), keep_pairs.reshape(T, -1)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_moe_matches_reference(case, dispatch):
    topk, cf, n_shared = case
    x, p, kw = _case(topk, cf, n_shared, seed=topk * 10 + int(cf * 4))
    jcfg = JMoE(dispatch=dispatch, **kw)
    tcfg = TMoE(dispatch=dispatch, **kw)
    jy, jaux = JL.moe(_jax(p), jnp.asarray(x), jcfg)
    tp = _torch(p)
    ty, taux = TL.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    # the routes bitwise: indices and the keep mask of every pair
    probs, jidx, jkeep = _ref_routes(p, x, jcfg)
    top = -np.sort(-probs, axis=1)[:, :topk + 1]
    assert np.diff(top, axis=1).min() < -MARGIN    # no near-tie to flip
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, tvals, tidx = TL.moe_route(tp, xt, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    C = TL.capacity(xt.shape[0], tcfg)
    _, _, tkeep = TL._dispatch_sort(xt, tidx, tcfg.n_experts, C)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    if cf < 1:
        assert not tkeep.all()        # this case drops pairs

    # the port is deterministic: a second eager run is bitwise the first
    ty2, taux2 = TL.moe(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(ty, ty2) and torch.equal(taux, taux2)


def test_planted_ties_follow_lax_top_k():
    """Exact ties in the router probabilities: tokens of zeros (every
    expert ties) and two duplicated router columns. The port's indices
    are the ones ``jax.lax.top_k`` gives for the same probabilities
    (the lower index first), and the reference's own."""
    x, p, kw = _case(3, 1.25, 0, seed=4)
    p["router"][:, 5] = p["router"][:, 1]
    p["router"][:, 6] = p["router"][:, 2]
    x[0, :4] = 0.0
    tcfg = TMoE(**kw)
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    probs, _, idx = TL.moe_route(_torch(p), xt, tcfg)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), tcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert (idx[:4].numpy() == [0, 1, 2]).all()
    pn = probs.numpy()
    assert (pn[:, 5] == pn[:, 1]).all() and (pn[:, 6] == pn[:, 2]).all()
    _, jidx, _ = _ref_routes(p, x, JMoE(**kw))
    np.testing.assert_array_equal(idx.numpy(), jidx)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_grads_match_reference(dispatch):
    """Gradients of sum(y^2) + aux by every weight and by x, against
    ``jax.grad`` of the reference's (capacity 2.0: no drops)."""
    x, p, kw = _case(2, 2.0, 1, seed=0, S=8, d=16, E=4, fe=8)
    jcfg = JMoE(dispatch=dispatch, **kw)
    tcfg = TMoE(dispatch=dispatch, **kw)

    def jloss(pp, xx):
        y, aux = JL.moe(pp, xx, jcfg)
        return jnp.sum(y ** 2) + aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TL.moe(tp, tx, tcfg)
    leaves = jax.tree.leaves(tp) + [tx]
    got = torch.autograd.grad(torch.sum(y ** 2) + aux, leaves)
    for g, want in zip(got, jax.tree.leaves(jgp) + [jgx]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=1e-5)


def test_capacity_in_python_doubles():
    for E, k, cf in ((64, 6, 1.25), (16, 1, 1.25), (4, 2, 16.0),
                     (8, 3, 0.5)):
        m = TMoE(n_experts=E, top_k=k, capacity_factor=cf)
        for T in (1, 4, 7, 32, 128, 2048):
            assert TL.capacity(T, m) == max(1, int(np.ceil(T * k / E * cf)))
    # deepseek's decode step with 4 slots, a chunk of 32, a training step
    ds = TMoE(n_experts=64, top_k=6)
    assert [TL.capacity(T, ds) for T in (4, 32, 2048)] == [1, 4, 240]


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_expert_stack_dequantize_views(dtype):
    """A code-resident (L, E, d, f) expert stack: its codes and a sliced
    layer's reach K12 as (rows, n) views of the codes (no copy), one row
    a layer; on the CPU the plain version runs, bitwise
    ``grids.uniform_dequantize``, with the pending cast after it."""
    rng = np.random.default_rng(1)
    k_x = 6 if dtype == torch.int8 else 10
    lim = 2 ** k_x
    codes = torch.from_numpy(rng.integers(-lim, lim + 1, size=(3, 4, 8, 6))
                             ).to(dtype)
    scale = torch.from_numpy(rng.uniform(0.1, 2.0, 3).astype(np.float32))
    leaf = TQ.QuantizedLeaf(codes=codes, scale=scale, k_x=k_x,
                            shape=tuple(codes.shape), dtype="float32")
    rows, srow = TQ.code_rows(leaf.codes, leaf.scale)
    assert rows.shape == (3, 4 * 8 * 6) and srow.shape == (3,)
    assert rows.data_ptr() == codes.data_ptr()
    one = leaf.layer(2)
    rows1, s1 = TQ.code_rows(one.codes, one.scale)
    assert rows1.shape == (1, 4 * 8 * 6) and s1.shape == (1,)
    assert rows1.data_ptr() == codes[2].data_ptr()
    want = grids.uniform_dequantize(codes, scale[:, None, None, None], k_x)
    before = TQ.plain_on_cuda
    assert torch.equal(leaf.dequantize(), want)
    assert torch.equal(one.dequantize(backend="torch"), want[2])
    bf = one.astype(torch.bfloat16).dequantize()
    assert bf.dtype == torch.bfloat16 and torch.equal(
        bf, want[2].to(torch.bfloat16))
    assert TQ.plain_on_cuda == before        # CPU tensors count nothing
    with pytest.raises(ValueError):
        one.dequantize(backend="cuda")
