"""Code-resident quantized weights for serving (port of
``repro/serve/quantized.py``).

``quantize_params(params, k_x)`` replaces every large float leaf with a
:class:`QuantizedLeaf`: integer codes (int8, int16 above k_x=6, or the
codec's packed 3/4/6-bit lanes with ``pack=True``) plus f32 scales, one
per layer for the scan-stacked ``blocks`` leaves. Quantization runs the
K3 amax and K4 quantize kernels on CUDA tensors (one launch each per
leaf). Matmul-shaped leaves stay as codes through
``make_dequant_gather`` and feed the K1 dequant-matmul; the rest (norm
stacks, MoE expert stacks (L, E, d, f), embedding rows) dequantize at
use, per layer, through the K12 uniform dequantize kernel on CUDA
tensors (``QuantizedLeaf.dequantize``; one launch a call, one row of
codes a layer).

Parameter trees are nested dicts of tensors, as the reference's; the
model loops over layers in Python and slices stacked leaves with
:meth:`QuantizedLeaf.layer`, where the reference's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.comm import bits as B
from repro_torch.comm import kernels as K
from repro_torch.comm import matmul as MM
from repro_torch.comm.codec import UniformCodec, resolve_backend
from repro_torch.opt import engine, grids
from repro_torch.tree import tree_leaves

_STACKED_KEYS = ("blocks", "enc_blocks")
plain_on_cuda = 0   # plain dequantizes of CUDA leaves (K12 bypassed)


def code_rows(codes: torch.Tensor, scale: torch.Tensor):
    """(codes as (rows, n), scale as (rows,)): one row a layer for a
    stacked leaf's per-layer scales, one row for a 0-d scale. A view of
    contiguous codes: K12 reads the codes where they lie."""
    rows = scale.numel() if scale.dim() else 1
    return codes.reshape(rows, -1), scale.reshape(rows)


@dataclasses.dataclass
class QuantizedLeaf:
    """One parameter tensor held as integer codes + scales.

    codes: integer codes with the leaf's logical shape; with
        ``pack_bits`` set, uint8 rows of ``pack_bits``-bit lanes (the
        ``comm.bits`` layout, per leading row).
    scale: f32 0-d tensor (per-tensor) or (L,) per-layer for stacked
        leaves.
    shape: the logical shape; it stays the stacked shape when
        :meth:`layer` slices one layer out, as the reference's aux does.
    cast: pending ``astype`` target, applied after dequantization.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    k_x: int
    shape: Tuple[int, ...]
    dtype: str
    pack_bits: int = 0
    cast: Optional[str] = None

    @property
    def nbytes(self) -> int:
        """Actual resident bytes (codes + scales)."""
        return (self.codes.numel() * self.codes.element_size()
                + self.scale.numel() * self.scale.element_size())

    def astype(self, dt) -> "QuantizedLeaf":
        """Defer a dtype cast; applied after dequant by every consumer."""
        return dataclasses.replace(self, cast=_dtype_name(dt))

    def layer(self, i: int) -> "QuantizedLeaf":
        """One layer of a stacked leaf (codes[i], scale[i])."""
        return dataclasses.replace(self, codes=self.codes[i],
                                   scale=self.scale[i])

    def _finish(self, codes: torch.Tensor, scale: torch.Tensor,
                backend: Optional[str] = None) -> torch.Tensor:
        """``codes`` (this leaf's, or rows of them) dequantized with
        ``scale`` (0-d, or one a leading row), then the leaf's dtype and
        the pending cast. On CUDA tensors K12 does the dequantize
        (``comm.kernels.uniform_dequantize_rows``), bitwise the plain
        ``grids.uniform_dequantize``; on the CPU, or with
        ``backend="torch"``, the plain version runs."""
        global plain_on_cuda
        if self.pack_bits:
            lead = codes.shape[:-1]
            flat = codes.reshape(-1, codes.shape[-1])
            numel = self.shape[-1]
            codes = B.unpack_rows(flat, self.pack_bits, numel).reshape(
                lead + (numel,))
        if resolve_backend(backend, codes, scale) == "cuda":
            rows, srow = code_rows(codes, scale)
            out = K.uniform_dequantize_rows(rows, srow, self.k_x,
                                            backend="cuda").reshape(
                                                codes.shape)
        else:
            plain_on_cuda += codes.is_cuda
            if scale.dim():   # per-layer scales over their layer
                scale = scale.reshape(tuple(scale.shape)
                                      + (1,) * (codes.dim() - 1))
            out = grids.uniform_dequantize(codes, scale, self.k_x)
        out = out.to(MM._dtype(self.dtype))
        return out.to(MM._dtype(self.cast)) if self.cast else out

    def dequantize(self, backend: Optional[str] = None) -> torch.Tensor:
        """Codes -> float tensor (per-layer scales over their layer)."""
        return self._finish(self.codes, self.scale, backend)

    def _mm(self, x, transpose: bool, backend: Optional[str]):
        return MM.dequant_matmul(x, self.codes, self.scale, k_x=self.k_x,
                                 n=self.shape[-1], pack_bits=self.pack_bits,
                                 w_dtype=self.dtype, cast_dtype=self.cast,
                                 transpose=transpose, backend=backend)

    def matmul(self, x: torch.Tensor, backend: Optional[str] = None):
        """``x @ W`` without materializing W (K1 fused dequant-matmul);
        a stacked leaf is sliced with :meth:`layer` first."""
        return self._mm(x, False, backend)

    def matmul_t(self, x: torch.Tensor, backend: Optional[str] = None):
        """``x @ W.T`` from the code rows (K1t; tied logit heads read the
        same codes the embedding lookup :meth:`take` does)."""
        return self._mm(x, True, backend)

    def take(self, idx: torch.Tensor) -> torch.Tensor:
        """Row lookup (embedding tables): gather only the requested code
        rows and dequantize those."""
        return self._finish(self.codes[idx.long()], self.scale)


def _dtype_name(dt) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dt] \
        if isinstance(dt, torch.dtype) else str(dt)


def is_qleaf(x) -> bool:
    return isinstance(x, QuantizedLeaf)


def tree_map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over a nested dict (QuantizedLeaf is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _quantize_leaf(p: torch.Tensor, k_x: int, absolute: bool,
                   per_layer: bool, pack: bool) -> QuantizedLeaf:
    codes, scale = engine.quantize_uniform(p, k_x, absolute=absolute,
                                           per_layer=per_layer)
    # the registry's exact (unclipped) lane: sub-8-bit lanes are packed,
    # 8/16-bit codes stay as they are
    codec = UniformCodec(k_x=k_x, absolute=absolute)
    pack_bits = 0
    if pack and codec.bits < 8:
        pack_bits = codec.bits
        lead = codes.shape[:-1]
        rows = B.pack_rows(codes.reshape(-1, codes.shape[-1]), pack_bits)
        codes = rows.reshape(lead + (rows.shape[-1],))
    return QuantizedLeaf(codes=codes, scale=scale, k_x=k_x,
                         shape=tuple(p.shape), dtype=_dtype_name(p.dtype),
                         pack_bits=pack_bits)


def quantize_params(params, k_x: int = 6, *, absolute: bool = False,
                    min_numel: int = 2 ** 14, pack: bool = False):
    """Replace large float leaves with code-resident :class:`QuantizedLeaf`.

    Stacked ``blocks`` leaves get per-layer scales. Leaves smaller than
    ``min_numel`` (biases, small norms) stay float. The input tree is not
    modified; each float leaf is read once.
    """
    def one(path, p):
        if (not isinstance(p, torch.Tensor) or not p.is_floating_point()
                or p.dim() == 0 or p.numel() < min_numel):
            return p
        per_layer = bool(path) and path[0] in _STACKED_KEYS and p.dim() > 1
        return _quantize_leaf(p, k_x, absolute, per_layer, pack)

    return tree_map_with_path(one, params)


def is_quantized(params) -> bool:
    return any(is_qleaf(l) for l in tree_leaves(params))


# Leaf names whose contraction the model expresses as ``x @ w`` (or an
# embed lookup): these stay code-resident and run K1.
_MATMUL_KEYS = frozenset({
    "q", "k", "v", "o", "w_gate", "w_up", "w_down", "router",
    "in_proj", "out_proj", "embed", "unembed",
})


def _fused_ok(path, leaf, kind: str) -> bool:
    """A known projection name AND a 2-D logical weight (3-D stacked
    shape for a per-layer slice, whose shape stays the stacked one)."""
    if not path or path[-1] not in _MATMUL_KEYS:
        return False
    return len(leaf.shape) == (2 if kind == "static" else 3)


def make_dequant_gather(fused: bool = True, backend: Optional[str] = None):
    """The per-layer parameter hook for code-resident params:
    ``gather(subtree, kind)`` with kind "static" (the whole tree: stacked
    subtrees are left for the layer loop) or "blocks" (one layer's
    slice). Matmul-shaped leaves stay as codes (``fused``); everything
    else (norm stacks, MoE expert stacks) dequantizes here, at use, on
    K12 (``backend`` as in :meth:`QuantizedLeaf.dequantize`). With
    ``fused=False`` a matmul leaf is dequantized in plain PyTorch and
    multiplied by ``torch.matmul``: on a CUDA tensor that counts as a
    plain version on the card (``matmul.plain_on_cuda``), since K1 is
    bypassed."""
    def gather(subtree, kind: str):
        def one(path, leaf):
            if kind == "static" and path and path[0] in _STACKED_KEYS:
                return leaf
            if not is_qleaf(leaf):
                return leaf
            if _fused_ok(path, leaf, kind):
                if fused:
                    return leaf
                MM.plain_on_cuda += leaf.codes.is_cuda
            return leaf.dequantize(backend)
        return tree_map_with_path(one, subtree)

    return gather


def layer_slice(tree, i: int):
    """Layer ``i`` of a scan-stacked subtree (tensors and QuantizedLeafs)."""
    return tree_map_with_path(
        lambda _, l: l.layer(i) if is_qleaf(l) else l[i], tree)


def params_nbytes(params) -> int:
    """Actual resident bytes of a parameter tree (codes + scales for
    quantized leaves, tensor bytes otherwise)."""
    return sum(l.nbytes if is_qleaf(l) else l.numel() * l.element_size()
               for l in tree_leaves(params))


def cache_nbytes(cache) -> int:
    """Resident bytes of a decode cache (fixed lanes or pool + tables)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))
