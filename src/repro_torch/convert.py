"""Carry parameter trees across from the reference package.

The reference's tree, after ``jax.tree.map(np.asarray, params)``, is a
nested dict of numpy arrays whose quantized leaves are objects with
``codes``, ``scale``, ``k_x``, ``shape``, ``dtype`` and ``pack_bits``.
These functions turn it into the port's tree on ``device``, so both
packages compute with the same weights. Nothing here imports the
reference: quantized leaves are read by their attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.quantized import QuantizedLeaf


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def quantized_from_numpy(leaf, device="cuda") -> QuantizedLeaf:
    """One reference ``QuantizedLeaf`` (numpy codes and scale) -> the
    port's, on ``device``."""
    return QuantizedLeaf(codes=_tensor(leaf.codes, device),
                         scale=_tensor(leaf.scale, device).to(torch.float32),
                         k_x=int(leaf.k_x), shape=tuple(leaf.shape),
                         dtype=str(leaf.dtype),
                         pack_bits=int(getattr(leaf, "pack_bits", 0)),
                         cast=getattr(leaf, "cast", None))


def params_from_numpy(tree, device="cuda"):
    """A reference parameter tree (numpy leaves, nested dicts, quantized
    leaves by attribute) -> the port's tree on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "codes") and hasattr(tree, "k_x"):
        return quantized_from_numpy(tree, device)
    return _tensor(tree, device)
