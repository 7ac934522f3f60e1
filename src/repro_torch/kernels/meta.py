"""The hand-written kernels on the ``meta`` device (the dry run,
``launch.dryrun``).

A kernel wrapper given meta tensors launches nothing (its tensors have
no storage): :func:`charged` runs its plain version for the outputs'
shapes and dtypes with the accounting paused, and charges the kernel's
own traffic instead, each input read once and each output written once
(an ``out=`` buffer written only), with its operations where it is a
product. Nested wrappers inside a charged one are not charged again.
Without an accountant (outside a dry run) the plain version runs as it
would. CUDA and CPU tensors take the wrapper's own path untouched.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

# installed by launch.dryrun: an object with ``begin()`` and
# ``end(name, nbytes, flops, result)``; None outside a dry run
accountant: Optional[object] = None
_depth = 0


def _tensors(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def charged(name: str, flops: Optional[Callable] = None):
    """Decorate a kernel wrapper: on meta tensors (first argument) inside
    a dry run, charge ``name`` with its inputs and outputs and
    ``flops(*args, **kw)`` operations."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            global _depth
            acc = accountant
            if acc is None or not args or \
                    not isinstance(args[0], torch.Tensor) or \
                    args[0].device.type != "meta":
                return fn(*args, **kw)
            if _depth:
                return fn(*args, **kw)
            _depth += 1
            acc.begin()
            out, ok = None, False
            try:
                out = fn(*args, **kw)
                ok = True
            finally:
                _depth -= 1
                if ok:
                    ins = _tensors((args, {k: v for k, v in kw.items()
                                           if k != "out"}))
                    traffic = nbytes(ins) + nbytes(_tensors(out))
                    ops = float(flops(*args, **kw)) if flops else 0.0
                    acc.end(name, traffic, ops, out)
                else:
                    acc.end(None, 0, 0.0, None)
            return out
        return wrapper
    return deco
