"""Serving: continuous-batching sessions over code-resident quantized
weights, with a paged KV cache bounding concurrency by tokens in flight
(port of ``repro/serve``; the same 13 names)."""
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged import PagePool, gather_pages, pages_for
from repro_torch.serve.quantized import (QuantizedLeaf, cache_nbytes,
                                         is_quantized, make_dequant_gather,
                                         params_nbytes, quantize_params)
from repro_torch.serve.session import Request, Result, ServeSession

__all__ = ["Engine", "PagePool", "QuantizedLeaf", "Request", "Result",
           "ServeSession", "cache_nbytes", "gather_pages", "is_quantized",
           "make_dequant_gather", "pages_for", "params_nbytes",
           "quantize_params"]
