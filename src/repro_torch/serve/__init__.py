"""Serving: code-resident weights, the paged KV cache, and sessions."""
