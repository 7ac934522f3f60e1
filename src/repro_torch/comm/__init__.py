"""Lane packing, backend policy, and the serving kernels' wrappers."""
