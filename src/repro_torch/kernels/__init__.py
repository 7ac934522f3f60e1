"""Hand-written kernels that have no other home: the Adam+EF update passes."""
