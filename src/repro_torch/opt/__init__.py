"""Quantizer grids and the backend-dispatched quantize entry points."""
