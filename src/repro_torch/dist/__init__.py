"""Distributed training, Algorithms 2+3 (port of ``repro/dist``)."""
