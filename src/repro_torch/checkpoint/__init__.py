"""Checkpoints of parameter trees and training state (port of
``repro/checkpoint``): :mod:`repro_torch.checkpoint.store`."""
