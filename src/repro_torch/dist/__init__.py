"""Distributed QAdam-EF, Algorithms 2+3 (port of ``repro/dist``).

  sharding     - parameter layout: worker chunking (one model shard)
  topology     - link-tier topologies (the flat one is ported)
  collectives  - the quantized wire (packed uint8 exchange / broadcast)
  modes        - per-mode optimizer plugins (qadam/dp_adam/efadam/
                 terngrad/ef_sgd/adaptive)
  step         - make_train_step: the mode-independent worker-step template

Importing the package initializes no process group.
"""
from repro_torch.dist import (sharding, topology, collectives, modes,  # noqa: F401
                              step)
