"""Distributed QAdam-EF, Algorithms 2+3 (port of ``repro/dist``).

  sharding     - parameter layout: model-axis shard dims + worker chunking
  topology     - link-tier topologies (flat / hierarchical)
  collectives  - the quantized wire (packed uint8 exchange / broadcast)
  modes        - per-mode optimizer plugins (qadam/dp_adam/efadam/
                 terngrad/ef_sgd/adaptive)
  step         - make_train_step: the mode-independent worker-step template
                 over a launch.mesh.Grid (workers x model shards);
                 ServeConfig
  serve        - make_serve_step: the sharded serving step (decode and
                 prefill for every arch type; the KV cache split along
                 the sequence, a page pool along its pages, over the
                 model axis; weights gathered each step, float32 or
                 int8 Q_x codes)

Importing the package initializes no process group.
"""
from repro_torch.dist import (sharding, topology, collectives, modes,  # noqa: F401
                              step, serve)
