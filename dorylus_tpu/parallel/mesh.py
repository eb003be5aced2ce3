"""Device mesh helpers.

Replaces the reference's NodeManager (dshmachines parsing, master/worker
handshake, ZMQ barrier — nodemanager.cpp:19-229): jax.distributed +
Mesh construction is the membership layer, and any collective is a barrier.

Two axes (the reference has only graph/data parallelism; the second axis
is an extension of this rebuild):

  * 'graph' — vertex shards (partition + halo + grad psum), the
    reference's graph-server tier;
  * 'feat'  — feature/tensor parallelism: each feat shard aggregates a
    column slice of the feature table (the aggregation gather is
    BYTE-rate-bound, so F/m-wide tables split the wall m ways) and the
    layer matmul psums partial products over 'feat'
    (models/gcn.py feat_shards).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

GRAPH_AXIS = "graph"  # vertex-shard axis (graph/data parallelism)
FEAT_AXIS = "feat"  # feature-column axis (tensor parallelism)


def make_mesh(n_shards: int | None = None, devices=None,
              feat_shards: int = 1) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    m = max(1, feat_shards)
    n = n_shards or (len(devs) // m)
    if n * m > len(devs):
        raise ValueError(f"need {n}x{m} devices, have {len(devs)}")
    return Mesh(np.array(devs[: n * m]).reshape(n, m),
                (GRAPH_AXIS, FEAT_AXIS))
