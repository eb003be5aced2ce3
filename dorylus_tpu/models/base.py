"""Model API shared by GCN/GAT.

A model is a thin namespace of pure functions over a params pytree and a
`GraphBatch` pytree. The GraphBatch is the on-device analog of the
reference engine's per-layer savedNNTensors/savedEdgeTensors maps
(engine.hpp:157-158) — except that here the whole layer pipeline is one
jitted function, so intermediate tensors live in device memory managed by
XLA rather than in named maps.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax.numpy as jnp


class GraphBatch(NamedTuple):
    """Device-resident tensors for one vertex shard (or the whole graph).

    Edge arrays index into a feature table = concat(local H, ghost H)
    when halo is present; padding edges carry edge_val == 0.
    """

    x: jnp.ndarray  # (Vp, F) input features
    onehot: jnp.ndarray  # (Vp, C)
    src: jnp.ndarray  # (Ep,) int32 into feature table
    dst: jnp.ndarray  # (Ep,) int32 into [0, Vp)
    edge_val: jnp.ndarray  # (Ep,) float32 GCN norms (or ones for GAT)
    self_val: jnp.ndarray  # (Vp,) float32 self-loop norms
    train_mask: jnp.ndarray  # (Vp,) float32
    val_mask: jnp.ndarray  # (Vp,) float32
    test_mask: jnp.ndarray  # (Vp,) float32
    denom: jnp.ndarray  # () float32 = |V_global| * TRAIN_PORTION
    # Optional per-graph auxiliary arrays (e.g. SpMM plan arrays);
    # carried in the batch so they reach compiled code as jit arguments.
    aux: Optional[dict] = None
    # Optional interior/boundary edge split (sharded overlap path):
    # interior src index local rows; boundary src index the ghost table.
    # Aggregating interior edges is independent of the halo all_to_all,
    # letting XLA overlap communication with compute.
    src_int: Optional[jnp.ndarray] = None
    dst_int: Optional[jnp.ndarray] = None
    val_int: Optional[jnp.ndarray] = None
    src_bnd: Optional[jnp.ndarray] = None
    dst_bnd: Optional[jnp.ndarray] = None
    val_bnd: Optional[jnp.ndarray] = None

    @property
    def num_vertices(self) -> int:
        return self.x.shape[0]


Params = Dict[str, jnp.ndarray]
