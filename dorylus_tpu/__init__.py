"""dorylus_tpu — a full-graph GNN training framework in JAX.

A from-scratch rebuild of the capabilities of uclasystem/dorylus (OSDI'21)
as one compiled accelerator program (run on NVIDIA GPUs): the reference's
graph-server Gather/Scatter tiers become XLA sparse aggregation kernels,
the serverless ApplyVertex / ApplyEdge tier collapses into on-device dense
matmuls, and the
weight-server parameter-server tier becomes replicated parameters with
`psum` gradient all-reduce over a `jax.sharding.Mesh`.

Layout:
    common/    config, logging, metrics (reference: src/common, engine/utils.cpp)
    graph/     graph containers, partitioning, ghost/halo plans, dataset IO
               (reference: src/graph-server/graph, inputs/)
    ops/       aggregation (SpMM), SDDMM, activations — XLA paths
               (reference: engine/ops/*.cpp, funcs/*/ops)
    models/    GCN / GAT with Dorylus-exact semantics (reference: funcs/gcn, funcs/gat)
    optim/     Adam matching weight-server AdamOptimizer (reference: src/weight-server)
    parallel/  mesh, shard_map train step, halo-exchange collectives
               (reference: commmanager/, nodemanager/)
    engine/    epoch driver, eval, early stop, checkpointing
               (reference: engine/engine.cpp, engine/ops/pipeline.cpp)
"""

__version__ = "0.1.0"

from dorylus_tpu.common.config import LayerConfig, TrainConfig  # noqa: F401
