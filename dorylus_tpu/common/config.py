"""Configuration dataclasses.

Mirrors the reference's flag surface: the graph server's ~25 boost
program_options flags (reference: src/graph-server/engine/utils.cpp:313-452),
the weight server's positional argv (src/weight-server/main.cpp:9-43), and the
per-dataset layer-dim config files (run/*.config, e.g. reddit = 602 128 41).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

# Train/val/test split by global vertex index, identical to the reference
# (src/common/utils.hpp:60-62).
TRAIN_PORTION = 0.66
VAL_PORTION = 0.10
TEST_PORTION = 0.24


@dataclass
class LayerConfig:
    """Layer dimensions, one entry per tensor dim along the network.

    Equivalent to the reference's `<dataset>.config` files read by
    readLayerConfigFile (engine/utils.cpp:460): e.g. reddit.config is
    [602, 128, 41] = features -> hidden -> classes for a 2-layer model.
    """

    dims: List[int]

    @property
    def num_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def feature_dim(self) -> int:
        return self.dims[0]

    @property
    def num_classes(self) -> int:
        return self.dims[-1]

    @classmethod
    def from_file(cls, path: str | Path) -> "LayerConfig":
        dims = [int(line) for line in Path(path).read_text().split() if line.strip()]
        return cls(dims=dims)

    # Reference dataset configs (run/*.config).
    PRESETS = {
        "cora": [1433, 16, 7],
        "reddit": [602, 128, 41],
        "amazon": [300, 64, 25],
        "reddit-large": [301, 128, 50],
        "friendster": [32, 48, 51],
    }

    @classmethod
    def preset(cls, name: str) -> "LayerConfig":
        return cls(dims=list(cls.PRESETS[name]))


@dataclass
class TrainConfig:
    """Training hyperparameters + run control.

    Defaults follow the reference run scripts (run/run-onnode:226 lr=0.01,
    benchmarks/run-reddit-gcn epochs; AdamOptimizer.hpp β/ε).
    """

    model: str = "gcn"  # "gcn" | "gat"
    epochs: int = 100
    learning_rate: float = 0.01
    # LR decay hook (weightserver.cpp:296-305: x0.7 each 20 epochs,
    # disabled by default — same default here: 0 = off).
    lr_decay_every: int = 0
    lr_decay_factor: float = 0.7
    adam: bool = True
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7  # reference AdamOptimizer.hpp:22 EPSILON
    weight_decay: float = 0.0

    # Early stopping against a target accuracy, mirroring the weight server's
    # converge state machine (weightserver.cpp:270-294).
    target_accuracy: Optional[float] = None
    # Accuracy threshold ratio at which the async engine switches to sync in
    # the reference (weightserver.hpp switch_threshold); kept as config.
    switch_threshold: float = 0.9

    # Evaluate every N epochs (reference evaluates when eval flag set per chunk).
    eval_every: int = 1

    # Pipeline/async knobs (reference --pipeline / --staleness). The
    # engine is synchronous SPMD; staleness is accepted for CLI parity and
    # bounded-staleness mode is emulated via delayed gradient application.
    pipeline: bool = True
    staleness: Optional[int] = None

    # Parallelism
    num_shards: int = 1  # vertex shards over the mesh 'graph' axis
    # Feature/tensor parallelism over the mesh 'feat' axis (GCN): each
    # feat shard aggregates an F/m column slice (the gather splits m
    # ways) and the layer matmuls psum partial products. An extension
    # absent upstream; every non-output layer width must divide by it.
    # 1 = off.
    feat_shards: int = 1
    # Halo/compute overlap ("auto" | "on" | "off" | True | False): "auto"
    # (default) resolves per kernel in ShardedEngine — hyb gets the FUSED
    # overlap plan (ops/hyb_sharded.py edges="fused": one plan, pure
    # buckets gather local rows alongside the in-flight collective),
    # degree the interior/boundary plan pair, xla no split. Booleans
    # force on/off.
    overlap: object = "auto"
    # Halo wire format ("auto" | "padded" | "ragged"): padded ships max_h
    # rows per (shard, peer) pair (the only format XLA:CPU lowers);
    # ragged ships each pair's EXACT count via lax.ragged_all_to_all —
    # the reference's exact per-destination scatter (gcn_ops.cpp:204-260)
    # — into the same padded ghost layout; it raises where the collective
    # does not lower. auto = padded. See parallel/halo.py.
    halo: str = "auto"

    # Epochs per compiled call: between eval/checkpoint boundaries, run K
    # epochs inside ONE jitted lax.scan instead of K dispatches. Dispatch
    # is not free — ~85 ms/call on a 4-device CPU mesh (many sharded plan
    # arrays) — while the scanned body amortizes it to ~nothing. 0 = auto (group to
    # the next eval/checkpoint boundary); 1 = dispatch per epoch (the
    # reference's loop structure). Bounded staleness composes with
    # grouping: the weight-stash window rides the scan carry, so grouped
    # epochs see exactly the stale versions per-epoch dispatch would.
    epochs_per_call: int = 0

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # flip to bfloat16 for speed at scale
    # Gather aggregation tables in bfloat16 (f32 accumulation): half the
    # gathered bytes; relative error ~1e-3 on the aggregated output.
    # Applies to the slot kernels ("hyb", "degree").
    agg_dtype: str = "float32"  # "float32" | "bfloat16"

    # Aggregation kernel knobs
    kernel: str = "auto"  # "auto" (= "hyb", resolve_kernel)
    #                       | "xla" (segment_sum)
    #                       | "degree" (degree-padded blocked, ops/degree_spmm)
    #                       | "hyb" (hybrid ELL + chunked top, ops/hyb_spmm —
    #                         no big segment_sum)
    edge_chunk: int = 0  # SpMM edge-chunk size; 0 = unchunked
    optimize_order: bool = True  # transform-before-aggregate when it shrinks F
    # Pair reuse ("off" | "pairs"): mine common neighbor pairs into
    # appended gather-table rows (graph/reuse.py) — an EXACT rewrite for
    # both models (GCN rank-1 norms, GAT dst-only attention) that gathers
    # fewer rows. hyb kernel only (both single-shard and sharded,
    # ops/reuse_sharded.py). Off by default: mining costs seconds of host
    # time per million edges and no measurement yet shows the epochs that
    # repay it.
    reuse: str = "off"
    reuse_passes: int = 1  # hierarchy depth (pairs-of-pairs beyond 1)
    # Pair budget per mining pass: 0 = unlimited, >0 = explicit cap
    # (mine_reuse keeps the highest-count pairs).
    reuse_max_pairs: int = 0

    # Persistent XLA compile cache (common/cache.py): on by default, in
    # JAX_COMPILATION_CACHE_DIR or else the checkout's .jax_cache/.
    compile_cache: bool = True

    # Checkpointing (an improvement over the reference, which has none).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = disabled
    resume: bool = False

    seed: int = 8888  # reference weightserver.cpp:572 fixed RNG seed

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))


def resolve_kernel(kernel: str) -> str:
    """Resolve kernel="auto" to "hyb" (hybrid ELL: no big segment_sum;
    sharded hyb stacks per-shard plans under one shared-width bucket
    structure, ops/hyb_sharded.py), the kernel chip_smoke.py checks on one
    card and on four. A per-graph choice waits for benchmark cells on
    both sides of it."""
    return "hyb" if kernel == "auto" else kernel


@dataclass
class RunConfig:
    """Top-level run descriptor: dataset + model + training."""

    dataset: str = "cora"
    data_dir: Optional[str] = None
    layers: LayerConfig = field(default_factory=lambda: LayerConfig.preset("cora"))
    train: TrainConfig = field(default_factory=TrainConfig)
    output_file: Optional[str] = None  # mirrors tmpdir/output_<node>
