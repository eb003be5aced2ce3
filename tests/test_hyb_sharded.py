"""Sharded hyb kernel == single-device (which is oracle-tested in
test_hyb_spmm.py), across models, shard counts, and degree regimes.

The sharded wrapper's risks are structural: shared-DP bucket widths,
cross-shard dead-row padding, rebuilt inv/e2s offsets, pad-edge liveness
(graph/partition.py pads at the tail with val 0), and the hub/top bucket
under padding — each case here targets one of them.
"""

import jax
import numpy as np
import pytest

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import Engine
from dorylus_tpu.graph.graph import Graph, synthetic_graph
from dorylus_tpu.parallel import ShardedEngine, make_mesh


def _run_pair(g, layers, cfg, n_shards):
    rep1 = Engine(g, layers, cfg).run()
    rep2 = ShardedEngine(g, layers, cfg, mesh=make_mesh(n_shards)).run()
    return rep1, rep2


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_sharded_hyb_matches_single_device(model, lr):
    g = synthetic_graph(1000, 8, 32, 6, seed=42)
    cfg = TrainConfig(model=model, epochs=6, eval_every=3, kernel="hyb",
                      learning_rate=lr)
    rep1, rep2 = _run_pair(g, LayerConfig([32, 16, 6]), cfg, 4)
    for e1, e2 in zip(rep1.epochs, rep2.epochs):
        assert abs(e1.loss - e2.loss) <= 1e-3 * max(1.0, abs(e1.loss))
    assert rep1.final_accuracy == rep2.final_accuracy


def _hub_graph(v=640, hub_in=600, feature_dim=16, classes=4, seed=0):
    """One vertex receives > max_width(512) in-edges -> the sharded top
    bucket must pad across shards (only some shards own hub edges)."""
    rng = np.random.default_rng(seed)
    src_hub = rng.choice(v - 1, size=hub_in, replace=False) + 1
    dst_hub = np.zeros(hub_in, np.int64)
    e_rand = 4 * v
    src_r = rng.integers(0, v, e_rand)
    dst_r = rng.integers(0, v, e_rand)
    src = np.concatenate([src_hub, src_r]).astype(np.int32)
    dst = np.concatenate([dst_hub, dst_r]).astype(np.int32)
    g = Graph(num_vertices=v, src=src, dst=dst,
              features=rng.normal(0, 1, (v, feature_dim)).astype(np.float32),
              labels=rng.integers(0, classes, v).astype(np.int32),
              num_classes=classes)
    return g.finalize()


def test_sharded_hyb_hub_top_bucket():
    g = _hub_graph()
    cfg = TrainConfig(epochs=5, eval_every=0, kernel="hyb")
    rep1, rep2 = _run_pair(g, LayerConfig([16, 8, 4]), cfg, 4)
    for e1, e2 in zip(rep1.epochs, rep2.epochs):
        assert abs(e1.loss - e2.loss) <= 1e-3 * max(1.0, abs(e1.loss))


@pytest.mark.slow
def test_sharded_hyb_overlap_equals_combined():
    """Interior/boundary split plans == combined plan (the halo-overlap
    path must not change the math)."""
    g = synthetic_graph(800, 6, 24, 5, seed=9)
    reps = []
    for overlap in (True, False):
        cfg = TrainConfig(epochs=5, eval_every=0, kernel="hyb",
                          overlap=overlap)
        reps.append(ShardedEngine(g, LayerConfig([24, 12, 5]), cfg,
                                  mesh=make_mesh(4)).run())
    for e1, e2 in zip(reps[0].epochs, reps[1].epochs):
        assert abs(e1.loss - e2.loss) <= 1e-4 * max(1.0, abs(e1.loss))


def test_sharded_auto_resolves_to_hyb():
    """kernel="auto" is hyb for every model, table dtype and graph size;
    an explicit kernel is kept. Engine and ShardedEngine resolve alike."""
    from dorylus_tpu.common.config import resolve_kernel

    assert resolve_kernel("auto") == "hyb"
    for k in ("hyb", "degree", "xla"):
        assert resolve_kernel(k) == k
    g = synthetic_graph(200, 5, 12, 3, seed=4)
    for model in ("gcn", "gat"):
        for agg in ("float32", "bfloat16"):
            cfg = TrainConfig(model=model, epochs=1, eval_every=0,
                              agg_dtype=agg)
            eng = ShardedEngine(g, LayerConfig([12, 6, 3]), cfg,
                                mesh=make_mesh(2))
            assert eng.cfg.kernel == "hyb"
            assert Engine(g, LayerConfig([12, 6, 3]),
                          cfg).kernel_selected == "hyb"
    eng = ShardedEngine(g, LayerConfig([12, 6, 3]),
                        TrainConfig(epochs=1, eval_every=0, kernel="xla"),
                        mesh=make_mesh(2))
    assert eng.cfg.kernel == "xla"
