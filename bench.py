"""Benchmark driver: prints ONE JSON line.

Metric: the warm full-graph training epoch of the Reddit configuration
(run/reddit.config, 602-128-41; GCN, f32 tables) on a Reddit-shaped graph
(|V| = 232,965, ~11.6M directed edges, ascending-degree renumbering)
through `Engine` with the default kernel. Extras: GCN with bf16 tables and
GAT (the reference's run-reddit-gat benchmark) with f32 and bf16 tables.
Engines group epochs into one compiled lax.scan call, so a warmup run
compiles every group shape and a second run measures warm; an epoch's time
is its group's host-clock time, which ends when the losses are read back.

Runs only on a GPU: the output records the device kind, the card count
and the card's power limit.
"""

from __future__ import annotations

import json

import numpy as np


def epoch_ms_warm(g, layers, cfg, epochs: int = 3) -> float:
    """Average warm epoch time: one run compiles every epoch-group shape,
    the second run measures."""
    from dorylus_tpu.engine.engine import Engine

    eng = Engine(g, layers, cfg)
    eng.run(epochs)
    rep = eng.run(epochs)
    return float(np.mean([e.time_ms for e in rep.epochs[-epochs:]]))


def main():
    from dorylus_tpu.common.device import device_record, require_gpu
    require_gpu()
    # Persistent compile cache: most of this script's cold wall time is
    # compiles.
    from dorylus_tpu.common.cache import enable_compile_cache
    enable_compile_cache()

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.graph.graph import random_graph
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    V = 232_965  # Reddit |V| (graph.bsnap)
    DEG = 50
    g = random_graph(V, DEG, 602, 41, seed=1)
    # Production preprocessing: ascending-degree renumbering makes the hyb
    # kernel's bucket layout the identity permutation (no output (V, F)
    # gather; cli.py --reorder degree-asc).
    g = apply_order(g, degree_order(g, ascending=True))

    layers = LayerConfig([602, 128, 41])
    epochs = {}
    for model in ("gcn", "gat"):
        for agg in ("float32", "bfloat16"):
            epochs[(model, agg)] = epoch_ms_warm(g, layers, TrainConfig(
                model=model, epochs=3, eval_every=0, agg_dtype=agg,
                learning_rate=0.005 if model == "gat" else 0.01))

    print(json.dumps({
        "metric": "gcn_reddit_config_epoch_ms",
        "value": epochs[("gcn", "float32")],
        "unit": "ms",
        "extras": {
            "device": device_record(),
            "num_vertices": V,
            "num_edges": g.num_edges,
            "kernel": "auto (hyb)",
            "gcn_reddit_config_epoch_bf16_ms": epochs[("gcn", "bfloat16")],
            "gat_reddit_config_epoch_ms": epochs[("gat", "float32")],
            "gat_reddit_config_epoch_bf16_ms": epochs[("gat", "bfloat16")],
        },
    }))


if __name__ == "__main__":
    main()
