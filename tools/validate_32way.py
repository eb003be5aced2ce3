"""32-shard SPMD execution validation on the virtual CPU mesh.

The reference's widest cluster is 32 graph servers
(benchmarks/run-friendster-gcn:6). This runs the halo all_to_all block
permutation, the shared-DP hyb bucket plans, and the psum'd update at
that width on a virtual CPU mesh. This is
NOT a performance measurement (the host has 4 cores; 32 virtual devices
timeshare them): it validates that the 32-way program COMPILES and
EXECUTES, and that its loss trajectory matches single-device to 1e-3
(the sharded-parity bar used across tests/).

Run:
  env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=32 \
  python tools/validate_32way.py [--out benchmarks/results/sharded_32way.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--vertices", type=int, default=131_072)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() >= 32, (
        "need XLA_FLAGS=--xla_force_host_platform_device_count=32 in the "
        f"launching shell (have {jax.device_count()} devices)")

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import clustered_synthetic_graph
    from dorylus_tpu.parallel.mesh import make_mesh
    from dorylus_tpu.parallel.train_step import ShardedEngine

    g = clustered_synthetic_graph(args.vertices, args.degree, 32, 8,
                                  seed=7, cut=0.1)
    layers = LayerConfig([32, 16, 8])
    cfg = TrainConfig(epochs=args.epochs, eval_every=0, kernel="hyb",
                      reuse="off")

    single = Engine(g, layers, cfg).run()
    t0 = time.perf_counter()
    eng = ShardedEngine(g, layers, cfg, mesh=make_mesh(32),
                        partition_method="range")
    rep = eng.run()
    wall = time.perf_counter() - t0

    losses_1 = [e.loss for e in single.epochs]
    losses_32 = [e.loss for e in rep.epochs]
    max_dl = max(abs(a - b) for a, b in zip(losses_1, losses_32))
    result = {
        "what": "32-shard virtual-mesh execution validation (NOT perf: "
                "4-core host, 32 timeshared devices). Reference width: "
                "32 graph servers, run-friendster-gcn:6",
        "num_vertices": g.num_vertices,
        "num_edges": g.num_edges,
        "kernel": "hyb",
        "epochs": args.epochs,
        "loss_single": [round(x, 6) for x in losses_1],
        "loss_32way": [round(x, 6) for x in losses_32],
        "max_abs_loss_delta": round(max_dl, 8),
        "parity_ok": bool(max_dl < 1e-3),
        "wall_s_32way_incl_compile": round(wall, 1),
    }
    print(json.dumps(result, indent=1))
    assert result["parity_ok"], max_dl
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
