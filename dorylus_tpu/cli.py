"""Command-line interface.

Mirrors the reference's operational surface:
  train        — the graph-server + weight-server run (run/run-onnode:154-181
                 flag set: --dataset --epochs --learning_rate --staleness ...)
  prepare-data — the inputs/prepare pipeline (text -> bsnap dataset dir)
  partition    — write a parts file (stand-in for inputs/partitioner METIS)
  bench        — kernel/epoch benchmark (analog of benchmarks/run-*)

Examples:
  python -m dorylus_tpu.cli train --dataset synthetic --model gcn --epochs 50
  python -m dorylus_tpu.cli train --data-dir data/cora --config cora --shards 4
  python -m dorylus_tpu.cli prepare-data --edges g.txt --features f.txt \
      --labels l.txt --out data/mygraph --feature-dim 128 --classes 7
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="synthetic",
                   help="synthetic | name of a preset config (cora/reddit/...)")
    p.add_argument("--data-dir", default=None,
                   help="directory with graph.bsnap/features.bsnap/labels.bsnap")
    p.add_argument("--config", default=None,
                   help="layer preset name or path to a *.config file")
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--target-acc", type=float, default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--feat-shards", type=int, default=1,
                   help="tensor parallelism: mesh 'feat' axis size — "
                        "column-sliced aggregation + psum'd layer "
                        "matmuls (must divide every layer width)")
    p.add_argument("--shards", type=int, default=1,
                   help="vertex shards over the device mesh (1 = single chip)")
    p.add_argument("--partition", default="range",
                   choices=["range", "hash", "metis", "ldg"],
                   help="vertex partitioner for --shards > 1 (ldg = native "
                        "streaming greedy, the METIS stand-in — use it on "
                        "real graphs to shrink halo traffic)")
    p.add_argument("--reorder", default="none",
                   choices=["none", "bfs", "degree", "degree-asc"],
                   help="relabel vertices before training (bfs = RCM-like "
                        "locality order; degree-asc = ascending in-degree, "
                        "which makes the hyb kernel's output permutation "
                        "the identity). bfs shrinks the RANGE partitioner's "
                        "edge-cut on locality-rich graphs")
    p.add_argument("--parts-file", default=None,
                   help="METIS-style parts file (with --partition metis)")
    p.add_argument("--edge-chunk", type=int, default=0)
    p.add_argument("--epochs-per-call", type=int, default=0,
                   help="epochs per compiled lax.scan group (0 = auto, "
                        "groups up to 25 to the next eval/checkpoint "
                        "boundary; 1 = dispatch per epoch)")
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "degree", "hyb"],
                   help="aggregation kernel (auto = hyb, hybrid ELL; "
                        "degree = degree-padded blocked; all three work "
                        "sharded)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--agg-bf16", action="store_true",
                   help="gather aggregation tables in bfloat16 (f32 "
                        "accumulation): half the gathered bytes at ~1e-3 "
                        "relative error (slot kernels: hyb and degree)")
    p.add_argument("--reuse", default="off", choices=["off", "pairs"],
                   help="pairs: mine common neighbor pairs into reusable "
                        "gather-table rows (exact; graph/reuse.py). "
                        "kernel=hyb, single-shard AND sharded "
                        "(ops/reuse_sharded.py)")
    p.add_argument("--reuse-passes", type=int, default=1,
                   help="pair-mining hierarchy depth (2 = pairs-of-pairs)")
    p.add_argument("--reuse-max-pairs", type=int, default=0,
                   help="pair budget per mining pass: 0 = unlimited, "
                        "N = keep the N highest-count pairs")
    p.add_argument("--halo", default="auto",
                   choices=["auto", "padded", "ragged"],
                   help="halo wire format: ragged = exact per-pair row "
                        "counts via lax.ragged_all_to_all (the reference's "
                        "exact scatter; raises where it does not lower), "
                        "padded = fixed max_h rows per pair (works "
                        "everywhere); auto = padded (parallel/halo.py)")
    p.add_argument("--overlap", default="auto",
                   choices=["auto", "on", "off"],
                   help="halo/compute overlap: auto (default) resolves "
                        "per kernel — hyb gets the FUSED plan, degree the "
                        "plan-pair split, xla none")
    p.add_argument("--no-overlap", action="store_true",
                   help=argparse.SUPPRESS)  # legacy alias for --overlap off
    p.add_argument("--compile-cache", default="on", choices=["on", "off"],
                   help="persistent XLA compile cache (in "
                        "$JAX_COMPILATION_CACHE_DIR when set, else the "
                        "checkout's .jax_cache/): compiles are paid once "
                        "per program shape per machine")
    p.add_argument("--staleness", type=int, default=None,
                   help="bounded-staleness async mode (pipeline.cpp:95-102): "
                        "gradients may be computed against weights up to N "
                        "epochs old; works on both engines. Omit for "
                        "synchronous training (the reference default).")
    p.add_argument("--switch-threshold", type=float, default=0.9,
                   help="async->sync switch point as a fraction of "
                        "--target-acc (weightserver.cpp:270-294)")
    p.add_argument("--lr-decay-every", type=int, default=0,
                   help="decay LR every N epochs (0=off, reference default; "
                        "weightserver.cpp:296-305)")
    p.add_argument("--lr-decay-factor", type=float, default=0.7)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--output", default=None, help="report file (output_<node>)")
    p.add_argument("--profile", action="store_true",
                   help="per-stage timing brackets in the report "
                        "(Aggregation/ApplyVertex/Scatter analog, "
                        "engine/utils.cpp:154-192)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="force a jax platform before the first op; cpu + "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                        "gives an N-device virtual mesh for --shards N")
    # synthetic graph knobs
    p.add_argument("--synth-vertices", type=int, default=10000)
    p.add_argument("--synth-degree", type=int, default=10)


def cmd_train(args) -> int:
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.common.logging import log

    cfg = TrainConfig(
        model=args.model, epochs=args.epochs, learning_rate=args.learning_rate,
        target_accuracy=args.target_acc, eval_every=args.eval_every,
        num_shards=args.shards, feat_shards=args.feat_shards,
        edge_chunk=args.edge_chunk,
        kernel=args.kernel, epochs_per_call=args.epochs_per_call,
        reuse=args.reuse, reuse_passes=args.reuse_passes,
        reuse_max_pairs=args.reuse_max_pairs,
        halo=args.halo,
        overlap="off" if args.no_overlap else args.overlap,
        compile_cache=args.compile_cache == "on",
        compute_dtype="bfloat16" if args.bf16 else "float32",
        agg_dtype="bfloat16" if args.agg_bf16 else "float32",
        staleness=args.staleness,
        switch_threshold=args.switch_threshold,
        lr_decay_every=args.lr_decay_every,
        lr_decay_factor=args.lr_decay_factor,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
    )
    if args.switch_threshold != 0.9 and args.target_acc is None:
        log("WARNING: --switch-threshold has no effect without --target-acc")

    # Layer config resolution: explicit file > preset name > dataset preset.
    if args.config and args.config in LayerConfig.PRESETS:
        layers = LayerConfig.preset(args.config)
    elif args.config:
        layers = LayerConfig.from_file(args.config)
    elif args.dataset in LayerConfig.PRESETS:
        layers = LayerConfig.preset(args.dataset)
    else:
        layers = None  # derive from data below

    if args.data_dir:
        from dorylus_tpu.graph.dataio import load_dataset
        g = load_dataset(args.data_dir,
                         feature_dim=layers.feature_dim if layers else None)
    else:
        from dorylus_tpu.graph.graph import synthetic_graph
        fdim = layers.feature_dim if layers else 32
        ncls = layers.num_classes if layers else 8
        g = synthetic_graph(args.synth_vertices, args.synth_degree, fdim, ncls,
                            seed=8888)
    if layers is None:
        layers = LayerConfig([g.features.shape[1], 64, g.num_classes])

    log("dataset: %d vertices, %d edges, %d classes; layers %s; model %s",
        g.num_vertices, g.num_edges, g.num_classes, layers.dims, cfg.model)

    order = None
    if args.reorder != "none":
        from dorylus_tpu.graph import reorder as _ro
        order = (_ro.bfs_order(g) if args.reorder == "bfs"
                 else _ro.degree_order(g,
                                       ascending=args.reorder == "degree-asc"))
        g = _ro.apply_order(g, order)
        log("reordered vertices (%s)", args.reorder)

    parts = None
    if args.parts_file:
        from dorylus_tpu.graph.dataio import read_parts_file
        parts = read_parts_file(args.parts_file)
        if order is not None:
            # The parts file was computed against ORIGINAL vertex ids;
            # after --reorder, partition_graph indexes parts by the NEW
            # ids — without this remap the METIS/LDG edge-cut the user
            # paid for silently became random placement (round-5 review).
            parts = parts[order]

    if args.shards > 1 or args.feat_shards > 1:
        from dorylus_tpu.parallel.train_step import ShardedEngine
        eng = ShardedEngine(g, layers, cfg, partition_method=args.partition,
                            parts=parts)
    else:
        from dorylus_tpu.engine.engine import Engine
        eng = Engine(g, layers, cfg)

    report = eng.run()
    # Surface which aggregation kernel the engine actually chose.
    log("aggregation kernel: %s", report.notes.get("kernel", cfg.kernel))
    if args.profile:
        # Per-stage brackets (halo / aggregate / forward / loss+grad) —
        # the reference's output_<node> per-stage report
        # (engine/utils.cpp:154-192); lands in the report's stage_times.
        times = eng.profile()
        for k, v in times.items():
            log("stage %-18s %8.2f ms", k, v)
    print(report.summary())
    if args.output:
        report.write(args.output)
        log("report written to %s", args.output)
    return 0


def cmd_infer(args) -> int:
    """Inference-only forward pass: load a checkpoint, dump per-vertex
    outputs (the role of the reference's dnnl-forward-gcn inference
    variant, src/funcs/dnnl-forward-gcn/forward.cpp, at CLI level; the
    output file is what miscs/compare_output.py-style diffing consumes)."""
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.common.logging import log
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.dataio import load_dataset

    layers = (LayerConfig.preset(args.config)
              if args.config in LayerConfig.PRESETS
              else LayerConfig.from_file(args.config))
    g = load_dataset(args.data_dir, feature_dim=layers.feature_dim)
    cfg = TrainConfig(model=args.model, kernel=args.kernel,
                      checkpoint_dir=args.checkpoint_dir, resume=True)
    eng = Engine(g, layers, cfg)
    if eng.start_epoch == 0:
        log("WARNING: no checkpoint found in %s — dumping predictions "
            "from the initial weights", args.checkpoint_dir)
    eng.dump_predictions(args.out, softmax=args.softmax)
    log("wrote %s (%d vertices)", args.out, g.num_vertices)
    return 0


def cmd_prepare(args) -> int:
    from dorylus_tpu.graph.dataio import prepare_from_text

    g = prepare_from_text(args.edges, args.features, args.labels, args.out,
                          feature_dim=args.feature_dim,
                          label_kinds=args.classes,
                          undirected=not args.directed)
    print(json.dumps({"vertices": g.num_vertices, "edges": g.num_edges,
                      "classes": g.num_classes, "out": args.out}))
    return 0


def cmd_partition(args) -> int:
    import numpy as np

    from dorylus_tpu.graph.dataio import read_graph_bsnap, write_parts_file
    from dorylus_tpu.graph.partition import assign_partitions
    from dorylus_tpu.graph.graph import Graph

    src, dst, num_v = read_graph_bsnap(args.graph)
    g = Graph(num_vertices=num_v, src=src, dst=dst,
              features=np.zeros((num_v, 1), np.float32),
              labels=np.zeros(num_v, np.int32), num_classes=1).finalize()
    parts = assign_partitions(g, args.n, method=args.method)
    write_parts_file(args.out or (args.graph + ".parts"), parts)
    return 0


def cmd_bench(args) -> int:
    import runpy
    from pathlib import Path

    # Resolve against the repo root, not the caller's CWD.
    bench = Path(__file__).resolve().parent.parent / "bench.py"
    if not bench.exists():
        print(f"bench.py not found at {bench}", file=sys.stderr)
        return 1
    sys.argv = [str(bench)]
    runpy.run_path(str(bench), run_name="__main__")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dorylus_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_train_args(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("prepare-data", help="text -> binary dataset dir")
    p.add_argument("--edges", required=True)
    p.add_argument("--features", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--feature-dim", type=int, required=True)
    p.add_argument("--classes", type=int, required=True)
    p.add_argument("--directed", action="store_true")
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("infer", help="forward pass from a checkpoint")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--config", required=True,
                   help="layer preset name or *.config path")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--model", default="gcn", choices=["gcn", "gat"])
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "xla", "degree", "hyb"])
    p.add_argument("--out", required=True, help="per-vertex output file")
    p.add_argument("--softmax", action="store_true",
                   help="write class probabilities instead of raw logits")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("partition", help="write a parts file")
    p.add_argument("--graph", required=True, help="graph.bsnap path")
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--method", default="range",
                   choices=["range", "hash", "ldg"])
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("bench", help="run the benchmark")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
