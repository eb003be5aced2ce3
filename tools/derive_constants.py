"""Measure on the GPU the tuning constants that steer the aggregation path.

    python tools/derive_constants.py [--only PROBE ...]   # one GPU
    # writes chiprun_out/constants.json

One probe per constant, timed with the host clock around
block_until_ready (median of 5 warm calls; forward + backward together):

  lam      ops/hyb_spmm._LAMBDA_SLOTS — the width DP's per-bucket cost in
           slot-equivalents. Sweeps it on a uniform and a Zipf(1.6)
           degree graph of the Reddit shape (bf16 tables, F = 128).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

V_REDDIT = 232_965
F = 128


def timed(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def fwd_bwd(apply, cot):
    """jit(value_and_grad) of <apply(arrs, x), cot>: one forward and one
    backward pass with a data-dependent cotangent."""
    import jax
    import jax.numpy as jnp

    return jax.jit(jax.value_and_grad(
        lambda x, arrs: jnp.vdot(apply(arrs, x), cot)))


def graph_from_edges(v, src, dst):
    from dorylus_tpu.graph.graph import Graph
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    g = Graph(num_vertices=v, src=src, dst=dst,
              features=np.zeros((v, 1), np.float32),
              labels=np.zeros(v, np.int32), num_classes=2).finalize()
    return apply_order(g, degree_order(g, ascending=True))


def uniform_graph(v, deg, seed=1):
    rng = np.random.default_rng(seed)
    e = v * deg
    return graph_from_edges(v, rng.integers(0, v, e).astype(np.int32),
                            rng.integers(0, v, e).astype(np.int32))


def zipf_graph(v, deg, seed=0):
    """In-degrees ~ Zipf(1.6) (clipped at 200k), scaled to v * deg edges."""
    rng = np.random.default_rng(seed)
    raw = np.minimum(rng.zipf(1.6, v).astype(np.int64), 200_000)
    d = (raw * (v * deg / raw.sum())).astype(np.int64)
    dst = np.repeat(np.arange(v, dtype=np.int32), d)
    src = rng.integers(0, v, len(dst)).astype(np.int32)
    return graph_from_edges(v, src, dst)


def probe_lam(out):
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.ops.hyb_spmm import HybSpMM

    rows = []
    for name, g in (("uniform", uniform_graph(V_REDDIT, 50)),
                    ("zipf1.6", zipf_graph(V_REDDIT, 50))):
        rng = np.random.default_rng(0)
        h = jnp.asarray(rng.normal(size=(g.num_vertices, F)), jnp.float32)
        cot = jnp.asarray(rng.normal(size=(g.num_vertices, F)), jnp.float32)
        for lam in (4096, 32768, 131072, 524288, 2097152):
            op = HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices,
                         gather_dtype=jnp.bfloat16, feature_dim=F,
                         static_val=g.edge_norm, lam_slots=lam,
                         dynamic=False)
            fwd = op.arrays["fwd"]
            parts = len(fwd["buckets"]) + (fwd["top"] is not None)
            ms = 1e3 * timed(fwd_bwd(op.apply_static, cot), h, op.arrays)
            rows.append({"graph": name, "E": g.num_edges, "lam": lam,
                         "fwd_parts": parts, "n_slots": op.n_slots,
                         "fwd_bwd_ms": ms})
            print("lam", rows[-1], flush=True)
            del op
            jax.clear_caches()
    out["lam"] = rows


PROBES = {"lam": probe_lam}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(PROBES),
                    default=sorted(PROBES), help="probes to run")
    args = ap.parse_args(argv)
    from dorylus_tpu.common.device import device_record, require_gpu

    require_gpu()
    out = {"device": device_record()}
    print("device", out["device"], flush=True)
    failed = []
    for name in args.only:
        fn = PROBES[name]
        t0 = time.perf_counter()
        try:
            fn(out)
        except Exception as e:  # noqa: BLE001 — keep the other probes
            import traceback
            traceback.print_exc()
            failed.append(name)
            out[name] = f"failed: {type(e).__name__}: {e}"
        print(f"probe {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "constants.json").write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
