"""Per-stage profiling + cost accounting.

The reference reports per-stage times (Aggregation / ApplyVertex / Scatter /
ApplyEdge, fwd+bwd per layer — engine/utils.cpp:139-291) and dollar cost
(calculate-price.py: lambda billed ms + EC2). Under XLA the stages are fused
into one program, so stage attribution here times separately-compiled
sub-programs (same math, unfused); the totals bracket the fused step. Cost
becomes chip-seconds, priced only when the caller gives an hourly price.

Timing methodology: N iterations inside one jit with a scalar carry and a
scalar readback.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp

from dorylus_tpu.models.base import GraphBatch
from dorylus_tpu.ops.spmm import aggregate

def _scalar_time(fn, *args, iters: int = 5) -> float:
    @jax.jit
    def loop(*args):
        def body(i, c):
            out = fn(*args, c)
            return jnp.asarray(out).ravel()[0].astype(jnp.float32)
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

    float(loop(*args))
    t0 = time.perf_counter()
    float(loop(*args))
    return (time.perf_counter() - t0) / iters


def profile_stages(model, params, batch: GraphBatch,
                   iters: int = 5) -> Dict[str, float]:
    """Stage timings in ms, mirroring the reference's per-layer
    Aggregation (fwd+bwd) / ApplyVertex table (engine/utils.cpp:139-212):
    aggregate_l*_ms + aggregate_l*_bwd_ms (the transposed-adjacency SpMM
    autodiff emits), dense_l*_ms (the ApplyVertex matmul), forward,
    loss+grad. Scatter (halo) only exists sharded — see
    profile_stages_sharded."""
    out: Dict[str, float] = {}

    # The agg brackets must time the kernel dispatch the MODEL uses, or
    # stage sums stop bracketing the fused step: GAT drives the
    # dst-functional path (apply_dst — no per-edge value arrays) at fout,
    # GCN with static norms drives apply_static at min(fin, fout).
    is_gat = type(model).__name__ == "GAT"
    spmm_op = getattr(model, "spmm_op", None)

    def _layer_agg_choice(fin, fout):
        """(width, mode) the model actually aggregates at."""
        if is_gat:
            return fout, "dst"
        tf = getattr(model, "optimize_order", True) and fin > fout
        width = fout if tf else fin
        if spmm_op is None:
            return width, "edgewise"
        return width, ("static" if getattr(spmm_op, "has_static_vals",
                                           False) else "dynamic")

    def _model_agg(arrays, table, batch, mode):
        if mode == "dst":
            # Data-dependent stand-in for leaky(z·a) — a (Vp,) column.
            return spmm_op.apply_dst(arrays, table, table[:, 0])
        if mode == "static":
            return spmm_op.apply_static(arrays, table)
        return spmm_op.apply(arrays, table, batch.edge_val)

    for l in range(model.layers.num_layers):
        w = params[f"w{l}"]
        fin, fout = w.shape
        f, mode = _layer_agg_choice(fin, fout)
        x = batch.x
        hh = (x[:, :f] if x.shape[1] >= f
              else jnp.pad(x, ((0, 0), (0, f - x.shape[1]))))
        hin = (x[:, :fin] if x.shape[1] >= fin
               else jnp.pad(x, ((0, 0), (0, fin - x.shape[1]))))
        last = l == model.layers.num_layers - 1

        def agg_fn(hh, batch, c, mode=mode):
            # Time the kernel the engine actually selected (slot-grid
            # when bound), not unconditionally the edgewise path.
            if spmm_op is not None:
                arrays = (batch.aux or {}).get("spmm", spmm_op.arrays)
                return _model_agg(arrays, hh + c * 1e-12, batch, mode)
            return aggregate(hh + c * 1e-12, batch.src, batch.dst,
                             batch.edge_val, batch.self_val, sorted_dst=True)

        def agg_bwd_fn(hh, batch, c, mode=mode):
            # Backward aggregate = SpMM over the transposed adjacency
            # (gcn_ops.cpp:130-153 dir BACKWARD).
            if spmm_op is not None:
                arrays = (batch.aux or {}).get("spmm", spmm_op.arrays)

                def loss(x):
                    o = _model_agg(arrays, x, batch, mode)
                    return (o * o).sum()

                return jax.grad(loss)(hh + c * 1e-12)
            return aggregate(hh + c * 1e-12, batch.dst, batch.src,
                             batch.edge_val, batch.self_val, sorted_dst=False)

        def dense_fn(hin, w, c, last=last):
            # The model's ACTUAL ApplyVertex shape: (V, fin) @ (fin, fout);
            # tanh only on GCN hidden layers (GAT has no activation).
            z = jnp.dot(hin + c * 1e-12, w,
                        preferred_element_type=jnp.float32)
            return z if (is_gat or last) else jnp.tanh(z)

        out[f"aggregate_l{l}_ms"] = 1e3 * _scalar_time(agg_fn, hh, batch,
                                                       iters=iters)
        out[f"aggregate_l{l}_bwd_ms"] = 1e3 * _scalar_time(
            agg_bwd_fn, hh, batch, iters=iters)
        out[f"dense_l{l}_ms"] = 1e3 * _scalar_time(dense_fn, hin, w,
                                                   iters=iters)

    def fwd_fn(params, batch, c):
        first = params[list(params.keys())[0]]
        p2 = dict(params)
        k0 = list(params.keys())[0]
        p2[k0] = first + c * 1e-12
        return model.forward(p2, batch)

    out["forward_ms"] = 1e3 * _scalar_time(fwd_fn, params, batch, iters=iters)

    def grad_fn(params, batch, c):
        k0 = list(params.keys())[0]
        p2 = dict(params)
        p2[k0] = params[k0] + c * 1e-12
        g = jax.grad(model.loss)(p2, batch)
        return g[k0]

    out["loss_and_grad_ms"] = 1e3 * _scalar_time(grad_fn, params, batch,
                                                 iters=iters)
    return out


def profile_stages_sharded(engine, iters: int = 5) -> Dict[str, float]:
    """Per-stage timing for a ShardedEngine: halo exchange (the Scatter
    stage of engine/utils.cpp:154-192), local aggregation, forward, and
    loss+grad — each a separately-jitted SPMD bracket over the engine's
    mesh. The aggregate bracket uses a locally-built stand-in ghost table
    (same shape, no collective) so the halo line isolates communication."""
    from functools import partial

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from dorylus_tpu.parallel.halo import halo_exchange, halo_recv
    from dorylus_tpu.parallel.mesh import GRAPH_AXIS
    from dorylus_tpu.parallel.train_step import _local_batch
    from dorylus_tpu.ops.spmm import spmm_edgewise

    mesh, model, cfg = engine.mesh, engine.model, engine.cfg
    denom = engine.sharded.denom
    multi = mesh.shape[GRAPH_AXIS] > 1
    out: Dict[str, float] = {}
    dims = model.layers.dims
    # Overlap runs ship ONLY the interior/boundary plan pair (the combined
    # plan would double plan memory for a path the models never take), so the
    # brackets must profile the split dispatch — which is also the kernel
    # production actually runs there. The hyb FUSED overlap plan (round 5)
    # ships as "spmm" but still needs the ghost-rows-only halo + split
    # batch semantics.
    fused = getattr(getattr(model, "spmm_split", None), "fused", False)
    use_split = (isinstance(engine.arrs, dict)
                 and "spmm_int" in engine.arrs) or fused

    def _sharded_scalar(fn):
        @partial(shard_map, mesh=mesh, in_specs=(P(), P(GRAPH_AXIS), P()),
                 out_specs=P(), check_vma=False)
        def wrapped(params, arrs, c):
            batch, halo_args = _local_batch(arrs, denom, overlap=use_split)
            val = fn(params, batch, halo_args, c)
            return jax.lax.psum(jnp.asarray(val).ravel()[0].astype(jnp.float32),
                                GRAPH_AXIS)
        return wrapped

    def _time(fn):
        wrapped = _sharded_scalar(fn)

        @jax.jit
        def loop(params, arrs):
            def body(i, c):
                return wrapped(params, arrs, c)
            return jax.lax.fori_loop(0, iters, body, jnp.float32(0))

        float(loop(engine.params, engine.arrs))
        t0 = time.perf_counter()
        float(loop(engine.params, engine.arrs))
        return 1e3 * (time.perf_counter() - t0) / iters

    for l in range(model.layers.num_layers):
        # Width actually exchanged/aggregated at layer l (GCN transform-first
        # when shrinking; GAT aggregates z at the output width).
        f = dims[l + 1] if cfg.model == "gat" else min(dims[l], dims[l + 1])

        def make_h(batch, c, f=f):
            x = batch.x
            h = (x[:, :f] if x.shape[1] >= f
                 else jnp.pad(x, ((0, 0), (0, f - x.shape[1]))))
            return h + c * 1e-12

        if multi:
            def halo_fn(params, batch, halo_args, c, make_h=make_h):
                return halo_recv(make_h(batch, c), halo_args[0])

            out[f"halo_l{l}_ms"] = _time(halo_fn)

        spmm_op = getattr(model, "spmm_op", None)
        spmm_split = getattr(model, "spmm_split", None)
        is_gat = cfg.model == "gat"

        def agg_fn(params, batch, halo_args, c, make_h=make_h):
            h = make_h(batch, c)
            send_idx = halo_args[0]
            # Stand-in ghost table with the real table's shape: rows
            # re-gathered locally (no collective) — times the SpMM alone,
            # with the kernel dispatch the MODEL drives (apply_dst for
            # GAT, apply_static for GCN static norms; interior+boundary
            # plan pair on the overlap path).
            ghosts = h[send_idx % h.shape[0]].reshape(-1, h.shape[1])
            if fused:
                aux = batch.aux or {}
                if is_gat:
                    return spmm_split.apply_dst_fused(aux["spmm"], h,
                                                      ghosts, h[:, 0])
                return spmm_split.apply_static_fused(aux["spmm"], h, ghosts)
            if use_split and spmm_split is not None:
                op_i, op_b = spmm_split
                aux = batch.aux or {}
                if is_gat:
                    return (op_i.apply_dst(aux["spmm_int"], h, h[:, 0])
                            + op_b.apply_dst(aux["spmm_bnd"], ghosts,
                                             h[:, 0]))
                if getattr(op_i, "has_static_vals", False):
                    return (op_i.apply_static(aux["spmm_int"], h)
                            + op_b.apply_static(aux["spmm_bnd"], ghosts))
                return (op_i.apply(aux["spmm_int"], h, batch.val_int)
                        + op_b.apply(aux["spmm_bnd"], ghosts, batch.val_bnd))
            table = jnp.concatenate([h, ghosts], axis=0)
            if spmm_op is not None:
                arrays = (batch.aux or {}).get("spmm", spmm_op.arrays)
                if is_gat and hasattr(spmm_op, "apply_dst"):
                    return spmm_op.apply_dst(arrays, table, h[:, 0])
                if getattr(spmm_op, "has_static_vals", False):
                    return spmm_op.apply_static(arrays, table)
                return spmm_op.apply(arrays, table, batch.edge_val)
            return spmm_edgewise(table, batch.src, batch.dst, batch.edge_val,
                                 h.shape[0], sorted_dst=True)

        out[f"aggregate_l{l}_ms"] = _time(agg_fn)

    def _halo(halo_args):
        # Split batches expect ghost-rows-only; combined batches expect
        # the full table — the SAME dispatch the train step uses
        # (parallel/halo.py make_halo_fn), so the profiler can never
        # measure a different halo path than training runs.
        from dorylus_tpu.parallel.halo import make_halo_fn
        return make_halo_fn(halo_args, use_split, multi)

    def fwd_fn(params, batch, halo_args, c):
        k0 = next(iter(params))
        p2 = dict(params)
        p2[k0] = params[k0] + c * 1e-12
        return model.forward(p2, batch, halo=_halo(halo_args))

    def grad_fn(params, batch, halo_args, c):
        k0 = next(iter(params))
        p2 = dict(params)
        p2[k0] = params[k0] + c * 1e-12
        g = jax.grad(lambda p: model.loss(p, batch,
                                          halo=_halo(halo_args)))(p2)
        return g[k0]

    out["forward_ms"] = _time(fwd_fn)
    out["loss_and_grad_ms"] = _time(grad_fn)
    return out


def report_cost(total_time_s: float, n_chips: int = 1,
                price_per_chip_hour: float | None = None) -> dict:
    """Chip-seconds, plus a dollar estimate when the caller passes a price
    per chip-hour (calculate-price.py analog)."""
    chip_s = total_time_s * n_chips
    out = {"chip_seconds": round(chip_s, 2)}
    if price_per_chip_hour is not None:
        out["price_per_chip_hour_usd"] = price_per_chip_hour
        out["estimated_cost_usd"] = round(
            chip_s / 3600.0 * price_per_chip_hour, 6)
    return out


def report_memory() -> dict | None:
    """Device-0 memory usage when the backend exposes it (GPUs do; the CPU
    returns nothing)."""
    import jax

    try:
        ms = jax.local_devices()[0].memory_stats()
    except Exception:
        return None
    if not ms:
        return None
    keep = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
            "largest_alloc_size")
    out = {k: int(ms[k]) for k in keep if k in ms}
    return out or None
