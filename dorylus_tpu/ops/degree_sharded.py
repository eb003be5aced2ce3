"""Sharded degree-padded SpMM: uniform per-shard plans under one SPMD program.

shard_map
compiles ONE program for all devices, so the per-shard degree plans
(ops/degree_spmm.py) must share identical static shapes. Degree plans only
have one shape degree of freedom — the block-row count R — so uniformity is
just padding every shard's plan to the cross-shard max R with dead rows
(slot_to_edge = ep sentinel -> val 0 -> zero contribution; block_row padded
with num_out-1 to keep the sorted-segment invariant).

All shards share the same edge count ep, table height (vp + n*max_h) and
output rows vp by construction (graph/partition.py), so val/sentinel and
the num_in/num_out statics are uniform for free.

Exposes the DegreeSpMM protocol (.arrays stacked on a leading
shard axis for PartitionSpec('graph', ...), .apply(arrays, h, val)), so
models use it unchanged via batch.aux["spmm"].
"""

from __future__ import annotations

import jax
import numpy as np

from dorylus_tpu.graph.partition import ShardedGraph
from dorylus_tpu.ops.degree_spmm import (build_degree_plan, degree_spmm_apply,
                                          degree_spmm_dst_apply,
                                          degree_spmm_static_apply)


def _stack_uniform(plans: list[dict], num_out: int, sentinel: int) -> dict:
    """Pad each plan's block rows to the cross-shard max and stack.

    Blocked-output maps (out_idx/out_loc, present when num_out is past
    out_block_rows is set) pad their data-dependent row dim to the
    cross-shard max with DEAD part rows (padded rows carry live_cnt 0 /
    zero vals, so gathering them adds zeros) aimed at the block's last
    output slot."""
    rmax = max(p["slot_src"].shape[0] for p in plans)
    keys = ["slot_src", "slot_to_edge", "block_row", "edge_to_slot",
            "live_cnt"]
    if "vals" in plans[0]:
        keys.append("vals")
    out = {k: [] for k in keys}
    for p in plans:
        pad = rmax - p["slot_src"].shape[0]
        out["slot_src"].append(np.pad(p["slot_src"], ((0, pad), (0, 0))))
        out["slot_to_edge"].append(
            np.pad(p["slot_to_edge"], ((0, pad), (0, 0)),
                   constant_values=sentinel))
        out["block_row"].append(
            np.pad(p["block_row"], (0, pad), constant_values=num_out - 1))
        # Row padding appends past the real rows, so flat slot indices in
        # the inverse map stay valid unchanged (uniform length = ep).
        out["edge_to_slot"].append(p["edge_to_slot"])
        out["live_cnt"].append(np.pad(p["live_cnt"], (0, pad)))
        if "out_idx" in p:
            rbm = max(q["out_idx"].shape[1] for q in plans)
            obr = p.pop("_out_block_rows")
            cpad = rbm - p["out_idx"].shape[1]
            out.setdefault("out_idx", []).append(np.pad(
                p["out_idx"], ((0, 0), (0, cpad)),
                constant_values=rmax))  # the runtime zero row
            out.setdefault("out_loc", []).append(np.pad(
                p["out_loc"], ((0, 0), (0, cpad)),
                constant_values=obr - 1))
        if "vals" in out:
            out["vals"].append(np.pad(p["vals"], ((0, pad), (0, 0))))
    return {k: np.stack(v) for k, v in out.items() if v}


class ShardedDegreeSpMM:
    """Per-shard degree plans with uniform R; arrays stacked on a leading
    shard axis. apply() is called inside shard_map with this shard's
    (squeezed) arrays."""

    def __init__(self, sharded: ShardedGraph, block: int = 16,
                 row_chunk: int = 0, gather_dtype=None,
                 feature_dim: int = 128, static_vals: bool = False,
                 edges: str = "combined",
                 out_block_rows: int = 0):
        """static_vals: bake each shard's edge values (GCN norms; pads 0)
        into the plans so apply_static() skips the runtime value gather.

        edges: which edge set the plans cover —
          "combined" : every shard edge; the input table is
                       [local h | ghost rows] (vp + n*max_h rows);
          "interior" : src-local edges only; table = local h (vp rows);
          "boundary" : ghost-sourced edges only; table = the received
                       ghost rows (n*max_h rows, src pre-rebased by
                       partition_graph).
        The interior/boundary pair is the halo-overlap path
        (pipeline.cpp:256-286 analog): the interior pass has no data
        dependency on the halo all_to_all, so XLA schedules them together."""
        n = sharded.n_shards
        vp = sharded.vp
        table = {"combined": vp + n * sharded.max_h,
                 "interior": vp,
                 "boundary": n * sharded.max_h}[edges]

        def shard_edges(s):
            if edges == "combined":
                return s.src, s.dst, s.edge_val, s.num_edges
            if edges == "interior":
                return s.src_int, s.dst_int, s.val_int, s.num_int
            return s.src_bnd, s.dst_bnd, s.val_bnd, s.num_edges - s.num_int

        ep = len(shard_edges(sharded.shards[0])[0])
        assert all(len(shard_edges(s)[0]) == ep for s in sharded.shards), \
            "shards must share a padded edge count"

        # Explicit output blocking of the final reduce applies to both
        # directions (the bwd plan reduces onto the vp + n*max_h table).
        fwd_obr = bwd_obr = out_block_rows

        fwd_plans, bwd_plans = [], []
        for s in sharded.shards:
            src_a, dst_a, val_a, nreal = shard_edges(s)
            src = np.asarray(src_a)
            dst = np.asarray(dst_a)
            # Shard edge arrays are dst-sorted for the REAL edges but carry
            # padding edges (val 0) at the tail pointing at vertex 0 —
            # re-sort and route runtime vals through edge_ids so pads land
            # in slots where their zero weight silences them.
            of = np.argsort(dst, kind="stable")
            fwd_plans.append(build_degree_plan(src[of], dst[of], of, vp,
                                               block,
                                               out_block_rows=fwd_obr))
            ob = np.argsort(src, kind="stable")
            bwd_plans.append(build_degree_plan(dst[ob], src[ob], ob,
                                               table, block,
                                               out_block_rows=bwd_obr))
            # Slot liveness for the dst-functional path (apply_dst):
            # padding EDGES carry runtime val 0 in the per-edge path, but
            # apply_dst derives weights from dst_val[dst] — so dead edges
            # must be masked statically. Liveness comes from the pad
            # STRUCTURE (partition_graph places the s.num_edges real edges
            # first, pads at the tail), not from edge_val != 0 — a real
            # edge whose value happens to be 0 must stay live. Pad edges
            # stable-sort AFTER the real edges of the same dst, so
            # row-liveness stays a prefix and compresses to the (R,) count
            # build_degree_plan carries (see _slot_live); the assert pins
            # that invariant against future edge orderings.
            live = np.arange(ep) < nreal
            live_ext = np.r_[live, False]
            ve = np.r_[np.asarray(val_a, np.float32), 0.0]
            for p in (fwd_plans[-1], bwd_plans[-1]):
                mask = live_ext[np.minimum(p["slot_to_edge"], ep)]
                cnt = mask.sum(axis=1).astype(np.int32)
                blk = p["slot_src"].shape[1]
                assert (mask == (np.arange(blk)[None, :]
                                 < cnt[:, None])).all(), \
                    "slot liveness must be a per-row prefix"
                p["live_cnt"] = cnt
                if static_vals:
                    p["vals"] = ve[p["slot_to_edge"]]
                    if (gather_dtype is not None
                            and np.dtype(gather_dtype).itemsize < 4):
                        # Narrow mode multiplies slot weights in the msgs
                        # dtype anyway — ship pre-cast and halve the
                        # (n, R, B) vals stack's memory (DegreeSpMM idiom).
                        p["vals"] = p["vals"].astype(gather_dtype)

        if row_chunk == 0:
            # OOM guard only (several times slower when active) — see DegreeSpMM.
            slots = block * max(
                max(p["slot_src"].shape[0] for p in fwd_plans),
                max(p["slot_src"].shape[0] for p in bwd_plans))
            itemsize = 4 if gather_dtype is None else np.dtype(gather_dtype).itemsize
            # Lane padding to 128 (see DegreeSpMM).
            if slots * max(feature_dim, 128) * itemsize > 8 << 30:
                row_chunk = 1 << 18

        self.has_static_vals = static_vals
        self.arrays = {
            "fwd": _stack_uniform(fwd_plans, vp, ep),
            "bwd": _stack_uniform(bwd_plans, table, ep),
        }
        self.static = (table, vp, row_chunk,
                       None if gather_dtype is None else np.dtype(gather_dtype),
                       fwd_obr, bwd_obr, ep)

    def apply(self, arrays: dict, h, val):
        return degree_spmm_apply(self.static, arrays, h, val)

    def apply_dst(self, arrays: dict, h, dst_val):
        """Edge weight = dst_val[dst[e]] with static slot liveness (pads
        dead); see degree_spmm_dst_apply."""
        return degree_spmm_dst_apply(self.static, arrays, h, dst_val)

    def apply_static(self, arrays: dict, h):
        """Construction-time edge values; see degree_spmm_static_apply."""
        return degree_spmm_static_apply(self.static, arrays, h)
