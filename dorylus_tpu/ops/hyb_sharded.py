"""Sharded hybrid-ELL SpMM: uniform per-shard hyb plans under one SPMD
program.

Same role as ops/degree_sharded.py but for the hyb kernel: each
vertex shard gets a build_hyb_plan pair (fwd over its dst-sorted edges,
bwd over the transpose), and shard_map requires every shard's plan to
share identical static shapes. Hyb plans have more shape freedom than
degree plans (bucket count, widths, per-bucket rows, hub rows), so
uniformity is built in three steps:

  1. bucket WIDTHS come from ONE cost-model DP over the concatenated
     per-shard degree distributions (build_hyb_plan(widths=...) keeps
     empty buckets so every shard emits the same bucket tuple);
  2. per-bucket row counts / hub rows / hub counts pad to the cross-shard
     max with dead rows (cnt 0, s2e sentinel, vals 0) — dead rows produce
     zero output rows that the inverse permutation never references;
  3. "inv" and "e2s" are REBUILT against the padded layout (concatenation
     offsets move when buckets pad).

Padding edges (graph/partition.py: tail-positioned, dst = vp-1, val 0)
are structurally dead here the same way as in degree_sharded: slot
liveness is recomputed from the pad structure (edge id < num real edges),
which stays a per-row prefix because pads stable-sort after the real
edges of their vertex — asserted at build time.

Reference parity: same aggregation semantics as
src/graph-server/engine/ops/gcn_ops.cpp:130-191 (weighted in-edge sums)
under the vertex-partitioned ghost-table layout of graph.hpp:87-98.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.graph.partition import ShardedGraph
from dorylus_tpu.ops.hyb_spmm import (_LAMBDA_SLOTS, _choose_widths,
                                      _hyb_pass, build_hyb_plan,
                                      hyb_spmm_apply, hyb_spmm_dst_apply,
                                      hyb_spmm_static_apply)


def _recount_live(part: dict, nreal: int) -> None:
    """Overwrite part["cnt"] with the REAL-edge prefix length per row
    (pads carry runtime val 0 in the per-edge path, but the mask mode of
    apply_dst derives weights from cnt — dead edges must be masked
    statically)."""
    live = part["s2e"] < nreal
    cnt = live.sum(axis=1).astype(np.int32)
    w = part["rows"].shape[1]
    assert (live == (np.arange(w)[None, :] < cnt[:, None])).all(), \
        "slot liveness must be a per-row prefix"
    part["cnt"] = cnt


def _pad_rows(part: dict, nrows: int, e: int) -> dict:
    """Pad one bucket/top part to nrows dead rows (zero contribution)."""
    r = part["rows"].shape[0]
    pad = nrows - r
    # ALWAYS copy, even when pad == 0: callers assign padded "v"/"rowv"
    # into the result, and returning the input dict would alias those
    # writes back into the source plan — _uniform_plans then reads the
    # PADDED hub list length when rebuilding inv and writes a dead hub
    # row into inv[num_out-1], silently zeroing that vertex's output
    # (hit whenever the shard with the max top chunk-row count has fewer
    # hubs than the cross-shard max; round-5 review).
    out = dict(part)
    if pad == 0:
        return out
    out["rows"] = np.pad(part["rows"], ((0, pad), (0, 0)))
    out["cnt"] = np.pad(part["cnt"], (0, pad))
    if "s2e" in part:  # absent on fused plans (dropped after recount)
        out["s2e"] = np.pad(part["s2e"], ((0, pad), (0, 0)),
                            constant_values=e)
    if "vals" in part:
        out["vals"] = np.pad(part["vals"], ((0, pad), (0, 0)))
    return out


def _uniform_plans(plans: list[dict], nreals: list[int], num_out: int,
                   ep: int, max_width: int) -> dict:
    """Pad per-shard hyb plans to one static shape and stack leaf-wise.

    Output rows concatenate as [bucket0 | bucket1 | ... | hubs | zero row]
    with PADDED sizes, so inv (vertex -> row) and e2s (edge -> flat slot)
    are rebuilt here against the padded offsets."""
    n_b = len(plans[0]["buckets"])
    assert all(len(p["buckets"]) == n_b for p in plans)
    has_top = any(p["top"] is not None for p in plans)
    bucket_rows = [max(p["buckets"][i]["rows"].shape[0] for p in plans)
                   for i in range(n_b)]
    top_rows = top_hubs = 0
    if has_top:
        top_rows = max(1, max(0 if p["top"] is None else
                              p["top"]["rows"].shape[0] for p in plans))
        top_hubs = max(1, max(0 if p["top"] is None else
                              len(p["top"]["v"]) for p in plans))

    stacked = []
    for p, nreal in zip(plans, nreals):
        if nreal is not None:  # None = caller already recounted (fused
            _recount_live_all(p, nreal)  # plans mix per-subset nreals)
        sp = {"buckets": [], "top": None}
        # Rebuild e2s: within-bucket layout is unchanged (row-major), so
        # each real slot index shifts by (padded offset - real offset) of
        # its bucket.
        real_off = [0]
        pad_off = [0]
        for i, b in enumerate(p["buckets"]):
            real_off.append(real_off[-1] + b["rows"].size)
            pad_off.append(pad_off[-1] + bucket_rows[i] * b["rows"].shape[1])
            nb = _pad_rows(b, bucket_rows[i], ep)
            nb["v"] = _pad_idx(b["v"], bucket_rows[i], num_out)
            sp["buckets"].append(nb)
        if has_top:
            t = p["top"]
            if t is None:
                proto = next(q["top"] for q in plans
                             if q["top"] is not None)
                t = {"rows": np.zeros((0, max_width), np.int32),
                     "cnt": np.zeros(0, np.int32),
                     "rowv": np.zeros(0, np.int32),
                     "rowv_global": np.zeros(0, np.int32),
                     "v": np.zeros(0, np.int32)}
                if "s2e" in proto:
                    t["s2e"] = np.full((0, max_width), ep, np.int32)
                if "vals" in proto:
                    t["vals"] = np.zeros((0, max_width), proto["vals"].dtype)
            nt = _pad_rows(t, top_rows, ep)
            # Pad chunk rows aim at the LAST hub segment (sorted invariant)
            # with zero values; pad hub slots are never referenced by inv.
            pad_r = top_rows - t["rows"].shape[0]
            n_hubs_real = len(t["v"])
            fill = max(0, min(n_hubs_real, top_hubs) - 1)
            nt["rowv"] = np.concatenate(
                [t["rowv"], np.full(pad_r, fill, np.int32)]).astype(np.int32)
            nt["rowv_global"] = _pad_idx(t["rowv_global"], top_rows, num_out)
            nt["v"] = _pad_idx(t["v"], top_hubs, num_out)
            sp["top"] = nt
            real_off.append(real_off[-1] + t["rows"].size)
            pad_off.append(pad_off[-1] + top_rows * max_width)
        # e2s remap: find each real slot's bucket by its real offset.
        # (absent on fused plans — merged subsets have no combined edge
        # order, and the fused path is dynamic=False by construction)
        if "e2s" in p:
            e2s = p["e2s"].astype(np.int64)
            seg = np.searchsorted(np.asarray(real_off[1:]), e2s,
                                  side="right")
            shift = (np.asarray(pad_off[:-1], np.int64)
                     - np.asarray(real_off[:-1], np.int64))
            sp["e2s"] = (e2s + shift[seg]).astype(np.int32)
        # inv rebuild against padded offsets; sentinel (all pad vertices,
        # isolated vertices) = total padded rows -> the appended zero row.
        nrow_total = sum(bucket_rows) + (top_hubs if has_top else 0)
        inv = np.full(num_out, nrow_total, np.int64)
        pos = 0
        for i in range(n_b):
            real_k = _real_rows(p, i)
            inv[p["buckets"][i]["v"][:real_k]] = np.arange(pos,
                                                           pos + real_k)
            pos += bucket_rows[i]
        if has_top and p["top"] is not None:
            k = len(p["top"]["v"])
            inv[p["top"]["v"][:k]] = np.arange(pos, pos + k)
        sp["inv"] = inv.astype(np.int32)
        stacked.append(sp)

    out = _stack_free(stacked)
    out["buckets"] = tuple(out["buckets"])
    return out


def _stack_free(items):
    """Leaf-wise np.stack that FREES each per-shard source right after
    copying — jax.tree.map(np.stack, *plans) holds plans twice at the
    peak, which is the difference between fitting and OOM at the 1B-edge
    32-shard build (tools/scale_pipeline.py)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_free([d.pop(k) for d in items])
                for k in list(first.keys())}
    if isinstance(first, (list, tuple)):
        out = []
        for j in range(len(first)):
            col = [seq[j] for seq in items]
            for seq in items:
                seq[j] = None  # release per-shard element after use
            out.append(_stack_free(col))
        return out
    if first is None:
        assert all(x is None for x in items)
        return None
    arr = np.empty((len(items),) + first.shape, first.dtype)
    for i in range(len(items)):
        arr[i] = items[i]
        items[i] = None
    return arr


def _real_rows(plan: dict, i: int) -> int:
    return plan["buckets"][i]["rows"].shape[0]


def _recount_live_all(plan: dict, nreal: int) -> None:
    for b in plan["buckets"]:
        _recount_live(b, nreal)
    if plan["top"] is not None:
        _recount_live(plan["top"], nreal)


def _pad_idx(v: np.ndarray, n: int, num_out: int) -> np.ndarray:
    """Pad an index vector with a harmless valid row (the sentinel row is
    only for inv; v is used as a gather index into vertex-sized arrays)."""
    return np.concatenate(
        [v, np.full(n - len(v), num_out - 1, v.dtype)]).astype(np.int32)


class ShardedHybSpMM:
    """Per-shard hyb plans with uniform shapes; arrays stacked on a
    leading shard axis (PartitionSpec('graph', ...)). Same protocol as
    ShardedDegreeSpMM: apply/apply_dst/apply_static run inside shard_map
    on this shard's squeezed arrays."""

    def __init__(self, sharded: ShardedGraph, max_width: int = 512,
                 gather_dtype=None, feature_dim: int = 128,
                 static_vals: bool = False, edges: str = "combined",
                 lam_slots: int = _LAMBDA_SLOTS, dynamic: bool = True):
        n = sharded.n_shards
        vp = sharded.vp
        self.fused = edges == "fused"
        self.n_pure = 0
        if self.fused:
            assert not dynamic, "fused overlap is dynamic=False only " \
                "(merged subsets have no combined edge order)"
            self._build_fused(sharded, max_width, gather_dtype,
                              static_vals, lam_slots)
            return
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

        # One width DP over the pooled per-shard degree spectra so every
        # shard shares a bucket structure (per-shard DPs would pick
        # different widths and shard_map could not stack the plans).
        deg_all = []
        per_shard = []
        for s in sharded.shards:
            src_a, dst_a, val_a, nreal = shard_edges(s)
            src = np.asarray(src_a)
            dst = np.asarray(dst_a)
            of = np.argsort(dst, kind="stable")
            ob = np.argsort(src, kind="stable")
            per_shard.append((src, dst, of, ob, np.asarray(val_a, np.float32),
                              nreal))
            for d, m in ((dst, vp), (src, table)):
                dg = np.bincount(d, minlength=m)
                dg = dg[(dg > 0) & (dg <= max_width)]
                deg_all.append(dg)
        deg_all = np.sort(np.concatenate(deg_all))
        widths = (_choose_widths(deg_all, lam_slots) if len(deg_all)
                  else [8])

        fwd_plans, bwd_plans, nreals = [], [], []
        for src, dst, of, ob, val, nreal in per_shard:
            # pad edges carry val 0, so plan-baked static values are
            # already inert on dead slots.
            svp = val if static_vals else None
            pf = build_hyb_plan(
                src[of], dst[of], of, vp, max_width, lam_slots,
                static_val=svp, widths=widths)
            pb = build_hyb_plan(
                dst[ob], src[ob], ob, table, max_width, lam_slots,
                static_val=svp, widths=widths)
            for p in (pf, pb):
                p.pop("n_slots")
                p.pop("_n_iso", None)  # uniform stacking always uses inv
                if not dynamic:
                    # Only the dynamic per-edge path reads the slot->edge
                    # maps at runtime (see HybSpMM dynamic=False): drop
                    # them BEFORE _uniform_plans, so the O(E) e2s remap
                    # and padded (n, R, w) s2e stacking never run — they
                    # were multiple GB of transient host memory at the
                    # 1B-edge 32-shard build (the fused builder's idiom;
                    # round-5 review). Liveness recounts here instead of
                    # inside _uniform_plans.
                    p.pop("e2s", None)
                    _recount_live_all(p, nreal)
                    for bkt in p["buckets"]:
                        bkt.pop("s2e", None)
                    if p["top"] is not None:
                        p["top"].pop("s2e", None)
            fwd_plans.append(pf)
            bwd_plans.append(pb)
            nreals.append(nreal if dynamic else None)

        self.has_static_vals = static_vals
        self.dynamic = dynamic
        self.arrays = {
            "fwd": _uniform_plans(fwd_plans, nreals, vp, ep, max_width),
            "bwd": _uniform_plans(bwd_plans, nreals, table, ep, max_width),
        }
        if gather_dtype is not None and np.dtype(gather_dtype).itemsize < 4:
            from dorylus_tpu.ops.hyb_spmm import _cast_vals
            for p in self.arrays.values():
                _cast_vals(p, np.dtype(gather_dtype))
        self.static = (table, vp,
                       None if gather_dtype is None
                       else np.dtype(gather_dtype), ep, None, None, 0)

    def _build_fused(self, sharded: ShardedGraph, max_width: int,
                     gather_dtype, static_vals: bool,
                     lam_slots: int) -> None:
        """The FUSED overlap plan (round 5, verdict Next #1): ONE forward
        plan whose per-width buckets come in a PURE group then a MIXED
        group. A vertex is pure when every in-edge source is local (and
        it is not a hub); pure-bucket rows gather from the local (vp, F)
        features directly — no data dependency on the halo collective —
        while mixed buckets (and the hub top) gather from the
        concatenated (local ‖ ghost) table. Against a two-plan split
        this keeps ONE inverse permutation, ONE output assembly and no
        (V, F) + (V, F) add; against the combined serial plan it exposes
        the pure gathers to XLA's scheduler alongside the in-flight
        all_to_all (pipeline.cpp:256-286 analog). Backward needs no
        fusion at all: the transpose plan gathers from the LOCAL gradient
        rows, so the combined bwd plan serves unchanged and its
        [0, vp) / [vp, table) output rows split into (dh, dghosts)."""
        from dorylus_tpu.ops.hyb_spmm import _cast_vals

        n, vp = sharded.n_shards, sharded.vp
        table = vp + n * sharded.max_h

        # Two passes over the shards, nothing E-sized retained across
        # them: pass 1 pools degree spectra for the shared width DP,
        # pass 2 (re)classifies and builds each shard's plans, dropping
        # the slot->edge maps the moment liveness is recounted — at the
        # 1B-edge 32-shard exercise (tools/scale_pipeline.py) holding
        # per-shard index arrays across the build was itself ~28 GB.
        # Pass 1: per-shard vertex classification + pooled degree
        # spectra. Cached per shard: only (vp,)-sized vectors (deg,
        # mixed_v) — a few hundred MB at 63M vertices vs the ~28 GB of
        # per-shard E-sized index arrays the first revision held.
        # Hubs (deg > max_width) are forced MIXED so the pure group
        # never owns a chunked top bucket (hubs near the cut would
        # straddle; few rows lose overlap, the plan stays single).
        deg_all = []
        cls_cache = []
        for s in sharded.shards:
            src = np.asarray(s.src)
            dst = np.asarray(s.dst)
            deg = np.bincount(dst, minlength=vp)
            ghost_dst = np.zeros(vp, bool)
            ghost_dst[dst[src >= vp]] = True
            mixed_v = ghost_dst | (deg > max_width)
            cls_cache.append(mixed_v)
            # Pure/mixed dst spectra straight from per-vertex degrees
            # (each vertex contributes its degree once); bwd from src.
            for dg in (deg[~mixed_v], deg[mixed_v],
                       np.bincount(src, minlength=table)):
                dg = dg[(dg > 0) & (dg <= max_width)]
                deg_all.append(dg)
            del src, dst, deg, ghost_dst
        deg_all = np.sort(np.concatenate(deg_all))
        widths = (_choose_widths(deg_all, lam_slots) if len(deg_all)
                  else [8])

        def drop_s2e(p):
            for bkt in p["buckets"]:
                bkt.pop("s2e", None)
            if p["top"] is not None:
                p["top"].pop("s2e", None)

        fwd_plans, bwd_plans = [], []
        for s, mixed_v in zip(sharded.shards, cls_cache):
            src = np.asarray(s.src)
            dst = np.asarray(s.dst)
            mixed_e = mixed_v[dst]
            val = np.asarray(s.edge_val, np.float32)
            nreal = s.num_edges
            parts = []
            for idx in (np.where(~mixed_e)[0], np.where(mixed_e)[0]):
                ssub, dsub, vsub = src[idx], dst[idx], val[idx]
                of = np.argsort(dsub, kind="stable")
                p = build_hyb_plan(
                    ssub[of], dsub[of], of, vp, max_width, lam_slots,
                    static_val=vsub if static_vals else None,
                    widths=widths)
                p.pop("n_slots")
                p.pop("_n_iso", None)
                p.pop("e2s", None)
                # Subset-scoped liveness BEFORE merging (pad edges sit at
                # each subset's tail — partition_graph tail-positions
                # them globally and subsets preserve relative order).
                _recount_live_all(p, int((idx < nreal).sum()))
                drop_s2e(p)
                del ssub, dsub, vsub, of, idx
                parts.append(p)
            p_pure, p_mix = parts
            assert p_pure["top"] is None, "hubs must be mixed"
            fwd_plans.append({
                "buckets": tuple(p_pure["buckets"]) + tuple(p_mix["buckets"]),
                "top": p_mix["top"],
            })
            ob = np.argsort(src, kind="stable")
            pb = build_hyb_plan(
                dst[ob], src[ob], ob, table, max_width, lam_slots,
                static_val=val if static_vals else None, widths=widths)
            del ob
            pb.pop("n_slots")
            pb.pop("_n_iso", None)
            pb.pop("e2s", None)
            _recount_live_all(pb, nreal)
            drop_s2e(pb)
            bwd_plans.append(pb)
            del src, dst, mixed_e, val

        ep = len(np.asarray(sharded.shards[0].src))
        nones = [None] * n  # pre-recounted above
        self.has_static_vals = static_vals
        self.dynamic = False
        self.n_pure = len(widths)
        self.arrays = {
            "fwd": _uniform_plans(fwd_plans, nones, vp, ep, max_width),
            "bwd": _uniform_plans(bwd_plans, nones, table, ep, max_width),
        }
        if gather_dtype is not None and np.dtype(gather_dtype).itemsize < 4:
            for p in self.arrays.values():
                _cast_vals(p, np.dtype(gather_dtype))
        for p in self.arrays.values():
            for b in p["buckets"]:
                b.pop("s2e", None)
            if p["top"] is not None:
                p["top"].pop("s2e", None)
        self.static = (table, vp,
                       None if gather_dtype is None
                       else np.dtype(gather_dtype), ep, None, None, 0)

    @property
    def _static_f(self):
        return self.static + (self.n_pure,)

    def apply_static_fused(self, arrays: dict, h, ghosts):
        return fused_static_apply(self._static_f, arrays, h, ghosts)

    def apply_dst_fused(self, arrays: dict, h, ghosts, dst_val):
        return fused_dst_apply(self._static_f, arrays, h, ghosts, dst_val)

    def apply_unit_fused(self, arrays: dict, h, ghosts):
        return fused_unit_apply(self._static_f, arrays, h, ghosts)

    def set_msgs_budget(self, budget: int) -> None:
        """Engine-scoped msgs scan-chunk guard (fit_msgs_budget)."""
        self.static = self.static[:6] + (int(budget),)

    def apply(self, arrays: dict, h, val):
        if not self.dynamic:
            raise RuntimeError(
                "op built with dynamic=False (slot->edge maps not "
                "shipped); rebuild with dynamic=True for per-edge values")
        return hyb_spmm_apply(self.static, arrays, h, val)

    def apply_dst(self, arrays: dict, h, dst_val):
        return hyb_spmm_dst_apply(self.static, arrays, h, dst_val)

    def apply_static(self, arrays: dict, h):
        return hyb_spmm_static_apply(self.static, arrays, h)


# ---------------------------------------------------------------------------
# Fused-overlap custom VJPs (edges="fused"): forward takes (h, ghosts)
# SEPARATELY so the pure buckets' gathers read h with no data dependency
# on the halo collective; backward is ONE pass over the combined
# transpose plan (its gather source is the LOCAL gradient — never the
# collective), whose [0, vp) / [vp, table) output rows are exactly
# (dh, dghosts). static_f = (table, vp, gather_dtype, ep, None, None,
# msgs_budget, n_pure).
# ---------------------------------------------------------------------------


def _zeros_d_arrs(arrs):
    return jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)


def _fused_fwd_pass(static_f, arrs, h, ghosts, mode):
    _, vp, gdt, _, _, _, bud, n_pure = static_f
    tb = jnp.concatenate([h, ghosts], axis=0)
    return _hyb_pass(tb, arrs["fwd"], vp, mode, None, gdt,
                     budget=bud, h_local=h, n_pure=n_pure)


def _fused_bwd_pass(static_f, arrs, gout, mode):
    table, vp, gdt, _, _, _, bud, _ = static_f
    dfull = _hyb_pass(gout, arrs["bwd"], table, mode, None, gdt, budget=bud)
    return dfull[:vp], dfull[vp:]


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def fused_static_apply(static_f, arrs, h, ghosts):
    """Plan-baked edge values (GCN norms), fused-overlap layout."""
    return _fused_fwd_pass(static_f, arrs, h, ghosts, "static")


def _fs_fwd(static_f, arrs, h, ghosts):
    return fused_static_apply(static_f, arrs, h, ghosts), (arrs, h, ghosts)


def _fs_bwd(static_f, res, gout):
    arrs, h, ghosts = res
    dh, dg = _fused_bwd_pass(static_f, arrs, gout, "static")
    return _zeros_d_arrs(arrs), dh.astype(h.dtype), dg.astype(ghosts.dtype)


fused_static_apply.defvjp(_fs_fwd, _fs_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def fused_unit_apply(static_f, arrs, h, ghosts):
    """Unit weights on live slots (the GAT regime-ordering entry)."""
    return _fused_fwd_pass(static_f, arrs, h, ghosts, "mask")


def _fu_fwd(static_f, arrs, h, ghosts):
    return fused_unit_apply(static_f, arrs, h, ghosts), (arrs, h, ghosts)


def _fu_bwd(static_f, res, gout):
    arrs, h, ghosts = res
    dh, dg = _fused_bwd_pass(static_f, arrs, gout, "mask")
    return _zeros_d_arrs(arrs), dh.astype(h.dtype), dg.astype(ghosts.dtype)


fused_unit_apply.defvjp(_fu_fwd, _fu_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def fused_dst_apply(static_f, arrs, h, ghosts, dst_val):
    """Edge weight = dst_val[dst e] (Dorylus GAT dst-only attention,
    forward_ops.cpp:109-141): unit-weight fused pass, row scaling."""
    u = _fused_fwd_pass(static_f, arrs, h, ghosts, "mask")
    return u * dst_val.astype(jnp.float32)[:, None]


def _fd_fwd(static_f, arrs, h, ghosts, dst_val):
    u = _fused_fwd_pass(static_f, arrs, h, ghosts, "mask")
    out = u * dst_val.astype(jnp.float32)[:, None]
    return out, (arrs, h, ghosts, dst_val, u)


def _fd_bwd(static_f, res, gout):
    arrs, h, ghosts, dst_val, u = res
    gscaled = gout.astype(jnp.float32) * dst_val.astype(jnp.float32)[:, None]
    dh, dg = _fused_bwd_pass(static_f, arrs, gscaled, "mask")
    d_dst = (u * gout.astype(jnp.float32)).sum(-1).astype(dst_val.dtype)
    return (_zeros_d_arrs(arrs), dh.astype(h.dtype),
            dg.astype(ghosts.dtype), d_dst)


fused_dst_apply.defvjp(_fd_fwd, _fd_bwd)
