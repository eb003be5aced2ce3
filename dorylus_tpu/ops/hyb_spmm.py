"""Hybrid ELL SpMM — one slot row per vertex, degree-quantile bucket
widths, chunked top bucket for hubs.

Replaces the reference's per-vertex CSC aggregation loop
(src/graph-server/engine/ops/gcn_ops.cpp:130-191) like ops/degree_spmm.py,
but with a layout that removes the degree kernel's big sorted segment_sum:

  * vertices with deg <= max_width get exactly ONE slot row, whose width
    is the smallest bucket width >= their degree. The fixed-width
    gather -> mask/val multiply -> sum(axis=1) reduce then writes each
    vertex's output row DIRECTLY — no (R, F) part tensor, no segment_sum
    over ~E/block rows.
  * bucket widths (multiples of 8) are chosen by a tiny host-side DP that
    minimizes  pad slots + LAMBDA * n_buckets : each extra bucket is one
    more gather kernel with a fixed start-up cost, so the long tail of a
    power-law graph merges into few buckets while a tight (uniform)
    degree distribution splits into more.
  * hub vertices (deg > max_width) spill into a TOP bucket of
    max_width-wide chunk rows reduced by a short sorted segment_sum over
    hub rows only (~E_hub/max_width rows) — the cuSPARSE-HYB shape.
  * outputs are produced bucket-by-bucket in degree order and put back
    into vertex order by ONE inverse-permutation gather whose sentinel
    row also zeroes isolated vertices.

Backward: custom VJPs in the same three flavors as ops/degree_spmm.py
(dynamic per-edge values with fused SDDMM dval, dst-functional GAT
attention, static GCN norms), each one pass over a transposed-graph plan.
Plans MUST ride jit arguments (the batch pytree), never closures.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Per-bucket fixed cost in slot-equivalents for the width DP (one more
# bucket is one more gather kernel). Swept on an H100 (700 W) with
# tools/derive_constants.py at the Reddit shape, bf16 tables, fwd+bwd:
# 128k was best on a Zipf(1.6) degree graph (7.44 ms vs 7.83 at 512k and
# 7.84 at 4k) and within 0.1% of the best (32k) on a uniform one.
_LAMBDA_SLOTS = 128 * 1024
# Scan-chunk a bucket when its (Vb, w, F) message tensor would exceed
# this. Compile-OOM guard ONLY — chunking makes the pass several times
# slower when active. This is the fixed guard used off an accelerator;
# on a GPU the engines fit the guard to the device's memory
# (fit_msgs_budget). The module constant is never mutated: a fitted
# guard is ENGINE-scoped, carried in each op's `static` tuple
# (set_msgs_budget) so two engines of different scales in one process
# never share a stale guard.
_MSGS_CHUNK_BYTES = 8 << 30


def _choose_widths(deg_sorted: np.ndarray, lam: int) -> list[int]:
    """Bucket widths (multiples of 8) minimizing slots + lam*n_buckets
    over vertices with the given ascending degrees (all >= 1)."""
    wclass = ((deg_sorted + 7) // 8) * 8
    cands, counts = np.unique(wclass, return_counts=True)
    k = len(cands)
    prefix = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=prefix[1:])
    best = np.full(k + 1, np.iinfo(np.int64).max, np.int64)
    best[0] = 0
    back = np.zeros(k + 1, np.int32)
    for j in range(1, k + 1):
        for i in range(j):
            c = best[i] + cands[j - 1] * (prefix[j] - prefix[i]) + lam
            if c < best[j]:
                best[j] = c
                back[j] = i
    widths = []
    j = k
    while j > 0:
        widths.append(int(cands[j - 1]))
        j = int(back[j])
    return widths[::-1]


def _fill_rows(src, estart, verts, deg, width, edge_ids):
    """(len(verts), width) slot grid for one-row-per-vertex buckets:
    rows[i, :deg[v]] = src ids of v's edges, pads -> row 0 (killed by the
    mask/val weight). Also returns the original edge id per slot
    (sentinel E for pads) — liveness within a row is always a PREFIX."""
    cnt = deg[verts].astype(np.int32)
    tot = int(cnt.sum())
    rstart = np.zeros(len(verts) + 1, np.int64)
    np.cumsum(cnt, out=rstart[1:])
    ridx = np.repeat(np.arange(len(verts)), cnt)
    cidx = np.arange(tot) - rstart[ridx]
    eidx = estart[verts][ridx] + cidx
    rows = np.zeros((len(verts), width), np.int32)
    rows[ridx, cidx] = src[eidx]
    s2e = np.full((len(verts), width), len(src), np.int64)
    s2e[ridx, cidx] = edge_ids[eidx]
    return rows, cnt, s2e, (ridx, cidx, eidx)


def build_hyb_plan(src: np.ndarray, dst: np.ndarray,
                   edge_ids: np.ndarray | None, num_out: int,
                   max_width: int = 512,
                   lam_slots: int = _LAMBDA_SLOTS,
                   static_val: np.ndarray | None = None,
                   widths: list[int] | None = None) -> dict:
    """Host-side plan. Requires dst ascending (CSC order). edge_ids maps
    this edge order to original edge ids (identity for the forward plan,
    the transpose permutation for the backward plan).

    widths: fixed bucket widths instead of the DP, KEEPING empty buckets —
    the sharded wrapper (ops/hyb_sharded.py) needs every shard's plan to
    share one bucket structure under a single SPMD program."""
    e = len(src)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if edge_ids is None:
        edge_ids = np.arange(e, dtype=np.int64)
    deg = np.bincount(dst, minlength=num_out)
    estart = np.zeros(num_out + 1, np.int64)
    np.cumsum(deg, out=estart[1:])
    order = np.argsort(deg, kind="stable")
    deg_s = deg[order]
    first = int(np.searchsorted(deg_s, 1))  # skip isolated vertices
    active, deg_a = order[first:], deg_s[first:]
    hub_lo = int(np.searchsorted(deg_a, max_width, side="right"))
    normal, hubs = active[:hub_lo], active[hub_lo:]
    deg_n = deg_a[:hub_lo]
    sv = None
    if static_val is not None:
        sv = np.asarray(static_val, np.float32)

    buckets = []
    slot_off = 0
    e2s = np.zeros(max(1, e), np.int64)
    lo = 0
    keep_empty = widths is not None
    if widths is None:
        widths = _choose_widths(deg_n, lam_slots) if len(deg_n) else []
    for w in widths:
        hi = int(np.searchsorted(deg_n, w, side="right"))
        verts = normal[lo:hi]
        lo = hi
        if len(verts) == 0 and not keep_empty:
            continue
        rows, cnt, s2e, (ridx, cidx, eidx) = _fill_rows(
            src, estart, verts, deg, w, edge_ids)
        b = {"rows": rows, "cnt": cnt, "v": verts.astype(np.int32),
             "s2e": s2e.astype(np.int32)}
        if sv is not None:
            vals = np.zeros(rows.shape, np.float32)
            vals[ridx, cidx] = sv[edge_ids[eidx]]
            b["vals"] = vals
        e2s[edge_ids[eidx]] = slot_off + ridx * w + cidx
        slot_off += rows.size
        buckets.append(b)
    # Explicit widths must cover every non-hub degree — an uncovered
    # vertex would silently aggregate to zero (sentinel inv row) and leak
    # slot-0 garbage through e2s gradients.
    assert lo == len(normal), \
        f"widths {widths} cover degrees <= {widths[-1] if widths else 0}, " \
        f"but {len(normal) - lo} vertices have higher (non-hub) degree"

    top = None
    if len(hubs):
        nrow = -(-deg[hubs] // max_width)
        rt = int(nrow.sum())
        rows = np.zeros((rt, max_width), np.int32)
        s2e = np.full((rt, max_width), e, np.int64)
        cnt = np.full(rt, max_width, np.int32)
        rowv = np.repeat(np.arange(len(hubs), dtype=np.int32), nrow)
        rowv_global = hubs[rowv].astype(np.int32)
        # Per-hub fill loop (hub count is small by construction: only
        # vertices with deg > max_width land here).
        r0 = 0
        vals = np.zeros((rt, max_width), np.float32) if sv is not None else None
        for i, vtx in enumerate(hubs):
            d = int(deg[vtx])
            ed = np.arange(estart[vtx], estart[vtx] + d)
            nr = -(-d // max_width)
            pad = nr * max_width - d
            rows[r0:r0 + nr] = np.pad(src[ed], (0, pad)).reshape(nr, max_width)
            se = np.pad(edge_ids[ed], (0, pad), constant_values=e)
            s2e[r0:r0 + nr] = se.reshape(nr, max_width)
            if d % max_width:
                cnt[r0 + nr - 1] = d % max_width
            if sv is not None:
                vals[r0:r0 + nr] = np.pad(
                    sv[edge_ids[ed]], (0, pad)).reshape(nr, max_width)
            flat = slot_off + r0 * max_width + np.arange(d)
            e2s[edge_ids[ed]] = flat
            r0 += nr
        top = {"rows": rows, "cnt": cnt, "rowv": rowv,
               "rowv_global": rowv_global, "v": hubs.astype(np.int32),
               "s2e": s2e.astype(np.int32)}
        if sv is not None:
            top["vals"] = vals
        slot_off += rows.size

    # Output layout: [buckets..., hubs, zero row]; inv: vertex -> position.
    # When vertices are ALREADY numbered by ascending degree (the
    # degree-sort preprocessing, graph/reorder.py degree_order
    # ascending=True), the stable degree argsort is the identity, bucket
    # outputs land in vertex order, and the inverse-permutation gather
    # collapses to a zero-row prefix for the isolated vertices — plan
    # carries "_n_iso" instead of "inv" (saves a (V, F) gather per pass;
    # undirected graphs get it on BOTH plans since in-deg == out-deg).
    plan = {"buckets": tuple(buckets), "top": top,
            "e2s": e2s.astype(np.int32), "n_slots": slot_off}
    if np.array_equal(order, np.arange(num_out)):
        plan["_n_iso"] = first
    else:
        n_active = sum(len(b["v"]) for b in buckets) + (len(hubs) if top else 0)
        inv = np.full(num_out, n_active, np.int64)
        pos = 0
        for b in buckets:
            inv[b["v"]] = np.arange(pos, pos + len(b["v"]))
            pos += len(b["v"])
        if top is not None:
            inv[top["v"]] = np.arange(pos, pos + len(top["v"]))
        plan["inv"] = inv.astype(np.int32)
    return plan


def tree_nbytes(tree) -> int:
    """Device bytes of a pytree's array leaves: the logical size. The GPU
    stores arrays densely, with no tile padding to model."""
    return sum(int(a.size) * np.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(tree) if getattr(a, "shape", ()))


def fit_msgs_budget(static_bytes: int, transient_bytes: int = 0,
                    log_fn=None) -> int:
    """Size the msgs scan-chunk guard to the device memory the program
    has left: guard = bytes_limit - static - transients - 2 GB slack
    (at least 1 GB). The guard is a compile-OOM guard, never a perf
    feature. Off an accelerator the fixed _MSGS_CHUNK_BYTES applies. An
    accelerator that reports no `bytes_limit` is an error: no device
    memory size is assumed. PURE: returns the chosen guard — callers
    scope it to their ops via set_msgs_budget (no module-global
    mutation)."""
    dev = jax.local_devices()[0]
    if dev.platform == "cpu":
        return _MSGS_CHUNK_BYTES
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{dev.device_kind} reports no bytes_limit in memory_stats(); "
            "cannot size the msgs chunk guard")
    budget = limit - static_bytes - transient_bytes - (2 << 30)
    guard = max(1 << 30, budget)
    if log_fn is not None:
        log_fn("msgs chunk guard %.2f GB (static %.2f GB + transients "
               "%.2f GB of %.2f GB device memory)",
               guard / 2**30, static_bytes / 2**30,
               transient_bytes / 2**30, limit / 2**30)
    return guard


def _cast_vals(plan: dict, dtype) -> None:
    """Pre-cast baked static values to the narrow msgs dtype (in place,
    host side) — see HybSpMM.__init__."""
    for b in plan["buckets"]:
        if "vals" in b:
            b["vals"] = b["vals"].astype(dtype)
    if plan.get("top") is not None and "vals" in plan["top"]:
        plan["top"]["vals"] = plan["top"]["vals"].astype(dtype)


def _weights(part, mode, msgs_dtype, val_ext):
    """(rows, w) slot weights for one bucket in the msgs dtype."""
    rows = part["rows"]
    if mode == "static":
        return part["vals"].astype(msgs_dtype)
    if mode == "mask":
        w = rows.shape[1]
        return (jax.lax.iota(jnp.int32, w)[None, :]
                < part["cnt"][:, None]).astype(msgs_dtype)
    return val_ext[part["s2e"]].astype(msgs_dtype)  # dynamic


def _reduce_part(tb, part, mode, val_ext, narrow, other_rows, budget):
    """gather -> weight multiply -> sum(axis=1) for one bucket/top part.
    Returns (out (rows, F) f32, dv (rows, w) f32 | None). Scan-chunks the
    row dim when the message tensor would exceed `budget` bytes (the
    engine-scoped msgs guard; _MSGS_CHUNK_BYTES is only its default)."""
    rows = part["rows"]
    nb, w = rows.shape
    f = tb.shape[1]
    itemsize = 2 if narrow else 4
    per_slot = w * f  # logical elements per slot row of (chunk, w, F)
    chunk = 0
    if nb * per_slot * itemsize > budget:
        chunk = max(8, (budget // (per_slot * itemsize))
                    // 8 * 8)

    def reduce_rows(s, wt, hb):
        msgs = tb[s]
        if not narrow:
            msgs = msgs.astype(jnp.float32)
        prod = msgs * wt[..., None]
        out = prod.sum(axis=1, dtype=jnp.float32)
        dv = None
        if hb is not None:
            dv = (msgs * hb[:, None, :].astype(msgs.dtype)).sum(
                -1, dtype=jnp.float32)
        return out, dv

    wt_full = _weights(part, mode, tb.dtype if narrow else jnp.float32,
                       val_ext)
    if chunk and nb > chunk:
        # Scan over chunk indices with dynamic_slice — NOT over stacked
        # (n, chunk, w) copies of the slot grids, which would double the
        # plan memory as HLO temps. One padded copy of each operand
        # remains.
        n = -(-nb // chunk)
        pad = n * chunk - nb
        ops = [jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
               for x in ((rows, wt_full)
                         + (() if other_rows is None else (other_rows,)))]

        def body(_, i):
            ch = [jax.lax.dynamic_slice_in_dim(x, i * chunk, chunk)
                  for x in ops]
            return None, reduce_rows(ch[0], ch[1],
                                     ch[2] if len(ch) > 2 else None)

        _, (outs, dvs) = jax.lax.scan(body, None,
                                      jnp.arange(n, dtype=jnp.int32))
        out = outs.reshape(n * chunk, -1)[:nb]
        dv = None if dvs is None else dvs.reshape(n * chunk, -1)[:nb]
        return out, dv
    return reduce_rows(rows, wt_full, other_rows)


def _hyb_pass(h_table, plan, num_out, mode, val=None, gather_dtype=None,
              other=None, n_iso=None, budget=0, h_local=None, n_pure=0):
    """out[v] = sum_{e: dst e = v} weight(e) * h_table[src e] over a
    build_hyb_plan layout. mode: "static" (plan-baked values), "mask"
    (unit weights on live slots), "dynamic" (per-edge val).

    h_local / n_pure (the FUSED overlap plan, ops/hyb_sharded.py
    edges="fused"): the first n_pure buckets hold rows whose slots all
    index [0, len(h_local)) and gather from h_local directly — on a
    sharded mesh h_table is concat(local, ghosts) and depends on the halo
    collective, while h_local does not, so XLA schedules the pure-bucket
    gathers alongside the in-flight all_to_all (the reference's
    compute/scatter overlap, pipeline.cpp:256-286) without a second plan,
    second inverse permutation, or output add.

    n_iso (static int): the identity-permutation fast path for
    degree-sorted graphs — bucket outputs are already in vertex order
    after n_iso isolated (zero) rows, so no "inv" gather runs.

    With `other`, also returns dval[e] = <h_table[slot of e],
    other[row-vertex of e]> in original edge order (fused SDDMM backward):
    the dv slot grids are raveled in global slot order and pulled back
    through plan["e2s"]."""
    # budget 0 = the module default, read at call time (tests monkeypatch
    # it); engines pass their capacity-fitted guard through `static`.
    budget = budget or _MSGS_CHUNK_BYTES
    narrow = gather_dtype is not None and jnp.dtype(gather_dtype).itemsize < 4
    tb = h_table if gather_dtype is None else h_table.astype(gather_dtype)
    tb_local = None
    if h_local is not None:
        tb_local = (h_local if gather_dtype is None
                    else h_local.astype(gather_dtype))
    val_ext = None
    if mode == "dynamic":
        val_ext = jnp.concatenate([val.astype(jnp.float32),
                                   jnp.zeros((1,), jnp.float32)])
    outs, dvs = [], []
    for bi, b in enumerate(plan["buckets"]):
        orows = None if other is None else other[b["v"]]
        src_tb = tb_local if bi < n_pure else tb
        out, dv = _reduce_part(src_tb, b, mode, val_ext, narrow, orows,
                               budget)
        outs.append(out)
        dvs.append(dv)
    top = plan["top"]
    if top is not None:
        orows = None if other is None else other[top["rowv_global"]]
        part, dv = _reduce_part(tb, top, mode, val_ext, narrow, orows,
                                budget)
        n_hubs = top["v"].shape[0]
        outs.append(jax.ops.segment_sum(part, top["rowv"],
                                        num_segments=n_hubs,
                                        indices_are_sorted=True))
        dvs.append(dv)
    f = h_table.shape[1]
    if n_iso is not None:
        pieces = ([jnp.zeros((n_iso, f), jnp.float32)] if n_iso else []) + outs
        out = (jnp.concatenate(pieces) if pieces
               else jnp.zeros((num_out, f), jnp.float32))
    else:
        cat = jnp.concatenate(outs + [jnp.zeros((1, f), jnp.float32)])
        out = cat[plan["inv"]]
    if other is None:
        return out
    if not dvs:
        return out, jnp.zeros((0,), jnp.float32)
    flat = jnp.concatenate([d.ravel() for d in dvs])
    dval = flat[plan["e2s"]]
    return out, dval


# ---- custom-VJP wrappers ----
# static = (num_in, num_out, gather_dtype, E, n_iso_fwd, n_iso_bwd
#           [, msgs_budget]) — the n_iso pair are the identity-permutation
# markers (None = use plan["inv"]); msgs_budget is the engine-scoped
# scan-chunk guard (absent/0 = the module default).


def _unpack(static):
    ni, nb = static[4], static[5]
    bud = static[6] if len(static) > 6 else 0
    return static[0], static[1], static[2], ni, nb, bud


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def hyb_spmm_apply(static, arrs, h, val):
    """Dynamic per-edge values, differentiable in h and val."""
    _, num_out, gdt, ni, _, bud = _unpack(static)
    return _hyb_pass(h, arrs["fwd"], num_out, "dynamic", val, gdt, n_iso=ni,
                     budget=bud)


def _apply_fwd(static, arrs, h, val):
    return hyb_spmm_apply(static, arrs, h, val), (arrs, h, val)


def _apply_bwd(static, res, gout):
    arrs, h, val = res
    num_in, _, gdt, _, nib, bud = _unpack(static)
    # One pass over the transposed plan: slots gather gout[dst e] for dh;
    # dval[e] = <h[src e], gout[dst e]> reuses the gathered messages
    # against h[row vertex] (fused SDDMM) — exactly the degree kernel's
    # backward shape (gat_ops.cpp:222-241 computes its attention backward
    # in one fused sweep too).
    dh_full, dval = _hyb_pass(gout, arrs["bwd"], num_in, "dynamic", val, gdt,
                              other=h, n_iso=nib, budget=bud)
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh, dval[: val.shape[0]].astype(val.dtype)


hyb_spmm_apply.defvjp(_apply_fwd, _apply_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def hyb_spmm_dst_apply(static, arrs, h, dst_val):
    """Edge weight = dst_val[dst e] (Dorylus GAT attention,
    funcs/gat/ops/forward_ops.cpp:109-141): the weight factors out of each
    destination's sum, so the kernel runs unit-weight (mask) passes and
    scales rows at vertex granularity — no per-edge value arrays."""
    _, num_out, gdt, ni, _, bud = _unpack(static)
    u = _hyb_pass(h, arrs["fwd"], num_out, "mask", None, gdt, n_iso=ni,
                  budget=bud)
    return u * dst_val.astype(jnp.float32)[:, None]


def _dst_fwd(static, arrs, h, dst_val):
    _, num_out, gdt, ni, _, bud = _unpack(static)
    u = _hyb_pass(h, arrs["fwd"], num_out, "mask", None, gdt, n_iso=ni,
                  budget=bud)
    out = u * dst_val.astype(jnp.float32)[:, None]
    return out, (arrs, dst_val, u, h)


def _dst_bwd(static, res, gout):
    arrs, dst_val, u, h = res
    num_in, _, gdt, _, nib, bud = _unpack(static)
    gscaled = gout.astype(jnp.float32) * dst_val.astype(jnp.float32)[:, None]
    dh_full = _hyb_pass(gscaled, arrs["bwd"], num_in, "mask", None, gdt,
                        n_iso=nib, budget=bud)
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_dst = (u * gout.astype(jnp.float32)).sum(-1).astype(dst_val.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh, d_dst


hyb_spmm_dst_apply.defvjp(_dst_fwd, _dst_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def hyb_spmm_unit_apply(static, arrs, h):
    """Unit edge weights: out[v] = sum_{u->v} h[u]. The regime-aware GAT
    ordering (models/gat.py) aggregates h unweighted; this entry point
    skips the (V, F) ones-multiply forward and the O(V·F) attention
    row-dot backward that apply_dst with a ones vector would build and
    leave for DCE."""
    _, num_out, gdt, ni, _, bud = _unpack(static)
    return _hyb_pass(h, arrs["fwd"], num_out, "mask", None, gdt, n_iso=ni,
                     budget=bud)


def _unit_fwd(static, arrs, h):
    return hyb_spmm_unit_apply(static, arrs, h), (arrs, h)


def _unit_bwd(static, res, gout):
    arrs, h = res
    num_in, _, gdt, _, nib, bud = _unpack(static)
    dh_full = _hyb_pass(gout, arrs["bwd"], num_in, "mask", None, gdt,
                        n_iso=nib, budget=bud)
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh


hyb_spmm_unit_apply.defvjp(_unit_fwd, _unit_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def hyb_spmm_static_apply(static, arrs, h):
    """Construction-time edge values (GCN norms) baked into the plans —
    no runtime value gather."""
    _, num_out, gdt, ni, _, bud = _unpack(static)
    return _hyb_pass(h, arrs["fwd"], num_out, "static", None, gdt, n_iso=ni,
                     budget=bud)


def _static_fwd(static, arrs, h):
    return hyb_spmm_static_apply(static, arrs, h), (arrs, h)


def _static_bwd(static, res, gout):
    arrs, h = res
    num_in, _, gdt, _, nib, bud = _unpack(static)
    dh_full = _hyb_pass(gout, arrs["bwd"], num_in, "static", None, gdt,
                        n_iso=nib, budget=bud)
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh


hyb_spmm_static_apply.defvjp(_static_fwd, _static_bwd)


def spmm_hyb(h_table, plan, num_out, gather_dtype=None, n_iso=None):
    """Forward-only static-vals pass (bench/profiling), without the
    custom-vjp wrapper.
    n_iso: pass op.static[4] when the plan was built degree-sorted."""
    return _hyb_pass(h_table, plan, num_out, "static", None, gather_dtype,
                     n_iso=n_iso)


class HybSpMM:
    """Same protocol as ops.degree_spmm.DegreeSpMM: `.arrays` rides jit
    arguments (the batch pytree); apply/apply_dst/apply_static dispatch.
    num_in may exceed h's rows (halo tables); dh is truncated to h's rows.
    """

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype=None,
                 feature_dim: int = 128, static_val=None,
                 lam_slots: int = _LAMBDA_SLOTS, dynamic: bool = True):
        """dynamic=False drops the slot->edge maps (per-bucket s2e +
        plan e2s) from the shipped arrays: only the dynamic per-edge
        value path reads them at runtime, and at production scale they
        are E-sized int32 grids — ~0.8 GB of device memory per plan at
        100M edges. apply() raises when built without them; apply_static / apply_dst /
        apply_unit — the paths both production models use — are
        unaffected."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        e = len(src)
        assert e == 0 or (np.diff(dst) >= 0).all(), "edges must be dst-sorted"
        order = np.argsort(src, kind="stable")
        self.num_in, self.num_out = num_in, num_out
        self.has_static_vals = static_val is not None
        self.dynamic = dynamic
        fwd = build_hyb_plan(src, dst, None, num_out, max_width, lam_slots,
                             static_val)
        bwd = build_hyb_plan(dst[order], src[order], order, num_in,
                             max_width, lam_slots, static_val)
        self.n_slots = fwd["n_slots"] + bwd["n_slots"]
        for p in (fwd, bwd):
            p.pop("n_slots")
            if not dynamic:
                p.pop("e2s", None)
                for b in p["buckets"]:
                    b.pop("s2e", None)
                if p["top"] is not None:
                    p["top"].pop("s2e", None)
        n_iso = (fwd.pop("_n_iso", None), bwd.pop("_n_iso", None))
        if gather_dtype is not None and jnp.dtype(gather_dtype).itemsize < 4:
            # Narrow mode multiplies weights in the msgs dtype at runtime
            # anyway (_weights) — ship static vals pre-cast and halve
            # their memory (one rounding instead of per-pass casts).
            for p in (fwd, bwd):
                _cast_vals(p, np.dtype(gather_dtype))
        self.arrays = {
            "fwd": jax.tree.map(jnp.asarray, fwd),
            "bwd": jax.tree.map(jnp.asarray, bwd),
        }
        self.static = (num_in, num_out,
                       None if gather_dtype is None
                       else jnp.dtype(gather_dtype), e) + n_iso + (0,)

    def set_msgs_budget(self, budget: int) -> None:
        """Engine-scoped msgs scan-chunk guard (fit_msgs_budget result):
        rides the hashed `static` tuple so two engines of different
        scales in one process never share a guard."""
        self.static = self.static[:6] + (int(budget),)

    @property
    def gather_itemsize(self) -> int:
        """Bytes per element of the gather table (4 = f32, 2 = bf16) —
        models consult this for regime-aware aggregation ordering."""
        gdt = self.static[2]
        return 4 if gdt is None else jnp.dtype(gdt).itemsize

    def apply(self, arrays, h, val):
        if not self.dynamic:
            raise RuntimeError(
                "op built with dynamic=False (slot->edge maps not "
                "shipped); rebuild with dynamic=True for per-edge values")
        return hyb_spmm_apply(self.static, arrays, h, val)

    def apply_dst(self, arrays, h, dst_val):
        return hyb_spmm_dst_apply(self.static, arrays, h, dst_val)

    def apply_unit(self, arrays, h):
        return hyb_spmm_unit_apply(self.static, arrays, h)

    def apply_static(self, arrays, h):
        return hyb_spmm_static_apply(self.static, arrays, h)

    def __call__(self, h, val):
        return hyb_spmm_apply(self.static, self.arrays, h, val)
