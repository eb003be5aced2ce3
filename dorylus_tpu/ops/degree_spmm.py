"""Degree-padded blocked SpMM — the fast XLA aggregation path.

Replaces the reference's per-vertex CSC aggregation loop
(src/graph-server/engine/ops/gcn_ops.cpp:130-191) with a layout that turns
the variable-degree segment reduction into fixed-width work XLA runs at
streaming bandwidth.

A flat gather + variable-length sorted segment_sum spends most of its
time on the ragged segments; a fixed-width reshape(...).sum(1) reduce of
the same bytes is a dense, fusable reduction.

Layout: edges arrive dst-sorted (CSC). Each vertex's edge run is padded to
a multiple of `block` slots; pad slots carry val=0 and gather an arbitrary
row (zero weight kills them in fwd AND bwd). The slot grid (R, block)
then reduces with a dense fused  gather -> scale -> sum(axis=1)  and a
final short sorted segment_sum over the per-vertex block rows (R ≈ E/block
+ V rows, cheap).

Backward: custom VJP. dL/dh is the same kernel over the transposed graph
(its own plan, built once); dL/dval is FUSED into that pass — the slots of
the transposed plan gather gout[dst e] for dh anyway, so
dval[e] = <h[src e], gout[dst e]> is one extra F-reduction against
h[block_row] plus an E-element gather through the inverse slot map (no
scatter, no second sweep over the edge bytes). This replaces the
reference's hand-written backward aggregate (gcn_ops.cpp:130-153 dir
BACKWARD) and keeps autodiff from emitting an XLA scatter-add.

The plan MUST ride jit arguments (the batch
pytree), never closures.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


_ROW_CHUNK_BYTES = 8 << 30  # auto row_chunk once (slots, F) is this big


def build_degree_plan(src: np.ndarray, dst: np.ndarray,
                      edge_ids: np.ndarray | None,
                      num_out: int, block: int = 16,
                      out_block_rows: int = 0) -> dict:
    """Host-side plan. Requires dst ascending (CSC order).

    edge_ids: original edge index of each (src, dst) pair — identity for
    the forward plan, the transpose permutation for the backward plan —
    so dynamic edge values (GAT attention) can be routed into slots.

    out_block_rows: block the FINAL segment reduction's output rows into
    scanned blocks of this height (0 = one plain segment_sum). Adds
    "out_idx"/"out_loc" (nb, rb) maps: per output block, the part-rows
    that feed it (padded with the R sentinel row) and their block-local
    destination rows.
    """
    e = len(src)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if edge_ids is None:
        edge_ids = np.arange(e, dtype=np.int64)
    deg = np.bincount(dst, minlength=num_out)
    nblk = -(-deg // block)  # ceil; 0 for isolated vertices
    r = max(1, int(nblk.sum()))
    block_row = np.repeat(np.arange(num_out, dtype=np.int64), nblk)
    if len(block_row) == 0:
        block_row = np.zeros(1, np.int64)
    vstart = np.zeros(num_out + 1, np.int64)
    np.cumsum(nblk * block, out=vstart[1:])
    estart = np.zeros(num_out + 1, np.int64)
    np.cumsum(deg, out=estart[1:])
    slot = vstart[dst] + (np.arange(e) - estart[dst])

    n_slots = r * block
    slot_src = np.zeros(n_slots, np.int32)
    slot_to_edge = np.full(n_slots, e, np.int64)  # e == padding sentinel
    slot_src[slot] = src
    slot_to_edge[slot] = edge_ids
    # Inverse map: original edge id -> flat slot (for the fused-SDDMM bwd).
    edge_to_slot = np.zeros(max(1, e), np.int64)
    edge_to_slot[edge_ids] = slot
    plan = {
        "slot_src": slot_src.reshape(r, block),
        "slot_to_edge": slot_to_edge.astype(np.int32).reshape(r, block),
        "block_row": block_row.astype(np.int32),
        "edge_to_slot": edge_to_slot.astype(np.int32),
        # Live slots per block row. Edges fill each vertex's slot run in
        # order, so liveness within a row is always a PREFIX — a (R,) count
        # reconstructs the (R, B) mask via an in-register iota compare,
        # 16x fewer mask bytes than a dense (R, B) array (see _slot_live).
        "live_cnt": np.bincount(slot // block, minlength=r).astype(np.int32),
    }
    if out_block_rows:
        nb = -(-num_out // out_block_rows)
        bounds = np.searchsorted(block_row, np.arange(nb + 1) * out_block_rows)
        rb = max(8, int(-(-int(np.diff(bounds).max()) // 8) * 8))
        out_idx = np.full((nb, rb), r, np.int32)  # r == zero-row sentinel
        out_loc = np.full((nb, rb), out_block_rows - 1, np.int32)
        for b in range(nb):
            lo, hi = bounds[b], bounds[b + 1]
            out_idx[b, : hi - lo] = np.arange(lo, hi)
            out_loc[b, : hi - lo] = block_row[lo:hi] - b * out_block_rows
        plan["out_idx"] = out_idx
        plan["out_loc"] = out_loc
        # Static block height: plain int, popped into statics by callers
        # (must NOT ride the jit-traced plan arrays).
        plan["_out_block_rows"] = out_block_rows
    return plan


def _degree_pass(h_table: jnp.ndarray, plan: dict, num_out: int,
                 val: jnp.ndarray | None, row_chunk: int = 0,
                 gather_dtype=None, other: jnp.ndarray | None = None,
                 out_block_rows: int = 0,
                 vals: jnp.ndarray | None = None):
    """Core slot-grid pass: out[v] = sum_{slots of v} val * h_table[slot_src].

    When `other` is given (the fused-SDDMM backward), also returns the
    per-edge dot products dval[e] = <h_table[slot of e], other[row of e]>
    pulled back into original edge order via plan["edge_to_slot"] — one
    F-reduction on the already-gathered slot messages plus an E-gather,
    instead of a second sweep over the edge bytes. Always f32 accumulation.

    `vals` supplies the (R, B) per-slot weights directly (dst-functional
    edge values, degree_spmm_dst_apply) — skipping the per-edge
    val_ext[slot_to_edge] gather, whose E-sized table makes it the most
    expensive index op in the pass.

    out_block_rows > 0 (with the plan's out_idx/out_loc maps) blocks the
    final segment reduction's output rows.
    """
    if vals is None:
        val_ext = jnp.concatenate([val.astype(jnp.float32),
                                   jnp.zeros((1,), jnp.float32)])
        vals = val_ext[plan["slot_to_edge"]]  # (R, B)
    table = h_table if gather_dtype is None else h_table.astype(gather_dtype)
    hb = None if other is None else other[plan["block_row"]]  # (R, F)
    # Low-precision gather mode: keep the gathered messages in the table
    # dtype through the multiply and accumulate in f32 only inside the
    # reduction. Writing gather(x).astype(f32) instead lets XLA hoist the
    # convert BEFORE the gather, which gathers f32 rows and erases the
    # halved gather bytes. Accumulation stays f32.
    narrow = gather_dtype is not None and jnp.dtype(gather_dtype).itemsize < 4

    def reduce_rows(s, v, hb_):
        if narrow:
            msgs = table[s]  # (r, B, F) bf16 — no convert on the gather
            prod = msgs * v[..., None].astype(msgs.dtype)
            dh = prod.sum(axis=1, dtype=jnp.float32)  # (r, F) f32 accum
        else:
            msgs = table[s].astype(jnp.float32)  # (r, B, F)
            dh = (msgs * v[..., None]).sum(axis=1)  # (r, F) f32
        if hb_ is None:
            return dh, None
        dv = (msgs * hb_[:, None, :].astype(msgs.dtype)).sum(
            -1, dtype=jnp.float32)  # (r, B)
        return dh, dv

    r = plan["slot_src"].shape[0]
    if row_chunk and r > row_chunk:
        n = -(-r // row_chunk)
        pad = n * row_chunk - r
        chunked = [jnp.pad(x, ((0, pad), (0, 0))).reshape(n, row_chunk, -1)
                   for x in (plan["slot_src"], vals)
                   + (() if hb is None else (hb,))]

        def body(_, ch):
            s, v = ch[0], ch[1]
            return None, reduce_rows(s, v, ch[2] if len(ch) > 2 else None)

        _, (parts, dvs) = jax.lax.scan(body, None, tuple(chunked))
        part = parts.reshape(n * row_chunk, -1)[:r]
        dv = None if dvs is None else dvs.reshape(n * row_chunk, -1)[:r]
    else:
        part, dv = reduce_rows(plan["slot_src"], vals, hb)
    if out_block_rows and "out_idx" in plan:
        part_ext = jnp.concatenate(
            [part, jnp.zeros((1, part.shape[1]), part.dtype)])

        def blk_body(_, ch):
            idx, loc = ch
            return None, jax.ops.segment_sum(part_ext[idx], loc,
                                             num_segments=out_block_rows,
                                             indices_are_sorted=True)

        _, blocks = jax.lax.scan(blk_body, None,
                                 (plan["out_idx"], plan["out_loc"]))
        out = blocks.reshape(-1, part.shape[1])[:num_out]
    else:
        out = jax.ops.segment_sum(part, plan["block_row"],
                                  num_segments=num_out,
                                  indices_are_sorted=True)
    if other is None:
        return out
    dval = dv.ravel()[plan["edge_to_slot"]][: val.shape[0]]
    return out, dval


def spmm_degree(h_table: jnp.ndarray, plan: dict, num_out: int,
                val: jnp.ndarray | None, row_chunk: int = 0,
                gather_dtype=None) -> jnp.ndarray:
    """out[v] = sum_{e: dst[e]=v} val[e] * h_table[src[e]] over a
    build_degree_plan layout. val=None uses the plan's baked static slot
    values ("vals"). Forward only (no custom VJP wrapper); differentiable
    training goes through DegreeSpMM.apply*."""
    plan = dict(plan)
    obr = plan.pop("_out_block_rows", 0)
    vals = plan.get("vals") if val is None else None
    return _degree_pass(h_table, plan, num_out, val, row_chunk, gather_dtype,
                        out_block_rows=obr, vals=vals)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def degree_spmm_apply(static, arrs, h, val):
    """static: (num_in, num_out, row_chunk, gather_dtype,
    fwd_out_block_rows, bwd_out_block_rows) — the last two block the final
    reduces (0 = plain segment_sum)."""
    _, num_out, row_chunk, gdt = static[:4]
    fwd_obr = static[4] if len(static) > 4 else 0
    return _degree_pass(h, arrs["fwd"], num_out, val, row_chunk, gdt,
                        out_block_rows=fwd_obr)


def _apply_fwd(static, arrs, h, val):
    return degree_spmm_apply(static, arrs, h, val), (arrs, h, val)


def _apply_bwd(static, res, gout):
    arrs, h, val = res
    num_in, _, row_chunk, gdt = static[:4]
    bwd_obr = static[5] if len(static) > 5 else 0
    # One pass over the transposed plan yields BOTH grads: the slots gather
    # gout[dst e] for dh, and dval[e] = <h[src e], gout[dst e]> reuses those
    # same gathered messages against h[block_row] (fused SDDMM).
    dh_full, dval = _degree_pass(gout, arrs["bwd"], num_in, val, row_chunk,
                                 gdt, other=h, out_block_rows=bwd_obr)
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh, dval.astype(val.dtype)


degree_spmm_apply.defvjp(_apply_fwd, _apply_bwd)


def _slot_live(plan: dict, sentinel: int) -> jnp.ndarray:
    """(R, B) f32 liveness: 1 for slots bound to a LIVE edge. Liveness is
    a per-row prefix (edges fill slot runs in order; sharded pad edges
    sort after the real edges of the same dst), so plans carry an (R,)
    count ("live_cnt") expanded here by an iota compare — no (R, B) mask
    bytes move. Falls back to the sentinel test for plans without it."""
    cnt = plan.get("live_cnt")
    if cnt is not None:
        b = plan["slot_src"].shape[1]
        return (jax.lax.iota(jnp.int32, b)[None, :]
                < cnt[:, None]).astype(jnp.float32)
    return (plan["slot_to_edge"] != sentinel).astype(jnp.float32)


def _dst_unit_fwd(static, arrs, h):
    """U[v] = sum_{live e: dst e = v} h[src e] — the unit-weight forward
    aggregate all dst-functional math factors through."""
    _, num_out, row_chunk, gdt = static[:4]
    fwd_obr, sentinel = static[4], static[6]
    fplan = arrs["fwd"]
    return _degree_pass(h, fplan, num_out, None, row_chunk, gdt,
                        out_block_rows=fwd_obr,
                        vals=_slot_live(fplan, sentinel))


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def degree_spmm_dst_apply(static, arrs, h, dst_val):
    """SpMM whose edge weights are a function of the DESTINATION vertex:
    out[v] = sum_{e: dst e = v} dst_val[v] * h[src e]   (live edges only).

    This is exactly Dorylus GAT attention (logits from the destination
    only, funcs/gat/ops/forward_ops.cpp:109-141). Because the weight is
    constant across each destination's edges, it factors OUT of the sum:
        out = dst_val[:, None] * U,   U[v] = sum_{e: dst=v} h[src e]
    so no per-edge (or even per-slot) value array ever exists, and U —
    already computed by the forward — is exactly the residual the
    attention gradient needs:
        d dst_val[v] = <U[v], gout[v]>                (a row-dot, free)
        dh           = unit-pass over the transposed plan of
                       dst_val[:, None] * gout        (ONE edge sweep)
    The reference computes its attention backward in one fused sweep too
    (gat_ops.cpp:222-241); round 2's version here paid a second full
    forward-plan sweep for U — fused away in round 3. static adds
    num_edges (the slot sentinel) at index 6."""
    return _dst_unit_fwd(static, arrs, h) * dst_val.astype(jnp.float32)[:, None]


def _dst_fwd(static, arrs, h, dst_val):
    u = _dst_unit_fwd(static, arrs, h)
    out = u * dst_val.astype(jnp.float32)[:, None]
    # h rides the residuals only for its shape/dtype (truncating dh) —
    # the backward never reads its values.
    return out, (arrs, dst_val, u, h)


def _dst_bwd(static, res, gout):
    arrs, dst_val, u, h = res
    h_rows, h_dtype = h.shape[0], h.dtype
    num_in, num_out, row_chunk, gdt = static[:4]
    bwd_obr, sentinel = static[5], static[6]
    bplan = arrs["bwd"]
    # dh[u] = sum_{e: src=u} dst_val[dst e] * gout[dst e]: scale gout rows
    # once (a (V, F) elementwise op) and run ONE unit-weight pass over the
    # transposed plan — no per-slot weight gather at all.
    gscaled = gout.astype(jnp.float32) * dst_val.astype(jnp.float32)[:, None]
    dh_full = _degree_pass(gscaled, bplan, num_in, None, row_chunk, gdt,
                           out_block_rows=bwd_obr,
                           vals=_slot_live(bplan, sentinel))
    dh = dh_full[:h_rows].astype(h_dtype)
    # Attention grad from the saved unit aggregate: a row-wise dot.
    d_dst = (u * gout.astype(jnp.float32)).sum(-1).astype(dst_val.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh, d_dst


degree_spmm_dst_apply.defvjp(_dst_fwd, _dst_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def degree_spmm_unit_apply(static, arrs, h):
    """Unit edge weights: out[v] = sum_{live e: dst e = v} h[src e]. The
    regime-aware GAT ordering aggregates h unweighted (models/gat.py);
    this skips the ones-multiply forward and constant-cotangent row-dot
    backward apply_dst would otherwise build."""
    return _dst_unit_fwd(static, arrs, h)


def _unit_fwd(static, arrs, h):
    return _dst_unit_fwd(static, arrs, h), (arrs, h)


def _unit_bwd(static, res, gout):
    arrs, h = res
    num_in, _, row_chunk, gdt = static[:4]
    bwd_obr, sentinel = static[5], static[6]
    bplan = arrs["bwd"]
    dh_full = _degree_pass(gout.astype(jnp.float32), bplan, num_in, None,
                           row_chunk, gdt, out_block_rows=bwd_obr,
                           vals=_slot_live(bplan, sentinel))
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh


degree_spmm_unit_apply.defvjp(_unit_fwd, _unit_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def degree_spmm_static_apply(static, arrs, h):
    """SpMM with STATIC edge values baked into the plans as (R, B) slot
    arrays ("vals", built host-side at construction). GCN norms never
    change, so the per-slot value gather (an R*B-index gather from an
    E-sized table) is pure waste in that model."""
    _, num_out, row_chunk, gdt = static[:4]
    return _degree_pass(h, arrs["fwd"], num_out, None, row_chunk, gdt,
                        out_block_rows=static[4],
                        vals=arrs["fwd"]["vals"])


def _static_fwd(static, arrs, h):
    return degree_spmm_static_apply(static, arrs, h), (arrs, h)


def _static_bwd(static, res, gout):
    arrs, h = res
    num_in, _, row_chunk, gdt = static[:4]
    dh_full = _degree_pass(gout, arrs["bwd"], num_in, None, row_chunk, gdt,
                           out_block_rows=static[5],
                           vals=arrs["bwd"]["vals"])
    dh = dh_full[: h.shape[0]].astype(h.dtype)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh


degree_spmm_static_apply.defvjp(_static_fwd, _static_bwd)


class DegreeSpMM:
    """out[v] = sum_{e: dst[e]=v} val[e] * h[src[e]], differentiable in h
    and val, sparsity pattern bound at construction. Same protocol as
    ops.degree_sharded.ShardedDegreeSpMM: pass `.arrays` through jit arguments and
    call `.apply(arrays, h, val)`.

    num_in may exceed h's rows (halo tables); h is indexed as given, the
    backward dh is truncated to h's rows by _apply_bwd.
    """

    def __init__(self, src, dst, num_in: int, num_out: int, block: int = 16,
                 row_chunk: int = 0, gather_dtype=None,
                 out_block_rows: int = 0, feature_dim: int = 128,
                 static_val=None):
        """static_val: per-edge values known at construction (GCN norms) —
        baked into the plans as (R, B) slot arrays so apply_static() skips
        the runtime per-slot value gather."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        e = len(src)
        assert e == 0 or (np.diff(dst) >= 0).all(), "edges must be dst-sorted"
        order = np.argsort(src, kind="stable")
        self.num_in, self.num_out = num_in, num_out
        self.block = block
        narrow = (gather_dtype is not None
                  and np.dtype(gather_dtype).itemsize < 4)
        fwd = build_degree_plan(src, dst, None, num_out, block,
                                out_block_rows)
        bwd = build_degree_plan(dst[order], src[order], order, num_in, block,
                                out_block_rows)
        self.has_static_vals = static_val is not None
        if self.has_static_vals:
            ve = np.r_[np.asarray(static_val, np.float32), 0.0]
            fwd["vals"] = ve[fwd["slot_to_edge"]]
            bwd["vals"] = ve[bwd["slot_to_edge"]]
            if narrow:
                # Narrow mode multiplies slot weights in the msgs dtype
                # anyway (_degree_pass reduce_rows): ship them pre-cast
                # and halve their memory — one host-side rounding instead of
                # a per-pass (R, B) convert (same idiom as hyb _cast_vals).
                fwd["vals"] = fwd["vals"].astype(gather_dtype)
                bwd["vals"] = bwd["vals"].astype(gather_dtype)
        if row_chunk == 0:
            # XLA materializes the (slots, F) message tensor. Chunk only
            # when it would be very large — the scan-chunked pass is
            # several times slower, so this is strictly an OOM guard, not
            # an optimization. feature_dim = the widest feature dim this
            # op will aggregate; bf16 messages halve the estimate.
            slots = max(fwd["slot_src"].size, bwd["slot_src"].size)
            if slots * feature_dim * (2 if narrow else 4) > _ROW_CHUNK_BYTES:
                row_chunk = 1 << 18
        fwd_obr = fwd.pop("_out_block_rows", 0)
        bwd_obr = bwd.pop("_out_block_rows", 0)
        self.arrays = {
            "fwd": {k: jnp.asarray(v) for k, v in fwd.items()},
            "bwd": {k: jnp.asarray(v) for k, v in bwd.items()},
        }
        self.static = (num_in, num_out, row_chunk,
                       None if gather_dtype is None else jnp.dtype(gather_dtype),
                       fwd_obr, bwd_obr, e)

    def apply(self, arrays, h, val):
        return degree_spmm_apply(self.static, arrays, h, val)

    @property
    def gather_itemsize(self) -> int:
        """Bytes per element of the gather table (4 = f32, 2 = bf16)."""
        gdt = self.static[3]
        return 4 if gdt is None else jnp.dtype(gdt).itemsize

    def apply_dst(self, arrays, h, dst_val):
        """Edge weight = dst_val[dst[e]] (Dorylus GAT attention) — no
        per-edge arrays anywhere; see degree_spmm_dst_apply."""
        return degree_spmm_dst_apply(self.static, arrays, h, dst_val)

    def apply_unit(self, arrays, h):
        """Unit-weight aggregation (live edges only); see
        degree_spmm_unit_apply."""
        return degree_spmm_unit_apply(self.static, arrays, h)

    def apply_static(self, arrays, h):
        """Construction-time edge values (static_val): no runtime value
        gather at all; see degree_spmm_static_apply."""
        return degree_spmm_static_apply(self.static, arrays, h)

    def __call__(self, h, val):
        return degree_spmm_apply(self.static, self.arrays, h, val)
