"""Sparse aggregation (SpMM) — the Gather phase.

Replaces the reference's per-vertex CSC/CSR loops (Engine::aggregateGCN,
src/graph-server/engine/ops/gcn_ops.cpp:130-191 and aggregateGAT,
gat_ops.cpp:173-243) with edge-parallel gather + segment-sum, which XLA
lowers to vectorized gathers and segment reductions. The backward pass
(the reference's hand-written backward aggregate over the transposed
adjacency) falls out of autodiff: the transpose of
`gather(src) -> scale -> scatter_add(dst)` is exactly
`gather(dst) -> scale -> scatter_add(src)`.

For the optimized path see dorylus_tpu.ops.degree_spmm.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def spmm_edgewise(
    h: jnp.ndarray,  # (V_table, F) feature table (local verts [+ ghosts])
    src: jnp.ndarray,  # (E,) int32 indices into the feature table
    dst: jnp.ndarray,  # (E,) int32 indices into [0, num_out)
    edge_val: jnp.ndarray,  # (E,) float edge weights (norms or attention)
    num_out: int,
    sorted_dst: bool = False,
    edge_chunk: int = 0,
) -> jnp.ndarray:
    """out[v] = sum_{e: dst[e]=v} edge_val[e] * h[src[e]].

    Padding convention: pad edges with edge_val = 0 (src/dst pointing at any
    valid index); zero weights make padding a no-op in fwd and bwd.

    sorted_dst: edges are sorted by dst (CSC order, how the reference stores
    forwardAdj) — lets XLA use the fast sorted-segment path.

    edge_chunk > 0: process edges in chunks of that size under lax.scan so
    the gathered message tensor (|E|, F) is never materialized — required
    for Reddit/Friendster-scale graphs where |E|·F·4B outgrows device
    memory. The chunk grid is the analog of the reference's per-lambda
    edge chunks
    (lambdaworker.cpp:376-388).
    """
    if edge_chunk and src.shape[0] > edge_chunk:
        e = src.shape[0]
        n_chunks = -(-e // edge_chunk)
        pad = n_chunks * edge_chunk - e
        if pad:
            # Pad dst with the LAST output row, not 0: real edges are
            # dst-ascending and the sorted-segment hint below is undefined
            # behavior if padding breaks monotonicity (zero edge_val still
            # keeps padding a numerical no-op).
            src = jnp.concatenate([src, jnp.zeros(pad, src.dtype)])
            dst = jnp.concatenate(
                [dst, jnp.full(pad, num_out - 1, dst.dtype)])
            edge_val = jnp.concatenate([edge_val, jnp.zeros(pad, edge_val.dtype)])
        chunks = (src.reshape(n_chunks, -1), dst.reshape(n_chunks, -1),
                  edge_val.reshape(n_chunks, -1))

        def body(out, ch):
            s, d, v = ch
            msgs = h[s] * v[:, None].astype(h.dtype)
            # Per-chunk sorted segment-sum (chunks of globally dst-sorted
            # edges stay sorted) + dense accumulate, instead of the
            # scatter-add XLA emits for out.at[d].add(msgs).
            part = jax.ops.segment_sum(msgs, d, num_segments=num_out,
                                       indices_are_sorted=sorted_dst)
            return out + part, None

        init = jnp.zeros((num_out, h.shape[1]), h.dtype)
        out, _ = jax.lax.scan(body, init, chunks)
        return out

    msgs = h[src] * edge_val[:, None].astype(h.dtype)
    return jax.ops.segment_sum(msgs, dst, num_segments=num_out,
                               indices_are_sorted=sorted_dst)


def aggregate(
    h: jnp.ndarray,  # (V, F) local vertex features
    src: jnp.ndarray,
    dst: jnp.ndarray,
    edge_val: jnp.ndarray,
    self_val: jnp.ndarray,  # (V,) self-loop norm factors
    h_table: jnp.ndarray | None = None,  # feature table incl. ghosts; default h
    sorted_dst: bool = False,
    edge_chunk: int = 0,
) -> jnp.ndarray:
    """GCN aggregation: ah = self_val * h + SpMM(edge_val, h_table).

    Matches aggregateGCN's "copy own features, scale by vtx norm factor,
    accumulate weighted neighbors" (gcn_ops.cpp:155-190).
    """
    table = h if h_table is None else h_table
    out = spmm_edgewise(table, src, dst, edge_val, h.shape[0],
                        sorted_dst=sorted_dst, edge_chunk=edge_chunk)
    return out + h * self_val[:, None].astype(h.dtype)


# ---------------------------------------------------------------------------
# Sorted-index row/scalar gather with a segment-sum backward.
#
# The autodiff VJP of x[idx] is a scatter-add
# (the reason ops/degree_spmm.py exists). When idx is ASCENDING (our edges
# are CSC/dst-sorted), the adjoint is a sorted segment_sum instead. GAT's
# per-edge attention logits az = za[dst] hit this on |E|-sized gathers
# every layer (gat_ops.cpp:173-243's A tensor).
# ---------------------------------------------------------------------------


import functools as _functools


@_functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def take_sorted(x: jnp.ndarray, idx: jnp.ndarray, num_segments: int):
    """x[idx] with idx ascending; backward = sorted segment_sum (no
    scatter). x may be (N,) or (N, F); num_segments = x.shape[0] (static)."""
    return x[idx]


def _take_sorted_fwd(x, idx, num_segments):
    return x[idx], (idx, jnp.zeros((), x.dtype))


def _take_sorted_bwd(num_segments, res, g):
    idx, dtype_token = res
    dx = jax.ops.segment_sum(g.astype(jnp.float32), idx,
                             num_segments=num_segments,
                             indices_are_sorted=True)
    return dx.astype(dtype_token.dtype), None


take_sorted.defvjp(_take_sorted_fwd, _take_sorted_bwd)
