"""GCN with Dorylus-exact semantics, as one compiled program.

Forward per layer (reference: funcs/gcn/main.cpp forwardLayer :215-270):
    AH = S · H          (aggregation, ops/spmm.py — Gather phase)
    Z  = AH · W         (dense matmul — the Lambda ApplyVertex phase, fused)
    H  = tanh(Z)        (hidden layers; final layer feeds softmax CE)

Final layer + loss (funcs/gcn/main.cpp finalLayer :47-133): softmax CE over
train rows scaled by 1/(|V_global|·0.66). The backward pass — the
reference's hand-written backwardLayer chain (tanh' ⊙ grad, dW = AHᵀ·dZ,
grad = dZ·Wᵀ) and backward aggregation over the transposed adjacency — is
obtained by jax.grad of this forward, which produces the same math.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.models import init as winit
from dorylus_tpu.models.base import GraphBatch, Params
from dorylus_tpu.ops.activations import masked_softmax_xent, row_softmax
from dorylus_tpu.ops.spmm import aggregate, spmm_edgewise

HaloFn = Callable[[jnp.ndarray], jnp.ndarray]
# A HaloFn maps local H -> feature table (local rows + received ghost rows).
# Single-device: identity. Sharded: parallel.halo.halo_exchange.

# Manual-mode tensor-parallel AD idioms (shard_map check_vma=False skips
# jax's replication bookkeeping, so the TP forward must place these two
# ops itself — MEASURED: grad(lax.psum) under check_vma=False is another
# psum, so a raw psum whose output cotangent is replicated-identical
# over-counts gradients m-fold; Adam's per-parameter scale invariance
# masked exactly this bug until GAT mixed differently-scaled paths):
#
#   * _complete_grad_feat — identity fwd; bwd psums the cotangent. Wrap
#     a feat-REPLICATED value at each fork that per-shard slices consume:
#     the true cotangent of a replicated value is the SUM of the shards'
#     partial cotangents.
#   * _psum_feat — psum fwd; bwd identity. Use for partial-product
#     assembly whose OUTPUT cotangent is replicated-identical (the layer
#     matmul z, the attention matvec za, the agg block assembly): each
#     shard's partial truly receives d(out), not m·d(out).


@jax.custom_vjp
def _complete_grad_feat(x):
    return x


def _cgf_fwd(x):
    return x, None


def _cgf_bwd(_, g):
    from dorylus_tpu.parallel.mesh import FEAT_AXIS

    return (jax.lax.psum(g, FEAT_AXIS),)


_complete_grad_feat.defvjp(_cgf_fwd, _cgf_bwd)


@jax.custom_vjp
def _psum_feat(x):
    from dorylus_tpu.parallel.mesh import FEAT_AXIS

    return jax.lax.psum(x, FEAT_AXIS)


def _psf_fwd(x):
    return _psum_feat(x), None


def _psf_bwd(_, g):
    return (g,)


_psum_feat.defvjp(_psf_fwd, _psf_bwd)


class GCN:
    def __init__(self, layers: LayerConfig, sorted_dst: bool = True,
                 edge_chunk: int = 0, optimize_order: bool = True,
                 spmm_op=None, spmm_split=None,
                 feat_shards: int = 1):
        """sorted_dst: edge arrays are CSC-ordered (dst ascending) — both
        build_batch and partition_graph guarantee this.

        edge_chunk: SpMM edge-chunk size (0 = no chunking); bound memory on
        Reddit/Friendster-scale graphs.

        optimize_order: exploit (S·H)·W == S·(H·W): when a layer shrinks the
        feature dim, transform *before* aggregating — fewer SpMM bytes and
        (sharded) F_out-wide instead of F_in-wide halo exchange. The
        reference is locked into aggregate-first because its Lambdas need
        "ah" materialized; here the order is free. Disabled automatically
        when return_intermediates=True so oracle tests see the reference's
        tensor order.
        """
        self.layers = layers
        self.sorted_dst = sorted_dst
        self.edge_chunk = edge_chunk
        self.optimize_order = optimize_order
        # Optional bound SpMM op (ops/degree_spmm.DegreeSpMM) for this
        # graph's sparsity pattern; falls back to the XLA path when None.
        self.spmm_op = spmm_op
        # Optional (interior, boundary) degree-op pair for the halo-overlap
        # path (ops/degree_sharded.ShardedDegreeSpMM edges="interior"/
        # "boundary"); arrays ride batch.aux["spmm_int"]/["spmm_bnd"].
        self.spmm_split = spmm_split
        # Feature/tensor parallelism over the mesh 'feat' axis (>1 =
        # _forward_tp): each feat shard aggregates an F/m column slice —
        # the gather moves m times fewer bytes per shard — and the layer
        # matmul psums partial products. An extension of this rebuild; the
        # reference has no model parallelism.
        self.feat_shards = feat_shards

    def _aggregate_split(self, h, batch, ghosts):
        """Overlap path: interior aggregation has no dependency on the halo
        collective that produced `ghosts`, so XLA schedules them together
        (the reference's compute/scatter overlap, pipeline.cpp)."""
        if getattr(self.spmm_split, "fused", False):
            # Fused overlap plan (ops/hyb_sharded.py edges="fused"): ONE
            # plan, pure buckets gather from h, mixed from (h ‖ ghosts) —
            # no second inverse permutation or output add.
            op = self.spmm_split
            aux = batch.aux or {}
            assert op.has_static_vals, "GCN fused overlap bakes norms"
            out = op.apply_static_fused(aux["spmm"], h, ghosts)
            return (out.astype(h.dtype)
                    + h * batch.self_val[:, None].astype(h.dtype))
        if self.spmm_split is not None:
            op_i, op_b = self.spmm_split
            aux = batch.aux or {}
            if getattr(op_i, "has_static_vals", False):
                out_i = op_i.apply_static(aux["spmm_int"], h)
                out_b = op_b.apply_static(aux["spmm_bnd"], ghosts)
            else:
                out_i = op_i.apply(aux["spmm_int"], h,
                                   batch.val_int.astype(h.dtype))
                out_b = op_b.apply(aux["spmm_bnd"], ghosts,
                                   batch.val_bnd.astype(h.dtype))
            return ((out_i + out_b).astype(h.dtype)
                    + h * batch.self_val[:, None].astype(h.dtype))
        out_i = aggregate(h, batch.src_int, batch.dst_int, batch.val_int,
                          batch.self_val, sorted_dst=self.sorted_dst,
                          edge_chunk=self.edge_chunk)
        out_b = spmm_edgewise(ghosts, batch.src_bnd, batch.dst_bnd,
                              batch.val_bnd, h.shape[0],
                              sorted_dst=self.sorted_dst,
                              edge_chunk=self.edge_chunk)
        return out_i + out_b

    def _agg_halo(self, x, batch, halo):
        """Aggregate x (building the halo table from it).

        Note: GCN norms factorize as f(src)·f(dst) with f = sqrt(self_val),
        so the dst-functional kernel (degree_spmm_dst_apply) applies in
        principle — pre-scale x by f before the halo, unit-weight SpMM,
        dst_val = f. GCN keeps the static per-edge plan values instead: f
        is a constant here, so the plan bakes the weights (apply_static)
        and no runtime value array exists either way."""
        table = halo(x) if halo is not None else x
        return self._aggregate(x, batch, table)

    def _aggregate(self, h, batch, table):
        if self.spmm_op is not None:
            # Production paths ALWAYS ship the plan via batch.aux (the
            # closure fallback below is for small-scale direct callers —
            # a closed-over plan becomes program constants and a
            # recompile hazard; CLAUDE.md).
            arrays = (batch.aux or {}).get("spmm", self.spmm_op.arrays)
            if getattr(self.spmm_op, "has_static_vals", False):
                # GCN norms are static per graph: the (R, B) slot values
                # live in the plan, no runtime value gather.
                out = self.spmm_op.apply_static(arrays, table)
            else:
                out = self.spmm_op.apply(arrays, table,
                                         batch.edge_val.astype(h.dtype))
            return out.astype(h.dtype) + h * batch.self_val[:, None].astype(h.dtype)
        return aggregate(h, batch.src, batch.dst, batch.edge_val,
                         batch.self_val, h_table=table,
                         sorted_dst=self.sorted_dst,
                         edge_chunk=self.edge_chunk)

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """Per-layer xavier weights, each from a fresh engine with a fixed
        seed — matching WeightServer::initWeightsMasterGCN
        (weightserver.cpp:516-532)."""
        params: Params = {}
        dims = self.layers.dims
        for l in range(len(dims) - 1):
            w = winit.xavier(dims[l], dims[l + 1], seed=seed, exact=exact_reference or None)
            params[f"w{l}"] = jnp.asarray(w)
        return params

    def _forward_tp(self, params: Params, batch: GraphBatch,
                    halo: Optional[HaloFn],
                    compute_dtype: jnp.dtype) -> jnp.ndarray:
        """Tensor-parallel forward (feat_shards > 1, inside a 2-axis
        shard_map): per layer, slice the feat shard's h columns, halo +
        aggregate at F/m width (all collectives on the 'graph' axis only),
        matmul against the matching W row block, then psum the partial
        products over 'feat' — z (and hence the loss) is identical on
        every feat shard. Aggregate-first always (the slice already
        narrows the table; ordering games don't compose with TP).
        Backward: _complete_grad_feat restores the replicated h cotangent
        and _psum_feat keeps the partial-product assembly's transpose an
        identity (see the idiom block above); the engine psums grads over
        BOTH axes, which assembles the per-shard W row blocks.

        Layer ordering follows the non-TP rule (transform first when the
        layer shrinks): aggregation and the halo then run at
        min(F_in, F_out)/m width — without this, TP on a shrinking layer
        (Reddit 602->128 at m=2) would halo/gather 301-wide, MORE bytes
        than the single-device 128-wide path it is meant to split. The
        transform-first slice aggregates z's columns and psum-assembles
        the blocks (the GAT TP pattern); an output width that doesn't
        divide m falls back to aggregate-first."""
        from dorylus_tpu.parallel.mesh import FEAT_AXIS

        m = self.feat_shards
        h = batch.x.astype(compute_dtype)
        fi = jax.lax.axis_index(FEAT_AXIS)
        for l in range(self.layers.num_layers):
            w = params[f"w{l}"].astype(compute_dtype)
            assert h.shape[1] % m == 0, \
                f"layer {l} width {h.shape[1]} not divisible by " \
                f"feat_shards={m}"
            blk = h.shape[1] // m
            h = _complete_grad_feat(h)
            hs = jax.lax.dynamic_slice_in_dim(h, fi * blk, blk, axis=1)
            ws = jax.lax.dynamic_slice_in_dim(w, fi * blk, blk, axis=0)
            transform_first = (self.optimize_order
                               and w.shape[0] > w.shape[1]
                               and w.shape[1] % m == 0)
            if transform_first:
                hw = _psum_feat(
                    jnp.dot(hs, ws, preferred_element_type=jnp.float32))
                blk_o = hw.shape[1] // m
                hwc = _complete_grad_feat(hw)
                hws = jax.lax.dynamic_slice_in_dim(hwc, fi * blk_o, blk_o,
                                                   axis=1)
                agg_s = self._agg_halo(hws, batch, halo)
                z = _psum_feat(jax.lax.dynamic_update_slice(
                    jnp.zeros_like(hw), agg_s.astype(hw.dtype),
                    (0, fi * blk_o)))
            else:
                ah = self._agg_halo(hs, batch, halo)
                z = _psum_feat(
                    jnp.dot(ah, ws, preferred_element_type=jnp.float32))
            # Hidden activations return to compute_dtype (z is f32 via
            # preferred_element_type): without this cast --bf16 applied
            # to layer 0 only — every later matmul/gather/halo silently
            # promoted to f32 (round-5 review).
            h = (jnp.tanh(z).astype(compute_dtype)
                 if l < self.layers.num_layers - 1 else z)
        return h

    def forward(
        self,
        params: Params,
        batch: GraphBatch,
        halo: Optional[HaloFn] = None,
        compute_dtype: jnp.dtype = jnp.float32,
        return_intermediates: bool = False,
    ):
        """Returns logits (Vp, C); with return_intermediates, also the list
        of (ah, z, h) per layer for oracle tests."""
        if self.feat_shards > 1:
            assert not return_intermediates, "TP path: no intermediates"
            assert batch.src_int is None, "TP path requires overlap=False"
            return self._forward_tp(params, batch, halo, compute_dtype)
        num_layers = self.layers.num_layers
        h = batch.x.astype(compute_dtype)
        inter = []
        for l in range(num_layers):
            w = params[f"w{l}"].astype(compute_dtype)
            transform_first = (self.optimize_order and not return_intermediates
                               and w.shape[0] > w.shape[1])
            # When the batch carries the interior/boundary split, `halo`
            # returns ghost rows only (parallel.halo.halo_recv) and the
            # split path is used; otherwise `halo` builds the full table.
            split = batch.src_int is not None and halo is not None
            if transform_first:
                hw = jnp.dot(h, w, preferred_element_type=jnp.float32)
                if split:
                    z = self._aggregate_split(hw, batch, halo(hw))
                else:
                    z = self._agg_halo(hw, batch, halo)
            else:
                if split:
                    ah = self._aggregate_split(h, batch, halo(h))
                else:
                    ah = self._agg_halo(h, batch, halo)
                z = jnp.dot(ah, w, preferred_element_type=jnp.float32)
            # Hidden activations return to compute_dtype (see _forward_tp
            # note): z is f32; without the cast --bf16 stopped at layer 0.
            h = (jnp.tanh(z).astype(compute_dtype)
                 if l < num_layers - 1 else z)
            if return_intermediates:
                inter.append((ah, z, h))
        if return_intermediates:
            return h, inter
        return h

    def loss(self, params: Params, batch: GraphBatch,
             halo: Optional[HaloFn] = None,
             compute_dtype: jnp.dtype = jnp.float32) -> jnp.ndarray:
        logits = self.forward(params, batch, halo, compute_dtype)
        return masked_softmax_xent(logits, batch.onehot, batch.train_mask, batch.denom)

    def predict(self, params: Params, batch: GraphBatch,
                halo: Optional[HaloFn] = None) -> jnp.ndarray:
        return row_softmax(self.forward(params, batch, halo))
