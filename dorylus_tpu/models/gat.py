"""GAT with Dorylus's (non-textbook) attention semantics.

The reference GAT (funcs/gat/main.cpp + commmanager/CPU_comm.cpp:161-242,
engine/ops/gat_ops.cpp) differs from standard GAT:

  per layer l (NO hidden activation anywhere):
    Z  = H · W_l                       (apply_vertex, CPU_comm.cpp:161-169)
    az_e = <z_dst(e), a_l>             (apply_edge expandDot over CSC columns
                                        = destination vertex only,
                                        funcs/gat/ops/forward_ops.cpp:109-141)
    A_e  = LeakyReLU(az_e), slope .01  (no per-neighbor softmax!)
    AH_v = z_v + sum_{u->v} A_e * z_u  (aggregateGAT, gat_ops.cpp:173-243:
                                        self contribution has weight 1)
    H_{l+1} = AH                       (vtxNNForwardGAT reads layer l-1 "ah")

  output: softmax(AH_last) row-wise. (predictGAT, gat_ops.cpp:247-265, reads
  tensor "az" there — an out-of-bounds repurposing bug in the reference since
  "az" is |E|x1; the intended input is the final aggregation "ah", which is
  what we use.)

Backward: the reference hand-derives an *approximate* attention gradient
(da = Z^T Z · reduce(dAct)^T, CPU_comm.cpp:205-242); we instead get exact
gradients from jax.grad of this forward. Loss uses the same masked softmax
CE as GCN (the reference GAT path omits maskout/trainset scaling — another
reference deviation we fix by intent).

The reference also initializes an unused second attention vector "a_j"
(weightserver.cpp:535-559); compute only ever pulls "a_i", so we keep one.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.models import init as winit
from dorylus_tpu.models.base import GraphBatch, Params
from dorylus_tpu.models.gcn import HaloFn
from dorylus_tpu.ops.activations import leaky_relu, masked_softmax_xent, row_softmax
from dorylus_tpu.ops.spmm import spmm_edgewise, take_sorted


class GAT:
    def __init__(self, layers: LayerConfig, sorted_dst: bool = True,
                 edge_chunk: int = 0, spmm_op=None,
                 spmm_split=None, feat_shards: int = 1):
        self.layers = layers
        self.sorted_dst = sorted_dst
        self.edge_chunk = edge_chunk
        # Tensor parallelism over the mesh 'feat' axis (>1 = _forward_tp;
        # see models/gcn.py — the same column-slice + psum pattern, with
        # the attention matvec computed block-wise so d(a) assembles
        # under the dual-axis grad reduction instead of over-counting).
        self.feat_shards = feat_shards
        # Optional bound SpMM op; its fused-SDDMM backward supplies the
        # attention-value gradients (replacing gat hand-derived backward).
        self.spmm_op = spmm_op
        # (interior, boundary) degree-op pair for the halo-overlap path;
        # attention is dst-functional, so BOTH passes weight by the same
        # local leaky(z·a) and their sum equals the combined kernel.
        self.spmm_split = spmm_split

    def init_params(self, seed: int = 8888, exact_reference: bool = True) -> Params:
        """w: xavier; a_i: kaiming — initWeightsMasterGAT
        (weightserver.cpp:535-559)."""
        params: Params = {}
        dims = self.layers.dims
        for l in range(len(dims) - 1):
            params[f"w{l}"] = jnp.asarray(
                winit.xavier(dims[l], dims[l + 1], seed=seed,
                             exact=exact_reference or None))
            params[f"a{l}"] = jnp.asarray(
                winit.kaiming_reference(dims[l + 1], 1, seed=seed))
        return params

    def _forward_tp(self, params: Params, batch: GraphBatch,
                    halo: Optional[HaloFn],
                    compute_dtype: jnp.dtype) -> jnp.ndarray:
        """Tensor-parallel GAT (feat_shards > 1, 2-axis shard_map).

        Per layer: z = psum_f(h_slice @ W_block) is full on every feat
        shard; the attention matvec runs BLOCK-wise (za = psum_f of
        column-masked z @ a) so each shard's d(a) covers only its rows
        and the dual-axis grad psum assembles — a replicated za would
        over-count d(a) by m. Aggregation slices z's columns when the
        layer width divides feat_shards (halo + gather at F/m width, the
        TP win), else runs full-replicated (the narrow output layer).
        _complete_grad_feat marks every replicated-value fork consumed
        through per-shard slices (models/gcn.py)."""
        import jax

        from dorylus_tpu.models.gcn import _complete_grad_feat, _psum_feat
        from dorylus_tpu.parallel.mesh import FEAT_AXIS

        m = self.feat_shards
        fi = jax.lax.axis_index(FEAT_AXIS)
        h = batch.x.astype(compute_dtype)
        arrays = (batch.aux or {}).get(
            "spmm", None if self.spmm_op is None else self.spmm_op.arrays)
        for l in range(self.layers.num_layers):
            w = params[f"w{l}"].astype(compute_dtype)
            a = params[f"a{l}"].astype(compute_dtype)
            assert h.shape[1] % m == 0
            blk = h.shape[1] // m
            h = _complete_grad_feat(h)
            hs = jax.lax.dynamic_slice_in_dim(h, fi * blk, blk, axis=1)
            ws = jax.lax.dynamic_slice_in_dim(w, fi * blk, blk, axis=0)
            z = _psum_feat(
                jnp.dot(hs, ws, preferred_element_type=jnp.float32)
            ).astype(compute_dtype)
            fo = z.shape[1]
            # Block-wise attention matvec: column-masked partial products
            # (a mask handles widths that don't divide m, e.g. the output
            # layer) — d(a) lands block-local on each shard.
            lo = fi * fo // m
            hi = (fi + 1) * fo // m
            cmask = ((jax.lax.iota(jnp.int32, fo) >= lo)
                     & (jax.lax.iota(jnp.int32, fo) < hi))
            # ONE wrapped fork of z serves both slice-like consumers (the
            # attention matvec mask and the aggregation slice): the wrap's
            # backward psum sums ALL partial cotangents at once — two
            # wraps would emit two (V, F) feat-axis collectives per layer.
            zc = _complete_grad_feat(z)
            za = _psum_feat(
                jnp.dot(zc * cmask[None, :].astype(zc.dtype), a,
                        preferred_element_type=jnp.float32))[:, 0]
            att = leaky_relu(za)
            if fo % m == 0 and self.spmm_op is not None:
                blk_o = fo // m
                zs = jax.lax.dynamic_slice_in_dim(zc, fi * blk_o, blk_o,
                                                  axis=1)
                att_s = _complete_grad_feat(att)  # partial agg consumers
                table = halo(zs) if halo is not None else zs
                agg_s = self.spmm_op.apply_dst(arrays, table, att_s)
                agg = _psum_feat(
                    jax.lax.dynamic_update_slice(
                        jnp.zeros_like(z),
                        agg_s.astype(z.dtype), (0, fi * blk_o)))
            else:
                # Full-replicated aggregation (no slicing win; identical
                # on every feat shard, so no cotangent completion).
                table = halo(z) if halo is not None else z
                if self.spmm_op is not None:
                    agg = self.spmm_op.apply_dst(arrays, table,
                                                 att).astype(z.dtype)
                else:
                    av = leaky_relu(take_sorted(za, batch.dst, za.shape[0])) \
                        * batch.edge_val.astype(compute_dtype)
                    agg = spmm_edgewise(table, batch.src, batch.dst, av,
                                        z.shape[0],
                                        sorted_dst=self.sorted_dst,
                                        edge_chunk=self.edge_chunk)
            h = z + agg
        return h

    def forward(
        self,
        params: Params,
        batch: GraphBatch,
        halo: Optional[HaloFn] = None,
        compute_dtype: jnp.dtype = jnp.float32,
        return_intermediates: bool = False,
    ):
        if self.feat_shards > 1:
            assert not return_intermediates, "TP path: no intermediates"
            assert batch.src_int is None, "TP path requires overlap=False"
            return self._forward_tp(params, batch, halo, compute_dtype)
        num_layers = self.layers.num_layers
        h = batch.x.astype(compute_dtype)
        # For GAT, batch.edge_val is a {0,1} mask (padding edges 0); the
        # graph norm factors are not used (attention provides edge weights).
        edge_mask = batch.edge_val.astype(compute_dtype)
        inter = []
        for l in range(num_layers):
            z = jnp.dot(h, params[f"w{l}"].astype(compute_dtype),
                        preferred_element_type=jnp.float32)
            # Attention logits from the *destination* vertex only
            # (edgeMatMul iterates CSC columns = dst; forward_ops.cpp:109-141).
            za = jnp.dot(z, params[f"a{l}"].astype(compute_dtype),
                         preferred_element_type=jnp.float32)[:, 0]  # (Vp,)
            if batch.src_int is not None and halo is not None:
                # Overlap path: halo returns ghost z rows only; interior
                # attention aggregation proceeds alongside the collective.
                ghosts = halo(z)
                if getattr(self.spmm_split, "fused", False):
                    # Fused overlap plan (hyb): one dst-functional pass,
                    # pure buckets gather z locally alongside the
                    # in-flight collective (ops/hyb_sharded.py).
                    aux = batch.aux or {}
                    agg = self.spmm_split.apply_dst_fused(
                        aux["spmm"], z, ghosts,
                        leaky_relu(za)).astype(z.dtype)
                elif self.spmm_split is not None:
                    # Degree-kernel overlap: two dst-functional passes
                    # (interior over z, boundary over the ghost rows),
                    # both weighted by the local attention vector.
                    op_i, op_b = self.spmm_split
                    aux = batch.aux or {}
                    att_v = leaky_relu(za)
                    agg = (op_i.apply_dst(aux["spmm_int"], z, att_v)
                           + op_b.apply_dst(aux["spmm_bnd"], ghosts, att_v)
                           ).astype(z.dtype)
                else:
                    # take_sorted: dst arrays are ascending, so the
                    # attention gradient reduces via sorted segment_sum,
                    # not scatter-add.
                    att_i = leaky_relu(
                        take_sorted(za, batch.dst_int, za.shape[0])) \
                        * batch.val_int.astype(compute_dtype)
                    att_b = leaky_relu(
                        take_sorted(za, batch.dst_bnd, za.shape[0])) \
                        * batch.val_bnd.astype(compute_dtype)
                    agg = spmm_edgewise(z, batch.src_int, batch.dst_int,
                                        att_i, z.shape[0],
                                        sorted_dst=self.sorted_dst,
                                        edge_chunk=self.edge_chunk)
                    agg = agg + spmm_edgewise(ghosts, batch.src_bnd,
                                              batch.dst_bnd, att_b,
                                              z.shape[0],
                                              sorted_dst=self.sorted_dst,
                                              edge_chunk=self.edge_chunk)
                az = att = None
                if return_intermediates:
                    az = za[batch.dst]
                    att = leaky_relu(az) * edge_mask
            else:
                table = halo(z) if halo is not None else z
                use_dst = (self.spmm_op is not None
                           and hasattr(self.spmm_op, "apply_dst")
                           and not return_intermediates)
                if use_dst:
                    # Dorylus attention is a function of the DESTINATION
                    # only, so no per-edge value array need ever exist:
                    # apply_dst broadcasts leaky(za) by block row and its
                    # backward is a unit-weight pass + row-dot (see
                    # degree_spmm_dst_apply). Pad edges are statically
                    # dead via the plans' live masks.
                    az = att = None
                    arrays = (batch.aux or {}).get("spmm",
                                                   self.spmm_op.arrays)
                    agg = self.spmm_op.apply_dst(
                        arrays, table, leaky_relu(za)).astype(z.dtype)
                else:
                    # Sorted-VJP gather: the backward of za[dst] is
                    # otherwise an |E|-sized scatter-add into (Vp,).
                    az = take_sorted(za, batch.dst, za.shape[0])  # (Ep,)
                    att = leaky_relu(az) * edge_mask
                    if self.spmm_op is not None:
                        arrays = (batch.aux or {}).get(
                            "spmm", self.spmm_op.arrays)
                        agg = self.spmm_op.apply(arrays, table,
                                                 att).astype(z.dtype)
                    else:
                        agg = spmm_edgewise(table, batch.src, batch.dst, att,
                                            z.shape[0],
                                            sorted_dst=self.sorted_dst,
                                            edge_chunk=self.edge_chunk)
            # Hidden layers return to compute_dtype (z is f32 via
            # preferred_element_type; GAT has no activation) — without
            # this --bf16 applied to layer 0 only (round-5 review). The
            # final layer keeps f32 logits for the loss.
            h = ((z + agg).astype(compute_dtype)
                 if l < num_layers - 1 else z + agg)
            if return_intermediates:
                inter.append((z, az, att, h))
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
