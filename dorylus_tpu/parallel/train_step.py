"""Sharded training: SPMD over vertex shards via shard_map.

The multi-node architecture of the reference — graph servers exchanging
ghost activations over ZMQ (commmanager), weight servers all-reducing
gradients via pub/sub ACK counting (weightserver.cpp:89-187) — maps to:

  - vertex shards on mesh axis 'graph' (one shard per chip),
  - per-layer halo exchange = all_to_all (parallel/halo.py),
  - replicated params; weight gradients psum'd inside the compiled step
    (the entire weight-server tier),
  - barrier = the collectives themselves.

Everything (forward, halo exchanges, backward, Adam) is ONE jitted SPMD
program per epoch step: XLA overlaps the all_to_all with local aggregation
the same way the reference overlaps scatter with Lambda compute.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.common.logging import log
from dorylus_tpu.common.metrics import RunReport
from dorylus_tpu.graph.graph import Graph
from dorylus_tpu.graph.partition import ShardedGraph, partition_graph
from dorylus_tpu.models.base import GraphBatch
from dorylus_tpu.models.gat import GAT
from dorylus_tpu.models.gcn import GCN
from dorylus_tpu.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu.optim.adam import adam_init, adam_update, sgd_update
from dorylus_tpu.parallel.halo import halo_exchange, halo_recv
from dorylus_tpu.parallel.mesh import GRAPH_AXIS, make_mesh


def _local_batch(arrs: dict, denom: float, overlap: bool
                 ) -> tuple[GraphBatch, jnp.ndarray]:
    """Squeeze the per-device leading shard axis and build a GraphBatch.
    With overlap=True the batch carries the interior/boundary edge split,
    signalling models to treat the halo callable as ghost-rows-only."""
    sq = jax.tree.map(lambda v: v[0], arrs)
    split = {k: sq[k] for k in ("src_int", "dst_int", "val_int",
                                "src_bnd", "dst_bnd", "val_bnd")} \
        if overlap else {}
    aux = {k: sq[k] for k in ("spmm", "spmm_int", "spmm_bnd") if k in sq} \
        or None
    batch = GraphBatch(
        x=sq["x"], onehot=sq["onehot"], src=sq["src"], dst=sq["dst"],
        edge_val=sq["edge_val"], self_val=sq["self_val"],
        train_mask=sq["train_mask"], val_mask=sq["val_mask"],
        test_mask=sq["test_mask"],
        denom=jnp.asarray(denom, jnp.float32),
        aux=aux,
        **split,
    )
    # (send lists, backward plan, exact-wire plan) — halo.py
    # build_recv_plan / build_ragged_plan.
    halo_args = (sq["send_idx"], sq.get("halo_order"), sq.get("halo_rows"),
                 sq.get("ragged"))
    return batch, halo_args


def build_sharded_train_step(model, cfg: TrainConfig, mesh: Mesh, denom: float):
    """Returns (step_fn, eval_fn) jitted over the mesh."""
    compute_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    # Overlap applies to BOTH kernels: the degree kernel gets interior/
    # boundary plan pairs (round 2 disabled it exactly where auto picks
    # degree — the scale where overlap matters most).
    overlap = getattr(cfg, "overlap", True) and mesh.shape[GRAPH_AXIS] > 1
    from dorylus_tpu.parallel.mesh import FEAT_AXIS
    # Weight grads reduce over BOTH axes under tensor parallelism: 'graph'
    # sums vertex-shard contributions, 'feat' assembles the per-shard W
    # row blocks (models/gcn.py _forward_tp). Loss/eval stats stay
    # graph-only (identical across feat shards by construction).
    grad_axes = ((GRAPH_AXIS, FEAT_AXIS)
                 if mesh.shape.get(FEAT_AXIS, 1) > 1 else GRAPH_AXIS)
    # A prefix spec: every arrs leaf is sharded along its leading shard axis
    # (including nested SpMM plan arrays).
    data_spec = P(GRAPH_AXIS)

    def _halo_fn(halo_args):
        from dorylus_tpu.parallel.halo import make_halo_fn
        return make_halo_fn(halo_args, overlap,
                            mesh.shape[GRAPH_AXIS] > 1)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), data_spec, P()),
             out_specs=(P(), P(), P()),
             check_vma=False)
    def step(params, grad_params, opt_state, arrs, lr):
        batch, send_idx = _local_batch(arrs, denom, overlap)
        halo = _halo_fn(send_idx)

        def local_loss(p):
            return model.loss(p, batch, halo=halo, compute_dtype=compute_dtype)

        # Bounded staleness (pipeline.cpp:95-102 + weight stashing,
        # weighttensor.cpp:80-123): gradients at the (up to S epochs old)
        # grad_params, applied to the current params — same emulation as
        # the single-device Engine; sync mode passes grad_params = params.
        loss, grads = jax.value_and_grad(local_loss)(grad_params)
        # All-reduce: the whole weight-server tier in one op.
        grads = jax.lax.psum(grads, grad_axes)
        loss = jax.lax.psum(loss, GRAPH_AXIS)
        if cfg.adam:
            params, opt_state = adam_update(
                params, grads, opt_state, lr=lr,
                beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                weight_decay=cfg.weight_decay)
        else:
            params = sgd_update(params, grads, lr)
        return params, opt_state, loss

    # Multi-epoch compiled group: K epochs inside ONE compiled SPMD call
    # via lax.scan — per-call dispatch moves ~50 sharded plan-array
    # buffers and costs ~85 ms on a 4-device CPU mesh; the scanned body
    # amortizes it.
    # Bounded staleness rides the scan carry as a stacked (S+1, ...)
    # param history — same construction as engine.Engine._make_step.
    # In-group eval (see engine.Engine._make_step): the flag PATTERN is
    # host-known per group, so three variants compile lazily — "none"
    # (no eval in the body), "all" (eval inlined), "mixed" (lax.cond,
    # flag replicated so every shard takes the same branch; the psum
    # stays OUTSIDE the cond — zeros psum on skipped epochs).
    # Second variant axis (see engine.Engine._make_step): synchronous
    # training (staleness 0, the default) carries NO history — the per-
    # epoch stack roll is a full param copy XLA does not elide.
    def make_multi(eval_mode: str, with_history: bool):
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(), P(), P(), data_spec, P(), P()),
                 out_specs=(P(), P(), P(), P(), P()),
                 check_vma=False)
        def multi_step(params, opt_state, history, arrs, lrs, flags):
            batch, send_idx = _local_batch(arrs, denom, overlap)
            halo = _halo_fn(send_idx)

            def local_loss(p):
                return model.loss(p, batch, halo=halo,
                                  compute_dtype=compute_dtype)

            def val_stats(params):
                probs = row_softmax(model.forward(params, batch, halo=halo))
                return jnp.stack(accuracy_and_loss(probs, batch.onehot,
                                                   batch.val_mask))

            def body(carry, lr_flag):
                if with_history:
                    params, opt_state, history = carry
                    grad_params = jax.tree.map(lambda x: x[0], history)
                else:
                    params, opt_state = carry
                    grad_params = params
                lr, flag = lr_flag
                loss, grads = jax.value_and_grad(local_loss)(grad_params)
                grads = jax.lax.psum(grads, grad_axes)
                loss = jax.lax.psum(loss, GRAPH_AXIS)
                if cfg.adam:
                    params, opt_state = adam_update(
                        params, grads, opt_state, lr=lr,
                        beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                        weight_decay=cfg.weight_decay)
                else:
                    params = sgd_update(params, grads, lr)
                if with_history:
                    history = jax.tree.map(
                        lambda hi, p: jnp.concatenate([hi[1:], p[None]]),
                        history, params)
                if eval_mode == "none":
                    stats = jnp.zeros(3, jnp.float32)
                elif eval_mode == "all":
                    stats = val_stats(params)
                else:
                    stats = jax.lax.cond(flag, val_stats,
                                         lambda p: jnp.zeros(3, jnp.float32),
                                         params)
                stats = jax.lax.psum(stats, GRAPH_AXIS)
                carry = ((params, opt_state, history) if with_history
                         else (params, opt_state))
                return carry, (loss, stats)

            carry = ((params, opt_state, history) if with_history
                     else (params, opt_state))
            carry, (losses, stats) = jax.lax.scan(body, carry, (lrs, flags))
            if with_history:
                params, opt_state, history = carry
            else:
                params, opt_state = carry
            return params, opt_state, history, losses, stats

        if with_history:
            return jax.jit(multi_step, donate_argnums=(1, 2))
        return jax.jit(multi_step, donate_argnums=(1,))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), data_spec, None),
             out_specs=P(),
             check_vma=False)
    def evaluate(params, arrs, which):
        batch, send_idx = _local_batch(arrs, denom, overlap)
        halo = _halo_fn(send_idx)
        probs = row_softmax(model.forward(params, batch, halo=halo))
        mask = {"train": batch.train_mask, "val": batch.val_mask,
                "test": batch.test_mask}[which]
        correct, loss, count = accuracy_and_loss(probs, batch.onehot, mask)
        stats = jnp.stack([correct, loss, count])
        return jax.lax.psum(stats, GRAPH_AXIS)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), data_spec),
             out_specs=P(GRAPH_AXIS),
             check_vma=False)
    def predict(params, arrs):
        """Per-shard final-layer outputs, stacked (n_shards, vp, C) —
        reassembled into global vertex order by the caller via global_ids."""
        batch, send_idx = _local_batch(arrs, denom, overlap)
        halo = _halo_fn(send_idx)
        return model.forward(params, batch, halo=halo)[None]

    step_jit = jax.jit(step, donate_argnums=(2,))
    eval_jit = jax.jit(evaluate, static_argnums=(2,))
    multis = {(mode, h): make_multi(mode, h)
              for mode in ("none", "all", "mixed") for h in (True, False)}
    return step_jit, eval_jit, jax.jit(predict), multis


class ShardedEngine:
    """Multi-device engine: same surface as engine.Engine, SPMD execution."""

    def __init__(self, graph: Graph, layers: LayerConfig, cfg: TrainConfig,
                 mesh: Optional[Mesh] = None, partition_method: str = "range",
                 parts: Optional[np.ndarray] = None):
        from dorylus_tpu.common.cache import enable_compile_cache
        enable_compile_cache(cfg.compile_cache)
        self.graph = graph
        self.layers = layers
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.num_shards, feat_shards=cfg.feat_shards)
        n = self.mesh.shape[GRAPH_AXIS]
        from dorylus_tpu.parallel.mesh import FEAT_AXIS
        feat = self.mesh.shape.get(FEAT_AXIS, 1)
        if cfg.feat_shards > 1 and feat != cfg.feat_shards:
            raise ValueError(
                f"cfg.feat_shards={cfg.feat_shards} but the mesh has "
                f"feat axis size {feat} — build it with "
                f"make_mesh(n, feat_shards={cfg.feat_shards})")
        if feat > 1:
            # Tensor parallelism (models/gcn.py / gat.py _forward_tp):
            # combined-plan path (the interior/boundary split and the TP
            # column slices don't compose — the slice already narrows the
            # halo, which is what overlap mostly buys).
            for d in layers.dims[:-1]:
                assert d % feat == 0, \
                    f"layer width {d} not divisible by feat_shards={feat}"
            if cfg.overlap:
                import dataclasses
                cfg = dataclasses.replace(cfg, overlap=False)
                self.cfg = cfg
            log("tensor parallelism: %d feat shards x %d graph shards",
                feat, n)
        self._feat = feat
        self.sharded = partition_graph(
            graph, n, method=partition_method, parts=parts,
            for_gat=cfg.model == "gat")
        if cfg.edge_chunk == 0 and self.sharded.ep > (1 << 23):
            # Bound the per-shard (ep, F) message tensor (see engine.py).
            import dataclasses
            cfg = dataclasses.replace(cfg, edge_chunk=4_000_000)
            self.cfg = cfg
            log("auto edge_chunk=4M for %d edges/shard", self.sharded.ep)
        from dorylus_tpu.common.config import resolve_kernel
        kernel = resolve_kernel(cfg.kernel)
        if kernel != cfg.kernel:
            import dataclasses
            log("kernel auto -> %s", kernel)
            cfg = dataclasses.replace(cfg, kernel=kernel)
            self.cfg = cfg
        if isinstance(cfg.overlap, str):
            # overlap="auto": hyb resolves to the FUSED overlap plan and
            # degree to the interior/boundary plan pair; the xla edgewise
            # split stays off (it measured slower than serial on the CPU
            # mesh, and no four-card measurement supports it yet).
            import dataclasses
            resolved = (cfg.overlap == "on" if cfg.overlap != "auto"
                        else cfg.kernel in ("hyb", "degree"))
            cfg = dataclasses.replace(cfg, overlap=resolved)
            self.cfg = cfg
        spmm_op = None
        spmm_split = None
        from dorylus_tpu.engine.engine import _max_agg_width
        reuse_on = cfg.reuse == "pairs" and cfg.kernel == "hyb"
        if cfg.reuse == "pairs" and not reuse_on:
            log("pair reuse requires kernel=hyb (have %s) — off", cfg.kernel)
        stacked = self.sharded.stacked()
        # Halo wire format (TrainConfig.halo): "auto" is the padded
        # all_to_all; the exact (ragged) format runs only when asked for.
        use_ragged = n > 1 and cfg.halo == "ragged"
        if use_ragged:
            # First-use canary (parallel/halo.py ragged_canary): a tiny
            # ragged_all_to_all of the production dtype/rank runs and is
            # checked numerically BEFORE the big program compiles. The
            # format was asked for, so a failure is an error, not a
            # silent switch to the padded format.
            from dorylus_tpu.parallel import halo as halo_mod
            cdt = (jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                   else jnp.float32)
            if not halo_mod.ragged_canary(self.mesh, cdt):
                raise halo_mod.RaggedHaloUnavailable(
                    "halo='ragged': lax.ragged_all_to_all failed its canary "
                    "on this mesh; use halo='padded'")
            from dorylus_tpu.parallel.halo import build_ragged_plan
            stacked["ragged"] = build_ragged_plan(self.sharded)
            log("halo: exact (ragged) wire format — per-pair exact row "
                "counts on the wire (padded ghost layout unchanged; "
                "canary passed)")
        if cfg.kernel in ("degree", "hyb"):
            # Per-shard slot plans padded to uniform shapes (degree:
            # block-row counts; hyb: shared-DP bucket structure).
            if reuse_on:
                from dorylus_tpu.ops.reuse_sharded import ShardedReuseSpMM
                spmm_op = ShardedReuseSpMM(
                    self.sharded,
                    feature_dim=_max_agg_width(layers, cfg),
                    gather_dtype=(jnp.bfloat16
                                  if cfg.agg_dtype == "bfloat16" else None),
                    rank1_factor=(np.sqrt(graph.self_norm)
                                  if cfg.model == "gcn" else None),
                    passes=cfg.reuse_passes,
                    max_pairs=max(cfg.reuse_max_pairs, 0))
                rows_b = sum(m.stats["rows_before"] for m in spmm_op.plan_fwd)
                rows_a = sum(m.stats["rows_after"] for m in spmm_op.plan_fwd)
                log("sharded pair reuse: %d fwd pairs over %d shards, "
                    "gathered rows %d -> %d (-%.1f%%)", spmm_op.num_pairs,
                    n, rows_b, rows_a, 100 * (1 - rows_a / max(1, rows_b)))
                stacked["spmm"] = spmm_op.arrays
                if cfg.overlap and n > 1:
                    # Rewrites and the interior/boundary split are
                    # mutually exclusive (a pair may combine an interior
                    # and a ghost row); reuse runs the combined-plan path.
                    # XLA still schedules the halo collective alongside
                    # the independent dense work.
                    import dataclasses
                    cfg = dataclasses.replace(cfg, overlap=False)
                    self.cfg = cfg
                    log("pair reuse: interior/boundary overlap split "
                        "disabled (rewrites span the combined edge set)")
            if cfg.kernel == "hyb":
                from dorylus_tpu.ops.hyb_sharded import ShardedHybSpMM as Op
            else:
                from dorylus_tpu.ops.degree_sharded import ShardedDegreeSpMM as Op
            kw = dict(feature_dim=_max_agg_width(layers, cfg),
                      gather_dtype=(jnp.bfloat16
                                    if cfg.agg_dtype == "bfloat16" else None),
                      static_vals=cfg.model == "gcn")
            if cfg.kernel == "hyb":
                # Production models never take the dynamic per-edge value
                # path — don't ship the E-sized slot->edge maps (see
                # HybSpMM dynamic=False).
                kw["dynamic"] = False
            if reuse_on:
                pass  # op built above
            elif cfg.overlap and self.mesh.shape[GRAPH_AXIS] > 1:
                if cfg.kernel == "hyb":
                    # FUSED overlap plan (round 5): ONE plan whose pure
                    # buckets gather local rows (overlappable with the
                    # collective) and mixed buckets gather the combined
                    # table — one inverse permutation, one output pass.
                    spmm_split = Op(self.sharded, edges="fused", **kw)
                    stacked["spmm"] = spmm_split.arrays
                    # The models' fused branch reads only aux["spmm"];
                    # batch.src_int merely SIGNALS the ghost-rows-only
                    # halo — ship (n, 0) stubs instead of six E-sized
                    # split arrays (~24 B/edge/shard of dead memory at
                    # exactly the scale overlap targets).
                    for k in ("src_int", "dst_int", "val_int",
                              "src_bnd", "dst_bnd", "val_bnd"):
                        stacked[k] = np.zeros((n, 0), stacked[k].dtype)
                else:
                    # Interior/boundary plan pair (degree kernel): the
                    # halo-overlap path (pipeline.cpp:256-286 analog).
                    # The models never touch the combined plan on this
                    # path, so it is neither built (host time) nor
                    # shipped (its E-sized slot grids would roughly
                    # double per-device plan memory at exactly the scale
                    # overlap targets).
                    spmm_split = (
                        Op(self.sharded, edges="interior", **kw),
                        Op(self.sharded, edges="boundary", **kw))
                    stacked["spmm_int"] = spmm_split[0].arrays
                    stacked["spmm_bnd"] = spmm_split[1].arrays
                    # As on the fused branch: the models' split path reads
                    # only aux["spmm_int"/"spmm_bnd"] (GCN apply_static,
                    # GAT apply_dst); batch.src_int merely signals the
                    # ghost-rows-only halo — stub the six E-sized split
                    # arrays instead of shipping ~24 B/edge/shard dead.
                    for k in ("src_int", "dst_int", "val_int",
                              "src_bnd", "dst_bnd", "val_bnd"):
                        stacked[k] = np.zeros((n, 0), stacked[k].dtype)
            else:
                spmm_op = Op(self.sharded, **kw)
                stacked["spmm"] = spmm_op.arrays
        self.model = (GCN(layers, edge_chunk=cfg.edge_chunk,
                          optimize_order=cfg.optimize_order, spmm_op=spmm_op,
                          spmm_split=spmm_split, feat_shards=feat)
                      if cfg.model == "gcn"
                      else GAT(layers, edge_chunk=cfg.edge_chunk,
                               spmm_op=spmm_op, spmm_split=spmm_split,
                               feat_shards=feat))
        # Place each shard's block on its device (leading axis sharded).
        self.arrs = jax.tree.map(
            lambda v: jax.device_put(
                v, NamedSharding(self.mesh, P(GRAPH_AXIS))), stacked)
        if cfg.kernel == "hyb":
            # Per-device capacity: fit the msgs chunk guard to the memory
            # left after this shard's static footprint (leading shard
            # axis splits every leaf across devices) — see
            # engine.Engine.__init__ / ops/hyb_spmm.fit_msgs_budget.
            from dorylus_tpu.ops.hyb_spmm import fit_msgs_budget, tree_nbytes
            width = _max_agg_width(layers, cfg)
            table_rows = self.sharded.vp + n * self.sharded.max_h
            guard = fit_msgs_budget(tree_nbytes(stacked) // n,
                                    table_rows * width * 12, log)
            # Engine-scoped: the guard rides each op's static tuple
            # (spmm_split is a pair for the degree split, a single fused
            # op for hyb overlap).
            split_ops = (() if spmm_split is None
                         else (spmm_split,) if not isinstance(spmm_split,
                                                              tuple)
                         else spmm_split)
            for op in ((spmm_op,) if spmm_op is not None else ()) + split_ops:
                op.set_msgs_budget(guard)
        self.params = jax.device_put(
            self.model.init_params(seed=cfg.seed),
            NamedSharding(self.mesh, P()))
        self.opt_state = jax.device_put(
            adam_init(self.params), NamedSharding(self.mesh, P())) if cfg.adam else None
        self.report = RunReport()
        self._compiled = None
        self.kernel_selected = cfg.kernel
        self.start_epoch = 0
        if cfg.resume and cfg.checkpoint_dir:
            from dorylus_tpu.engine.checkpoint import latest_checkpoint, load_checkpoint
            path = latest_checkpoint(cfg.checkpoint_dir)
            if path is not None:
                ck = load_checkpoint(path)
                rep = NamedSharding(self.mesh, P())
                self.params = jax.device_put(
                    jax.tree.map(jnp.asarray, ck["params"]), rep)
                if ck["opt_state"] is not None and cfg.adam:
                    self.opt_state = jax.device_put(
                        jax.tree.map(jnp.asarray, ck["opt_state"]), rep)
                self.start_epoch = int(ck["step"])
                log("resumed from %s (epoch %d)", path, self.start_epoch)

    def _maybe_checkpoint(self, epoch: int) -> None:
        cfg = self.cfg
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (epoch + 1) % cfg.checkpoint_every == 0):
            from dorylus_tpu.engine.checkpoint import save_checkpoint
            save_checkpoint(cfg.checkpoint_dir, epoch + 1, self.params,
                            self.opt_state)

    def run(self, epochs: Optional[int] = None) -> RunReport:
        epochs = epochs if epochs is not None else self.cfg.epochs
        if self._compiled is None:
            self._compiled = build_sharded_train_step(
                self.model, self.cfg, self.mesh, self.sharded.denom)
        step, evaluate, _, multis = self._compiled
        from dorylus_tpu.engine.engine import run_group_loop

        # Same bounded-staleness window as Engine (grad_params up to S
        # epochs old, stacked on the scan carry) — the stack replicates
        # across the mesh. Group sizing (engine.group_len) matters even
        # more here: per-call dispatch moves every sharded plan buffer.
        rep = NamedSharding(self.mesh, P())

        def make_stack(params, s):
            return jax.device_put(jax.tree.map(
                lambda x: jnp.tile(x[None], (s + 1,) + (1,) * x.ndim),
                params), rep)

        def dispatch(mode, stale_on, params, opt_state, history, lrs, flags):
            return multis[mode, stale_on](params, opt_state, history,
                                          self.arrs,
                                          jnp.asarray(lrs, jnp.float32),
                                          jnp.asarray(flags))

        def final_eval(params):
            s = evaluate(params, self.arrs, "val")
            val = float(s[0]) / max(1.0, float(s[2]))
            s = evaluate(params, self.arrs, "test")
            return val, float(s[0]) / max(1.0, float(s[2]))

        return run_group_loop(self, epochs, dispatch, make_stack, final_eval,
                              n_chips=self.mesh.size)

    def profile(self, iters: int = 5) -> dict:
        """Per-stage timing (aggregate / dense / halo exchange / backward),
        the sharded analog of Engine.profile — engine/utils.cpp:139-212
        reports Aggregation/ApplyVertex/Scatter per layer; halo_l*_ms is the
        Scatter-stage analog."""
        from dorylus_tpu.engine.profiling import profile_stages_sharded
        times = profile_stages_sharded(self, iters=iters)
        self.report.stage_times = {
            k: {"total_s": v / 1e3 * iters, "count": iters, "avg_ms": v}
            for k, v in times.items()
        }
        return times

    def output(self, path: Optional[str] = None) -> str:
        if path:
            self.report.write(path)
        return self.report.summary()

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs (V, C) in GLOBAL vertex order
        (shard layout reassembled via global_ids)."""
        if self._compiled is None:
            self._compiled = build_sharded_train_step(
                self.model, self.cfg, self.mesh, self.sharded.denom)
        _, _, predict, _ = self._compiled
        stacked = np.asarray(predict(self.params, self.arrs))  # (n, vp, C)
        out = np.zeros((self.graph.num_vertices, stacked.shape[-1]),
                       np.float32)
        for s, shard in enumerate(self.sharded.shards):
            gids = shard.global_ids[: shard.num_local]
            out[gids] = stacked[s, : shard.num_local]
        if softmax:
            e = np.exp(out - out.max(axis=1, keepdims=True))
            out = e / e.sum(axis=1, keepdims=True)
        return out

    def dump_predictions(self, path: str, softmax: bool = False) -> None:
        """Per-vertex final-layer outputs in GLOBAL vertex order — the
        artifact tools/compare_output.py diffs (same format as
        Engine.dump_predictions)."""
        np.savetxt(path, self.predict(softmax=softmax), fmt="%.6f")
