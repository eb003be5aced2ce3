"""The training engine: epoch driver, evaluation, early stop, reporting.

The single-program analog of Engine::init/run/output (src/graph-server/engine/engine.cpp)
plus the weight-server master's accuracy aggregation and converge state
machine (weightserver.cpp:190-294). The reference's chunked 6-queue pipeline
(engine/ops/pipeline.cpp) exists to overlap Lambda latency with graph-server
compute; under XLA the whole epoch is one fused compiled program, so the
scheduler reduces to a Python epoch loop around a jitted train step —
overlap of communication and compute inside the step is XLA's job (plus
explicit interior/boundary splitting in the sharded path).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.common.logging import log
from dorylus_tpu.common.metrics import EpochRecord, RunReport, StageTimer
from dorylus_tpu.engine.batch import build_batch
from dorylus_tpu.graph.graph import Graph
from dorylus_tpu.models.base import GraphBatch
from dorylus_tpu.models.gat import GAT
from dorylus_tpu.models.gcn import GCN
from dorylus_tpu.ops.activations import accuracy_and_loss, row_softmax
from dorylus_tpu.optim.adam import AdamState, adam_init, adam_update, sgd_update


def _max_agg_width(layers: LayerConfig, cfg: TrainConfig) -> int:
    """Widest feature dim the SpMM will see. GCN with optimize_order
    aggregates at min(in, out) per layer (transform-first when shrinking);
    GAT aggregates z, i.e. the output width."""
    dims = layers.dims
    if cfg.model == "gat":
        return max(dims[1:])
    if cfg.optimize_order:
        return max(min(a, b) for a, b in zip(dims, dims[1:]))
    return max(dims[:-1])


# Auto group size (epochs_per_call=0): bounds how long a compiled call
# runs between progress lines and host-side loss readbacks.
AUTO_GROUP_CAP = 25


def group_len(epoch: int, end: int, cfg: TrainConfig) -> int:
    """Epochs to run in ONE compiled call starting at `epoch`.

    Evaluation no longer breaks groups: per-epoch eval stats are computed
    INSIDE the scanned group under lax.cond flags, so the default
    eval_every=1 still dispatches multi-epoch groups. The exceptions that
    do bound a group: checkpoint boundaries (host-side file IO), an eval
    boundary when target_accuracy early-stopping must inspect it promptly
    (weightserver.cpp:270-294 checks per epoch), and the epochs_per_call
    cap (auto: AUTO_GROUP_CAP). Bounded staleness composes (the
    weight-stash window rides the scan carry)."""
    if epoch >= end:  # empty range: run(0) is a no-op, not a hang
        return 0
    if cfg.epochs_per_call == 1:
        return 1
    cap = cfg.epochs_per_call if cfg.epochs_per_call else AUTO_GROUP_CAP
    k = 1
    while True:
        ep = epoch + k - 1
        if ep == end - 1:
            break
        if (cfg.target_accuracy and cfg.eval_every
                and ep % cfg.eval_every == 0):
            break
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (ep + 1) % cfg.checkpoint_every == 0):
            break
        if k >= cap:
            break
        k += 1
    return k


def eval_flags(epoch: int, k: int, end: int, cfg: TrainConfig) -> np.ndarray:
    """(k,) bool: which epochs of this group evaluate (eval_every cadence
    plus always the final epoch) — data, not shape, so the flag pattern
    never recompiles the group."""
    eps = np.arange(epoch, epoch + k)
    if not cfg.eval_every:
        return np.zeros(k, bool)
    return (eps % cfg.eval_every == 0) | (eps == end - 1)


def run_group_loop(eng, epochs: int, dispatch, make_stack, final_eval,
                   n_chips: int = 1) -> "RunReport":
    """Shared group-scan training driver for Engine and ShardedEngine
    (the Engine::run + pipeline scheduler analog, engine.cpp:223 /
    pipeline.cpp:6): group sizing, LR schedule, in-scan eval flags,
    per-epoch reporting (WS-master lines, weightserver.cpp:258-262),
    checkpointing, the converge state machine (weightserver.cpp:270-294),
    and the final metrics/cost block.

    The engines differ only in how a compiled group is dispatched and how
    params are evaluated, so those come in as callables:
      dispatch(mode, stale_on, params, opt_state, history, lrs, flags)
          -> (params, opt_state, history, loss_arr, stats_arr)
      make_stack(params, s) -> (s+1)-stacked weight history pytree
      final_eval(params) -> (val_accuracy, test_accuracy)
    """
    from dorylus_tpu.engine.convergence import ConvergeMonitor
    from dorylus_tpu.optim.adam import decay_lr

    cfg = eng.cfg
    eng.report.notes["kernel"] = eng.kernel_selected
    t_run = time.perf_counter()

    # Staleness window: history[0] is the (up to S epochs) stale weight
    # version gradients are computed against; sync mode keeps S=0 and
    # ships nothing (None history -> the no-history compiled variants).
    stale = cfg.staleness or 0
    history = make_stack(eng.params, stale) if stale else None
    monitor = ConvergeMonitor(cfg.target_accuracy, cfg.switch_threshold)

    # Resume continues the ORIGINAL epoch numbering: LR schedule and
    # checkpoint steps pick up where the prior run left off. Between
    # eval/checkpoint boundaries, synchronous epochs run as ONE compiled
    # lax.scan call (group_len) — per-call dispatch amortizes.
    epoch = eng.start_epoch
    end = eng.start_epoch + epochs
    first_k = group_len(epoch, end, cfg)
    if first_k > 1:
        log("first %d-epoch group includes compilation — per-epoch "
            "times are warm from the second run on", first_k)
    while epoch < end:
        k = group_len(epoch, end, cfg)
        t0 = time.perf_counter()
        lrs = [(decay_lr(cfg.learning_rate, ep, cfg.lr_decay_every,
                         cfg.lr_decay_factor)
                if cfg.lr_decay_every else cfg.learning_rate)
               for ep in range(epoch, epoch + k)]
        flags = eval_flags(epoch, k, end, cfg)
        mode = "all" if flags.all() else ("none" if not flags.any()
                                          else "mixed")
        (eng.params, eng.opt_state, history, loss_arr,
         stats) = dispatch(mode, stale > 0, eng.params, eng.opt_state,
                           history, lrs, flags)
        # The losses are read on the host, which also waits for the group.
        losses = [float(x) for x in np.asarray(loss_arr)]
        stats = np.asarray(stats)  # (k, 3): correct, loss_sum, count
        dt_ms = 1e3 * (time.perf_counter() - t0) / k
        last_ep = epoch + k - 1
        acc = None
        for i, loss_f in enumerate(losses):
            ep_acc = ep_vloss = None
            if flags[i]:
                ep_acc = float(stats[i, 0]) / max(1.0, float(stats[i, 2]))
                ep_vloss = float(stats[i, 1]) / max(1.0, float(stats[i, 2]))
                acc = ep_acc
                # Per-epoch line like the WS master (weightserver.cpp:258-262).
                log("Epoch %d: %.2f ms, train loss %.4f, val acc %.4f, "
                    "val loss %.4f", epoch + i, dt_ms, loss_f, ep_acc,
                    ep_vloss)
            eng.report.add_epoch(EpochRecord(
                epoch + i, dt_ms, loss=loss_f, accuracy=ep_acc))
        eng._maybe_checkpoint(last_ep)
        # Converge state machine (weightserver.cpp:270-294): EARLY ->
        # CLOSE drains the async window (async->sync switch), DONE stops.
        # With target_accuracy set, group_len breaks at eval boundaries,
        # so the group's last accuracy is inspected promptly.
        was_sync = monitor.synchronous
        monitor.update(acc)
        if monitor.synchronous and not was_sync and stale:
            log("Converge state CLOSE at epoch %d — switching to sync.",
                last_ep)
        if monitor.synchronous and stale:
            # Drain the async window: future gradients use the latest
            # params (drops to the no-history variants; one recompile).
            stale = 0
            history = None
        if monitor.done:
            log("Target accuracy %.3f reached at epoch %d — stopping.",
                cfg.target_accuracy, last_ep)
            break
        epoch += k

    eng.report.notes["converge_state"] = monitor.state.name
    eng.report.total_time_s = time.perf_counter() - t_run
    # Final metrics (Engine::output analog) + chip-second cost accounting
    # (calculate-price.py analog).
    from dorylus_tpu.engine.profiling import report_cost, report_memory
    eng.report.notes["cost"] = report_cost(eng.report.total_time_s,
                                           n_chips=n_chips)
    mem = report_memory()
    if mem:
        eng.report.notes["device_memory"] = mem
    eng.report.final_accuracy, eng.report.test_accuracy = final_eval(
        eng.params)
    return eng.report


class Engine:
    """Single-host engine. For multi-device sharded training see
    dorylus_tpu.parallel.train_step.ShardedEngine (same external surface)."""

    def __init__(self, graph: Graph, layers: LayerConfig, cfg: TrainConfig):
        assert layers.feature_dim == graph.features.shape[1], (
            "feature dim mismatch vs layer config "  # engine/utils.cpp:510
            f"({graph.features.shape[1]} vs {layers.feature_dim})")
        from dorylus_tpu.common.cache import enable_compile_cache
        enable_compile_cache(cfg.compile_cache)
        self.graph = graph
        self.layers = layers
        if cfg.edge_chunk == 0 and graph.num_edges > (1 << 23):
            # Unchunked segment_sum materializes the (|E|, F) message
            # tensor; chunk automatically beyond 8M edges (Amazon/Friendster
            # scale) to bound it at ~2GB for F=128.
            cfg = dataclasses.replace(cfg, edge_chunk=4_000_000)
            log("auto edge_chunk=4M for %d edges", graph.num_edges)
        self.cfg = cfg
        spmm_op = None
        aux = None
        from dorylus_tpu.common.config import resolve_kernel
        kernel = resolve_kernel(cfg.kernel)
        if kernel != cfg.kernel:
            log("kernel auto -> %s", kernel)
            cfg = dataclasses.replace(cfg, kernel=kernel)
            self.cfg = cfg
        self.kernel_selected = kernel
        if cfg.kernel in ("degree", "hyb"):
            gather_dtype = (jnp.bfloat16 if cfg.agg_dtype == "bfloat16"
                            else None)
            reuse_on = cfg.reuse == "pairs" and cfg.kernel == "hyb"
            if reuse_on:
                # Pair-reuse rewrite (graph/reuse.py): both models have
                # unit-weight inner sums (GCN via the rank-1 norm
                # factorization f(src)·f(dst), GAT via dst-only
                # attention), so the rewrite is exact.
                from dorylus_tpu.ops.reuse_spmm import ReuseSpMM
                spmm_op = ReuseSpMM(
                    graph.src, graph.dst,
                    graph.num_vertices, graph.num_vertices,
                    feature_dim=_max_agg_width(layers, cfg),
                    gather_dtype=gather_dtype,
                    rank1_factor=(np.sqrt(graph.self_norm)
                                  if cfg.model == "gcn" else None),
                    passes=cfg.reuse_passes,
                    max_pairs=max(cfg.reuse_max_pairs, 0))
                st = spmm_op.plan_fwd.stats
                log("pair reuse: %d fwd pairs, gathered rows %d -> %d "
                    "(-%.1f%%)", spmm_op.plan_fwd.num_pairs,
                    st["rows_before"], st["rows_after"],
                    100 * st["row_reduction"])
            if not reuse_on:
                if cfg.reuse == "pairs" and cfg.kernel != "hyb":
                    log("pair reuse requires kernel=hyb (have %s) — off",
                        cfg.kernel)
                kw = {}
                if cfg.kernel == "hyb":
                    from dorylus_tpu.ops.hyb_spmm import HybSpMM as OpCls
                    # Neither production model takes the dynamic per-edge
                    # value path (GCN: static norms; GAT: dst-functional),
                    # so the E-sized slot->edge maps need not ship.
                    kw["dynamic"] = False
                else:
                    from dorylus_tpu.ops.degree_spmm import DegreeSpMM as OpCls
                spmm_op = OpCls(graph.src, graph.dst,
                                graph.num_vertices, graph.num_vertices,
                                feature_dim=_max_agg_width(layers, cfg),
                                gather_dtype=gather_dtype,
                                static_val=(graph.edge_norm
                                            if cfg.model == "gcn" else None),
                                **kw)
            aux = {"spmm": spmm_op.arrays}
        self.model = (GCN(layers, edge_chunk=cfg.edge_chunk,
                          optimize_order=cfg.optimize_order, spmm_op=spmm_op)
                      if cfg.model == "gcn"
                      else GAT(layers, edge_chunk=cfg.edge_chunk,
                               spmm_op=spmm_op))
        # The production kernel paths never read the E-sized COO triple
        # at runtime (GCN: static plan vals; GAT: dst-functional) — skip
        # uploading it. profile() rebuilds a full batch on demand.
        self._edge_arrays_stubbed = (
            spmm_op is not None
            and (spmm_op.has_static_vals if cfg.model == "gcn"
                 else hasattr(spmm_op, "apply_dst")))
        self.batch = build_batch(graph, for_gat=cfg.model == "gat",
                                 edge_arrays=not self._edge_arrays_stubbed)
        if aux is not None:
            # Aux arrays ride the batch pytree into jit as arguments —
            # never as closure constants (they are megabytes of metadata).
            self.batch = self.batch._replace(aux=aux)
        if cfg.kernel == "hyb":
            # Capacity model: fit the msgs chunk guard to the device
            # memory left after the static footprint (plans + features +
            # labels) and the per-layer table/out/grad transients. The
            # guard is ENGINE-scoped: it rides this op's static tuple
            # (set_msgs_budget), so other engines/ops in the process keep
            # their own.
            from dorylus_tpu.ops.hyb_spmm import fit_msgs_budget, tree_nbytes
            width = _max_agg_width(layers, cfg)
            transients = graph.num_vertices * width * 12  # bf16 tbl + f32 out/gout
            spmm_op.set_msgs_budget(
                fit_msgs_budget(tree_nbytes(self.batch), transients, log))
        self.params = self.model.init_params(seed=cfg.seed)
        self.opt_state = adam_init(self.params) if cfg.adam else None
        self.report = RunReport()
        self._compiled = None
        self.start_epoch = 0
        if cfg.resume and cfg.checkpoint_dir:
            from dorylus_tpu.engine.checkpoint import latest_checkpoint, load_checkpoint
            path = latest_checkpoint(cfg.checkpoint_dir)
            if path is not None:
                ck = load_checkpoint(path)
                self.params = jax.tree.map(jnp.asarray, ck["params"])
                if ck["opt_state"] is not None and cfg.adam:
                    self.opt_state = jax.tree.map(jnp.asarray, ck["opt_state"])
                self.start_epoch = int(ck["step"])
                log("resumed from %s (epoch %d)", path, self.start_epoch)

    def _maybe_checkpoint(self, epoch: int) -> None:
        cfg = self.cfg
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (epoch + 1) % cfg.checkpoint_every == 0):
            from dorylus_tpu.engine.checkpoint import save_checkpoint
            save_checkpoint(cfg.checkpoint_dir, epoch + 1, self.params,
                            self.opt_state)

    # ---- compiled steps ----

    def _make_step(self):
        model, cfg = self.model, self.cfg
        compute_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32

        def loss_fn(params, batch: GraphBatch):
            return model.loss(params, batch, compute_dtype=compute_dtype)

        # Multi-epoch compiled group: K epochs inside ONE jitted lax.scan
        # call over the per-epoch lr schedule (cfg.epochs_per_call) — one
        # dispatch and one host readback per group.
        #
        # Bounded staleness (the reference's async pipeline,
        # pipeline.cpp:95-102 + weight stashing weighttensor.cpp:80-123)
        # is carried IN-GRAPH: `history` is the param pytree stacked
        # (S+1, ...) with history[0] the stale version gradients are
        # computed against; each epoch rolls the window. A stack
        # initialized with S+1 copies of the start params reproduces the
        # growing-deque semantics exactly; S=0 degenerates to synchronous
        # training (grad at current params) with zero overhead.
        # In-group evaluation: flagged epochs run the f32 eval forward on
        # the just-updated params, so eval cadence no longer has to break
        # the compiled group (round-2 weak spot: the default eval_every=1
        # forced 1-epoch groups). The flag PATTERN is host-known per
        # group, so three variants compile lazily instead of one
        # lax.cond body: "none" (no eval in the body at all), "all"
        # (eval inlined, no conditional), "mixed" (lax.cond). A runtime
        # cond puts the hyb kernel's many bucket kernels inside a nested
        # HLO computation, where they schedule poorly, while all-False
        # groups are the bench/headline path — the variants make both
        # cond-free.
        # Second variant axis: synchronous training (staleness 0, the
        # default) carries NO history at all — grads at current params,
        # no (1, ...) stack roll per epoch. The stack roll is an extra
        # full param copy + concat per epoch that XLA does not elide.
        def make_multi(eval_mode: str, with_history: bool):
            def multi_step(params, opt_state, history, batch, lrs, flags):
                def val_stats(params):
                    probs = row_softmax(model.forward(params, batch))
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
                    loss, grads = jax.value_and_grad(loss_fn)(grad_params,
                                                              batch)
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
                    carry = ((params, opt_state, history) if with_history
                             else (params, opt_state))
                    return carry, (loss, stats)

                carry = ((params, opt_state, history) if with_history
                         else (params, opt_state))
                carry, (losses, stats) = jax.lax.scan(body, carry,
                                                      (lrs, flags))
                if with_history:
                    params, opt_state, history = carry
                else:
                    params, opt_state = carry
                return params, opt_state, history, losses, stats

            if with_history:
                return jax.jit(multi_step, donate_argnums=(1, 2))
            # history passes through untouched — donating it would
            # invalidate the caller's (live) S=0 stack.
            return jax.jit(multi_step, donate_argnums=(1,))

        multis = {(mode, h): make_multi(mode, h)
                  for mode in ("none", "all", "mixed")
                  for h in (True, False)}

        def evaluate(params, batch, mask):
            probs = row_softmax(model.forward(params, batch))
            return accuracy_and_loss(probs, batch.onehot, mask)

        return (multis, jax.jit(evaluate))

    # ---- run loop (Engine::run + pipeline scheduler analog) ----

    def run(self, epochs: Optional[int] = None) -> RunReport:
        epochs = epochs if epochs is not None else self.cfg.epochs
        if self._compiled is None:
            self._compiled = self._make_step()
        multis, evaluate = self._compiled

        # Staleness history: the (S+1)-stack rides the compiled scan (see
        # _make_step); sync (S=0) ships None — the no-history variants.
        def make_stack(params, s):
            return jax.tree.map(
                lambda x: jnp.tile(x[None], (s + 1,) + (1,) * x.ndim), params)

        def dispatch(mode, stale_on, params, opt_state, history, lrs, flags):
            return multis[mode, stale_on](params, opt_state, history,
                                          self.batch,
                                          jnp.asarray(lrs, jnp.float32),
                                          jnp.asarray(flags))

        def final_eval(params):
            c, _, n = evaluate(params, self.batch, self.batch.val_mask)
            val = float(c) / max(1.0, float(n))
            c, _, n = evaluate(params, self.batch, self.batch.test_mask)
            return val, float(c) / max(1.0, float(n))

        return run_group_loop(self, epochs, dispatch, make_stack, final_eval)

    def profile(self, iters: int = 5) -> dict:
        """Per-stage timing report (engine/utils.cpp:139-291 analog);
        results also land in report.stage_times."""
        from dorylus_tpu.engine.profiling import profile_stages
        batch = self.batch
        if getattr(self, "_edge_arrays_stubbed", False):
            # The training batch ships COO stubs (see __init__); the
            # profiler's edgewise brackets need the real arrays.
            from dorylus_tpu.engine.batch import build_batch
            batch = build_batch(self.graph,
                                for_gat=self.cfg.model == "gat"
                                )._replace(aux=self.batch.aux)
        times = profile_stages(self.model, self.params, batch, iters=iters)
        self.report.stage_times = {
            k: {"total_s": v / 1e3 * iters, "count": iters, "avg_ms": v}
            for k, v in times.items()
        }
        return times

    def output(self, path: Optional[str] = None) -> str:
        """Write/return the final report (analog of output_<node>,
        engine/utils.cpp:109-212)."""
        if path:
            self.report.write(path)
        return self.report.summary()

    def predict(self, softmax: bool = False) -> np.ndarray:
        """Per-vertex final-layer outputs, (V, C): raw logits by default,
        softmax rows if asked."""
        out = (self.model.predict(self.params, self.batch) if softmax
               else self.model.forward(self.params, self.batch))
        return np.asarray(out)

    def dump_predictions(self, path: str, softmax: bool = False) -> None:
        """Write per-vertex final-layer outputs, one line per vertex — the
        artifact miscs/compare_output.py diffs between runs (its line-sum
        metric needs raw logits; softmax rows always sum to 1)."""
        np.savetxt(path, self.predict(softmax=softmax), fmt="%.6f")
