"""Start-up check on NVIDIA GPUs: the main training path at full width.

    python chip_smoke.py               # phases a-c on one card
    python chip_smoke.py --four-cards  # phase d only, on four cards

Phases (one process; any failing phase makes the exit code non-zero):

  a. Training through `Engine` at the Reddit shape (602-128-41,
     |V| = 232,965, ~11.6M directed edges, ascending-degree renumbering):
     GCN and GAT, f32 and bf16 aggregation tables, the kernel
     kernel="auto" picks (hyb), 3 epochs each; finite losses. Prints the step's compiled memory analysis and,
     as information only, warm epoch times.
  b. The hyb, degree and xla SpMM forwards and VJPs at F = 128 against a
     float64 scipy CSR product (A @ h, and A^T @ g for the gradient).
  c. The first-epoch GCN logits and loss at full size against a float64
     host forward, under "highest" matmul precision and under the default
     one (TF32 on the card), with bounds that tell the two apart.
  d. (--four-cards) ShardedEngine GCN and GAT with kernel="hyb" over four
     cards, padded and ragged halos, against single-device Engine; and one
     2x2 feat_shards=2 GCN step.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

REDDIT_VERTICES = 232_965
REDDIT_DEGREE = 50
DIMS = [602, 128, 41]
HIDDEN = 128
EPOCHS = 3
GAT_LR = 0.005

# f32 tables under "highest": every term is an f32 product summed in f32,
# so the kernels agree with the float64 product to a few f32 ulps of the
# largest output; 1e-5 leaves two orders of magnitude of room.
RTOL_F32 = 1e-5
# bf16 tables: the table (and, for GCN, the baked edge weight) is rounded
# to 8 significant bits (unit roundoff 2^-9 ~ 2e-3) before an f32 sum;
# independent roundings keep the normwise error near that. Bound: 1e-2.
NORMWISE_BF16 = 1e-2
# Phase c compares the logits (normwise) and the first-epoch loss with a
# float64 forward. Under "highest" the forward is f32 throughout: logits
# to ~1e-7, bound 1e-5 for both. Under the default precision an f32
# matmul may run in TF32 on the card (10 explicit mantissa bits, unit
# roundoff 2^-11 ~ 5e-4 on each rounded operand): the logits then carry
# ~1e-3 normwise error from the two layers' matmuls, which the "highest"
# bound rejects; bound 1e-2. The loss is a mean of per-row cross-entropies
# whose logit errors have random sign, so it stays near the roundoff;
# bound 4x the roundoff.
NORMWISE_LOGITS_HIGHEST = 1e-5
NORMWISE_LOGITS_DEFAULT = 1e-2
RTOL_LOSS_HIGHEST = 1e-5
RTOL_LOSS_DEFAULT = 2e-3
# Sharded against single-device training, both under "highest": the two
# sum in different orders; the virtual CPU mesh agrees to ~1e-5.
RTOL_SHARDED = 1e-4


def reddit_graph(num_vertices=REDDIT_VERTICES, avg_degree=REDDIT_DEGREE,
                 seed=1):
    """The Reddit-shaped graph of bench.py, renumbered by ascending degree
    (the production preprocessing for the hyb kernel)."""
    from dorylus_tpu.graph.graph import random_graph
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    g = random_graph(num_vertices, avg_degree, DIMS[0], DIMS[-1], seed=seed)
    return apply_order(g, degree_order(g, ascending=True))


# ---- float64 host references (scipy / numpy; no JAX) ----


def host_adjacency(g, self_loops: bool = False, weighted: bool = True):
    """CSR (dst, src) adjacency in float64: GCN norms (plus the self-loop
    norms on the diagonal when self_loops) or unit weights."""
    import scipy.sparse as sp

    v = g.num_vertices
    val = (np.asarray(g.edge_norm, np.float64) if weighted
           else np.ones(g.num_edges))
    a = sp.csr_matrix((val, (g.dst, g.src)), shape=(v, v))
    if self_loops:
        a = a + sp.diags(np.asarray(g.self_norm, np.float64))
    return a.tocsr()


def host_gcn_forward(g, weights):
    """Dorylus GCN forward (S = D~^-1/2 (A+I) D~^-1/2, tanh hidden layers)
    in float64: (logits, masked cross-entropy over the train split /
    (|V| * 0.66))."""
    from dorylus_tpu.common.config import TRAIN_PORTION

    s = host_adjacency(g, self_loops=True)
    h = np.asarray(g.features, np.float64)
    for i, w in enumerate(weights):
        z = s @ (h @ np.asarray(w, np.float64))  # == (S h) W
        h = np.tanh(z) if i < len(weights) - 1 else z
    z = h - h.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    train, _, _ = g.masks()
    rows = np.flatnonzero(train)
    nll = -logp[rows, np.asarray(g.labels)[rows]].sum()
    return h, float(nll / (g.num_vertices * TRAIN_PORTION))


# ---- phases ----


def _check_close(tag, got, want, rtol=None, normwise=None):
    got = np.asarray(got, np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"  {tag}: normwise rel err {rel:.3e}", flush=True)
    if normwise is not None:
        assert rel <= normwise, f"{tag}: {rel:.3e} > {normwise:g}"
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(),
                                   err_msg=tag)


def phase_train(g, card: str) -> None:
    """a. Engine training: GCN/GAT x f32/bf16 tables, kernel auto."""
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine

    layers = LayerConfig(DIMS)
    for model in ("gcn", "gat"):
        for agg in ("float32", "bfloat16"):
            cfg = TrainConfig(model=model, epochs=EPOCHS, eval_every=0,
                              agg_dtype=agg,
                              learning_rate=GAT_LR if model == "gat"
                              else 0.01)
            tag = f"{model} agg={agg}"
            t0 = time.perf_counter()
            eng = Engine(g, layers, cfg)
            rep = eng.run(EPOCHS)  # compiles; a second run is warm
            rep = eng.run(EPOCHS)
            losses = [e.loss for e in rep.epochs]
            assert np.isfinite(losses).all(), (tag, losses)
            # The engine's compiled K-epoch step (sync, no in-group eval).
            step = eng._compiled[0]["none", False]
            mem = step.lower(eng.params, eng.opt_state, None, eng.batch,
                             jnp.zeros(EPOCHS, jnp.float32),
                             jnp.zeros(EPOCHS, bool)).compile()
            print(f"phase a: {tag} kernel={eng.kernel_selected} "
                  f"losses={[round(x, 4) for x in losses]} "
                  f"({time.perf_counter() - t0:.1f} s with set-up)",
                  flush=True)
            print(f"  memory_analysis: {mem.memory_analysis()}", flush=True)
            warm = [round(e.time_ms, 2) for e in rep.epochs[-EPOCHS:]]
            print(f"  warm epoch ms (information only, {card}): {warm}",
                  flush=True)
            del eng, step, mem
            jax.clear_caches()


def phase_kernels(g) -> None:
    """b. hyb / degree / xla SpMM forward + VJP against scipy float64."""
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu.ops.hyb_spmm import HybSpMM
    from dorylus_tpu.ops.spmm import spmm_edgewise

    v = g.num_vertices
    rng = np.random.default_rng(0)
    h = rng.normal(size=(v, HIDDEN)).astype(np.float32)
    cot = rng.normal(size=(v, HIDDEN)).astype(np.float32)
    dst_val = rng.normal(size=v).astype(np.float32)
    a = host_adjacency(g)
    a_unit = host_adjacency(g, weighted=False)
    h64, cot64 = h.astype(np.float64), cot.astype(np.float64)
    want = {"static": (a @ h64, a.T @ cot64),
            "dst": (dst_val[:, None] * (a_unit @ h64),
                    a_unit.T @ (dst_val[:, None] * cot64))}
    hj, cj, dj = jnp.asarray(h), jnp.asarray(cot), jnp.asarray(dst_val)

    def fwd_vjp(apply):
        @jax.jit
        def run(arrs, x, c):
            out, vjp = jax.vjp(lambda x: apply(arrs, x), x)
            return out, vjp(c)[0]
        return run

    with jax.default_matmul_precision("highest"):
        for name, cls in (("hyb", HybSpMM), ("degree", DegreeSpMM)):
            for gd in (None, jnp.bfloat16):
                op = cls(g.src, g.dst, v, v, feature_dim=HIDDEN,
                         gather_dtype=gd, static_val=g.edge_norm)
                out, dh = fwd_vjp(op.apply_static)(op.arrays, hj, cj)
                tag = f"phase b: {name} {'bf16' if gd else 'f32'}"
                kw = ({"normwise": NORMWISE_BF16} if gd
                      else {"rtol": RTOL_F32})
                _check_close(f"{tag} fwd", out, want["static"][0], **kw)
                _check_close(f"{tag} vjp", dh, want["static"][1], **kw)
                del op, out, dh
        # The GAT path: dst-functional attention weights on the hyb kernel.
        op = HybSpMM(g.src, g.dst, v, v, feature_dim=HIDDEN, dynamic=False)
        out, dh = fwd_vjp(lambda arrs, x: op.apply_dst(arrs, x, dj))(
            op.arrays, hj, cj)
        _check_close("phase b: hyb dst f32 fwd", out, want["dst"][0],
                     rtol=RTOL_F32)
        _check_close("phase b: hyb dst f32 vjp", dh, want["dst"][1],
                     rtol=RTOL_F32)
        del op
        # xla: edgewise segment_sum, chunked as the engine runs it here.
        src, dst, val = (jnp.asarray(g.src), jnp.asarray(g.dst),
                         jnp.asarray(g.edge_norm))
        chunk = 4_000_000 if g.num_edges > (1 << 23) else 0
        out, dh = fwd_vjp(lambda arrs, x: spmm_edgewise(
            x, *arrs, v, sorted_dst=True, edge_chunk=chunk))(
                (src, dst, val), hj, cj)
        _check_close("phase b: xla f32 fwd", out, want["static"][0],
                     rtol=RTOL_F32)
        _check_close("phase b: xla f32 vjp", dh, want["static"][1],
                     rtol=RTOL_F32)
    jax.clear_caches()


def phase_loss(g) -> None:
    """c. First-epoch GCN logits and loss (at the initial weights, through
    the engine's model and batch) against the float64 host forward, under
    "highest" and under the default precision."""
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine

    eng = Engine(g, LayerConfig(DIMS), TrainConfig(epochs=1, eval_every=0))
    ref_logits, ref = host_gcn_forward(
        g, [np.asarray(eng.params[f"w{i}"]) for i in range(len(DIMS) - 1)])
    x = np.random.default_rng(2).normal(size=(1024, 1024)).astype(np.float32)
    prod = np.asarray(jax.jit(jnp.dot)(x, x), np.float64)
    exact = x.astype(np.float64) @ x.astype(np.float64)
    mm_err = np.abs(prod - exact).max() / np.abs(exact).max()
    tf32 = mm_err > 1e-5
    print(f"phase c: f32 matmul at default precision: max rel err "
          f"{mm_err:.2e} ({'TF32' if tf32 else 'full f32'})", flush=True)
    v = g.num_vertices
    err = {}
    for prec, bound, rtol in (
            ("highest", NORMWISE_LOGITS_HIGHEST, RTOL_LOSS_HIGHEST),
            (None, NORMWISE_LOGITS_DEFAULT, RTOL_LOSS_DEFAULT)):
        with jax.default_matmul_precision(prec):
            # Fresh functions: each precision traces and compiles its own.
            logits = jax.jit(lambda p, b: eng.model.forward(p, b))(
                eng.params, eng.batch)
            loss = float(jax.jit(lambda p, b: eng.model.loss(p, b))(
                eng.params, eng.batch))
        logits = np.asarray(logits, np.float64)[:v]
        err[prec] = (np.linalg.norm(logits - ref_logits)
                     / np.linalg.norm(ref_logits))
        rel = abs(loss - ref) / abs(ref)
        name = prec or "default"
        print(f"phase c: precision={name} logits normwise rel err "
              f"{err[prec]:.2e} (bound {bound:g}); loss {loss:.7f} vs "
              f"float64 {ref:.7f}: rel err {rel:.2e} (bound {rtol:g})",
              flush=True)
        assert err[prec] <= bound, (name, err[prec])
        assert rel <= rtol, (name, loss, ref)
    if tf32:
        # The "highest" bound must tell a TF32 forward from an f32 one.
        assert err[None] > NORMWISE_LOGITS_HIGHEST, err
    jax.clear_caches()


def phase_four_cards(g, devices) -> bool:
    """d. ShardedEngine over four devices against single-device Engine,
    all under "highest"; padded and ragged halos; one 2x2 TP GCN step.
    Returns whether lax.ragged_all_to_all lowered on this mesh."""
    import jax

    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.parallel.halo import RaggedHaloUnavailable
    from dorylus_tpu.parallel.mesh import make_mesh
    from dorylus_tpu.parallel.train_step import ShardedEngine

    layers = LayerConfig(DIMS)
    mesh = make_mesh(4, devices=devices[:4])  # flat: 4 graph shards
    ragged_ok = True
    ref_first = {}
    with jax.default_matmul_precision("highest"):
        for model in ("gcn", "gat"):
            kw = dict(model=model, epochs=EPOCHS, eval_every=0, kernel="hyb",
                      learning_rate=GAT_LR if model == "gat" else 0.01)
            ref = [e.loss for e in
                   Engine(g, layers, TrainConfig(**kw)).run().epochs]
            ref_first[model] = ref[0]
            print(f"phase d: {model} single-device {np.round(ref, 5)}",
                  flush=True)
            for halo in ("padded", "ragged"):
                try:
                    eng = ShardedEngine(g, layers,
                                        TrainConfig(**kw, halo=halo),
                                        mesh=mesh)
                except RaggedHaloUnavailable as e:
                    print(f"phase d: {model} halo={halo}: {e}", flush=True)
                    ragged_ok = False
                    continue
                got = [e.loss for e in eng.run().epochs]
                print(f"phase d: {model} halo={halo} 4 shards "
                      f"{np.round(got, 5)}", flush=True)
                np.testing.assert_allclose(got, ref, rtol=RTOL_SHARDED,
                                           err_msg=f"{model} {halo}")
                del eng
                jax.clear_caches()
        tp = ShardedEngine(
            g, layers,
            TrainConfig(epochs=1, eval_every=0, kernel="hyb", feat_shards=2),
            mesh=make_mesh(2, feat_shards=2, devices=devices[:4]))
        got = tp.run().epochs[0].loss
        print(f"phase d: gcn 2x2 feat_shards=2 first loss {got:.6f} vs "
              f"single-device {ref_first['gcn']:.6f}", flush=True)
        np.testing.assert_allclose(got, ref_first["gcn"], rtol=RTOL_SHARDED)
    print(f"phase d: ragged_all_to_all "
          f"{'lowered and matched' if ragged_ok else 'did not lower'}",
          flush=True)
    return ragged_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase d, over four cards")
    args = ap.parse_args(argv)

    import jax

    from dorylus_tpu.common.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    card = gpu_name_and_power_limit()
    print(f"card: {card}", flush=True)
    devices = jax.devices()
    if args.four_cards and len(devices) < 4:
        print(f"--four-cards needs 4 devices, have {len(devices)}",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    g = reddit_graph()
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.four_cards:
        phases = [("d", lambda: phase_four_cards(g, devices))]
    else:
        phases = [("a", lambda: phase_train(g, card)),
                  ("b", lambda: phase_kernels(g)),
                  ("c", lambda: phase_loss(g))]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
