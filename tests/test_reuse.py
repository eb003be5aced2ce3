"""Pair-reuse mining (graph/reuse.py): exactness and profitability.

The rewrite must compute EXACTLY the same unit-weight aggregation
operator: for any h, aggregating the rewritten edge list over the
pair-augmented table equals aggregating the original edges. Verified
against a dense numpy operator (the oracle style of tests/oracle.py)."""

import numpy as np
import pytest

from dorylus_tpu.graph.reuse import mine_reuse


def clustered_graph(num_vertices=600, communities=20, deg=12, seed=0):
    """Community graph with heavy neighbor-list overlap (each community
    draws neighbors from a small popular core) — the real-graph shape
    where pair reuse pays."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, communities, size=num_vertices)
    members = [np.flatnonzero(comm == c) for c in range(communities)]
    srcs, dsts = [], []
    for v in range(num_vertices):
        pool = members[comm[v]]
        core = pool[: max(2, len(pool) // 3)]  # popular core
        n = rng.choice(core, size=min(deg, len(core)), replace=False)
        srcs.append(n)
        dsts.append(np.full(len(n), v))
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def dense_unit(src, dst, v):
    a = np.zeros((v, v), np.float64)
    np.add.at(a, (dst, src), 1.0)
    return a


def apply_rewritten(plan, h):
    tbl = plan.build_table_np(h.astype(np.float64))
    out = np.zeros((plan.num_vertices, h.shape[1]), np.float64)
    np.add.at(out, plan.dst, tbl[plan.src])
    return out


@pytest.mark.parametrize("passes", [1, 2])
def test_rewrite_exact(passes):
    src, dst = clustered_graph()
    v = 600
    plan = mine_reuse(src, dst, v, min_uses=3, passes=passes)
    assert plan.num_pairs > 0, "clustered graph must yield pairs"
    h = np.random.default_rng(1).normal(size=(v, 7))
    want = dense_unit(src, dst, v) @ h
    got = apply_rewritten(plan, h)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_rows_strictly_reduced():
    src, dst = clustered_graph()
    plan = mine_reuse(src, dst, 600, min_uses=3)
    # Gathered rows = rewritten edges + 2 per pair for the build gather.
    assert plan.stats["rows_after"] < plan.stats["rows_before"]
    assert plan.stats["row_reduction"] > 0.15  # heavy-overlap graph
    # Every level's pair ids stay within the table built so far.
    size = plan.num_vertices
    for lvl in plan.levels:
        assert lvl.max() < size
        size += len(lvl)
    assert size == plan.table_size
    assert plan.src.max() < plan.table_size
    # CSC order preserved for the plan builders downstream.
    assert (np.diff(plan.dst) >= 0).all()


def test_random_graph_no_pairs_is_identity():
    """A uniform random graph has ~no repeated pairs; the rewrite must
    degrade gracefully to the original edge list."""
    rng = np.random.default_rng(2)
    v, e = 2000, 16000
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    plan = mine_reuse(src, dst, v, min_uses=4)
    h = rng.normal(size=(v, 5))
    np.testing.assert_allclose(apply_rewritten(plan, h),
                               dense_unit(src, dst, v) @ h,
                               rtol=1e-12, atol=1e-12)
    assert plan.stats["rows_after"] <= e + 2 * plan.num_pairs


def test_duplicate_edges_and_empty():
    # Duplicate (src, dst) edges double-count, including inside pairs.
    src = np.array([1, 1, 1, 1, 1, 1], np.int32)
    dst = np.array([0, 0, 2, 2, 3, 3], np.int32)
    plan = mine_reuse(src, dst, 4, min_uses=3)
    h = np.arange(8, dtype=np.float64).reshape(4, 2) + 1
    np.testing.assert_allclose(apply_rewritten(plan, h),
                               dense_unit(src, dst, 4) @ h)
    empty = mine_reuse(np.zeros(0, np.int32), np.zeros(0, np.int32), 3)
    assert empty.num_pairs == 0 and len(empty.src) == 0


def _overlap_graph_obj():
    from dorylus_tpu.graph.graph import Graph
    src, dst = clustered_graph(num_vertices=800, communities=16, deg=14,
                               seed=3)
    rng = np.random.default_rng(4)
    labels = ((np.arange(800) * 5) // 800).astype(np.int32)
    feats = rng.normal(0, 1, size=(800, 24)).astype(np.float32)
    feats += 0.6 * rng.normal(0, 1, size=(5, 24)).astype(np.float32)[labels]
    g = Graph(num_vertices=800, src=src, dst=dst, features=feats,
              labels=labels, num_classes=5)
    return g.finalize()


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_engine_reuse_matches_plain(model, lr):
    """kernel=hyb with --reuse pairs trains to the same trajectory as
    plain hyb (the rewrite is exact; only fp reassociation differs)."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine

    g = _overlap_graph_obj()
    layers = LayerConfig([24, 12, 5])
    kw = dict(model=model, learning_rate=lr, epochs=6, eval_every=0,
              kernel="hyb")
    rep0 = Engine(g, layers, TrainConfig(**kw)).run()
    eng1 = Engine(g, layers, TrainConfig(reuse="pairs", **kw))
    assert eng1.model.spmm_op.plan_fwd.num_pairs > 0
    rep1 = eng1.run()
    l0 = np.array([e.loss for e in rep0.epochs])
    l1 = np.array([e.loss for e in rep1.epochs])
    np.testing.assert_allclose(l1, l0, rtol=2e-3, atol=2e-3)


def test_community_core_edges_mines_pairs():
    """The packaged benchmark generator (graph/graph.py) must produce the
    overlap-heavy shape pair mining targets, in CSC order, and the mined
    rewrite must stay exact on it."""
    from dorylus_tpu.graph.graph import community_core_edges

    src, dst = community_core_edges(4000, 10, comm=200, core=30, seed=5)
    assert (np.diff(dst) >= 0).all() and (src != dst).all()
    plan = mine_reuse(src, dst, 4000, min_uses=3)
    assert plan.stats["row_reduction"] > 0.10
    h = np.random.default_rng(6).normal(size=(4000, 3))
    np.testing.assert_allclose(apply_rewritten(plan, h),
                               dense_unit(src, dst, 4000) @ h,
                               rtol=1e-12, atol=1e-12)


def test_max_pairs_budget_respected_and_exact():
    """mine_reuse(max_pairs=k) keeps at most k (highest-count) pairs per
    pass and the capped rewrite stays exact."""
    src, dst = clustered_graph()
    full = mine_reuse(src, dst, 600, min_uses=3)
    assert full.num_pairs > 8
    k = max(1, full.num_pairs // 4)
    capped = mine_reuse(src, dst, 600, min_uses=3, max_pairs=k)
    assert 0 < capped.num_pairs <= k
    # The budget keeps the most-used pairs: per-row savings must not drop
    # proportionally faster than the pair count.
    h = np.random.default_rng(7).normal(size=(600, 4))
    np.testing.assert_allclose(apply_rewritten(capped, h),
                               dense_unit(src, dst, 600) @ h,
                               rtol=1e-12, atol=1e-12)


def test_engine_auto_budget_below_cliff():
    """The pair budget: the default (reuse_max_pairs=0) mines without a
    cap; an explicit budget is honored and the engine trains."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.ops.reuse_spmm import ReuseSpMM

    g = _overlap_graph_obj()
    layers = LayerConfig([24, 12, 5])
    eng = Engine(g, layers, TrainConfig(reuse="pairs", kernel="hyb",
                                        epochs=1, eval_every=0))
    assert isinstance(eng.model.spmm_op, ReuseSpMM)
    assert eng.model.spmm_op.plan_fwd.num_pairs > 50
    eng2 = Engine(g, layers, TrainConfig(reuse="pairs", kernel="hyb",
                                         epochs=1, eval_every=0,
                                         reuse_max_pairs=50))
    assert isinstance(eng2.model.spmm_op, ReuseSpMM)
    assert 0 < eng2.model.spmm_op.plan_fwd.num_pairs <= 50
    rep = eng2.run()
    assert np.isfinite(rep.epochs[-1].loss)


def test_engine_reuse_requires_hyb_falls_back():
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine

    g = _overlap_graph_obj()
    eng = Engine(g, LayerConfig([24, 12, 5]),
                 TrainConfig(reuse="pairs", kernel="degree", epochs=1,
                             eval_every=0))
    from dorylus_tpu.ops.degree_spmm import DegreeSpMM
    assert isinstance(eng.model.spmm_op, DegreeSpMM)  # graceful fallback


def test_numpy_miner_zero_pairs_returns_sorted(monkeypatch):
    """Round-4 review regression: _mine_one's zero-pair early returns
    handed back the dst-UNSORTED input, violating build_hyb_plan's CSC
    requirement and silently corrupting gradients when one direction
    mined nothing (the native miner always sorts). Both miners must
    return dst-ascending output in every case."""
    from dorylus_tpu import native
    from dorylus_tpu.graph import reuse as reuse_mod

    rng = np.random.default_rng(0)
    # A random sparse graph mines ~no pairs; present it UNSORTED.
    src = rng.integers(0, 50, 120).astype(np.int32)
    dst = rng.integers(0, 50, 120).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    perm = rng.permutation(len(src))
    src, dst = src[perm], dst[perm]
    for miner in (reuse_mod._mine_one,
                  native.mine_pairs_native if native.has_mine_pairs()
                  else reuse_mod._mine_one):
        pairs, s2, d2, _ = miner(src, dst, 50, 30, 0)  # min_uses 30: none
        assert len(pairs) == 0
        assert (np.diff(d2) >= 0).all(), "early return must be CSC-sorted"
        # Same multiset of edges.
        a = np.sort(s2.astype(np.int64) * 64 + d2)
        b = np.sort(src.astype(np.int64) * 64 + dst)
        np.testing.assert_array_equal(a, b)


def test_auto_budget_per_pass_and_zero_disable():
    """max_pairs caps EACH mining pass (mine_reuse), and 0 means no cap."""
    src, dst = clustered_graph()
    unlimited = mine_reuse(src, dst, 600, min_uses=3, passes=2, max_pairs=0)
    capped = mine_reuse(src, dst, 600, min_uses=3, passes=2, max_pairs=40)
    per_pass = [len(lvl) for lvl in capped.levels]
    assert per_pass and all(0 < n <= 40 for n in per_pass)
    assert capped.num_pairs == sum(per_pass)
    assert unlimited.num_pairs > capped.num_pairs
    h = np.random.default_rng(2).normal(size=(600, 3))
    np.testing.assert_allclose(apply_rewritten(capped, h),
                               dense_unit(src, dst, 600) @ h,
                               rtol=1e-12, atol=1e-12)


def test_reuse_auto_engages_and_falls_back():
    """reuse='pairs' keeps the exact rewrite on an overlap-heavy graph and
    on a uniform-random one (which mines ~nothing): either way the
    trajectory equals plain hyb's (exactness)."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph
    from dorylus_tpu.ops.hyb_spmm import HybSpMM
    from dorylus_tpu.ops.reuse_spmm import ReuseSpMM

    layers = LayerConfig([24, 12, 5])
    kw = dict(epochs=4, eval_every=0, kernel="hyb")
    rnd = synthetic_graph(400, 6, 24, 5, seed=11)
    for g in (_overlap_graph_obj(), rnd):
        eng = Engine(g, layers, TrainConfig(reuse="pairs", **kw))
        assert isinstance(eng.model.spmm_op, ReuseSpMM)
        r_pairs = eng.run()
        eng_off = Engine(g, layers, TrainConfig(reuse="off", **kw))
        assert isinstance(eng_off.model.spmm_op, HybSpMM)
        r_off = eng_off.run()
        np.testing.assert_allclose(
            [e.loss for e in r_pairs.epochs], [e.loss for e in r_off.epochs],
            rtol=2e-3, atol=2e-3)
    assert eng.model.spmm_op.plan_fwd.stats["row_reduction"] < 0.10


def test_reuse_auto_payoff_gate_both_directions(monkeypatch):
    """Reuse is opt-in: the default config never mines — asserted by
    making mine_reuse explode — for GCN and GAT, on one device and
    sharded; reuse='pairs' mines for both models."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.ops.hyb_spmm import HybSpMM
    from dorylus_tpu.ops.reuse_spmm import ReuseSpMM
    from dorylus_tpu.parallel import ShardedEngine, make_mesh

    g = _overlap_graph_obj()
    layers = LayerConfig([24, 12, 5])
    assert TrainConfig().reuse == "off"

    import dorylus_tpu.ops.reuse_sharded as rsh_mod
    import dorylus_tpu.ops.reuse_spmm as rs_mod

    def boom(*a, **k):
        raise AssertionError("the default config must not mine")

    monkeypatch.setattr(rs_mod, "mine_reuse", boom)
    monkeypatch.setattr(rsh_mod, "mine_reuse", boom)
    for model in ("gcn", "gat"):
        cfg = TrainConfig(model=model, kernel="hyb", epochs=10_000,
                          eval_every=0)
        assert isinstance(Engine(g, layers, cfg).model.spmm_op, HybSpMM)
        eng = ShardedEngine(g, layers, cfg, mesh=make_mesh(2))
        assert not isinstance(eng.model.spmm_op,
                              rsh_mod.ShardedReuseSpMM)
    monkeypatch.undo()

    for model in ("gcn", "gat"):
        eng = Engine(g, layers, TrainConfig(model=model, kernel="hyb",
                                            reuse="pairs", epochs=1,
                                            eval_every=0))
        assert isinstance(eng.model.spmm_op, ReuseSpMM)
        assert eng.model.spmm_op.plan_fwd.num_pairs > 0


def test_reuse_grad_bf16_input():
    """Regression (round-5 review): grad through ReuseSpMM.apply_static /
    apply_dst with a bfloat16 h raised a trace-time dtype TypeError — the
    custom VJP returned dh in f32 (the primal OUTPUT dtype) instead of
    h's dtype, and the h*f multiply's transpose requires matching dtypes.
    This is the production GCN/GAT + reuse + --bf16 path."""
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.ops.reuse_spmm import ReuseSpMM

    src, dst = clustered_graph(200, 8, 8, seed=3)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    f = np.random.default_rng(0).uniform(0.5, 1.5, 200).astype(np.float32)
    op = ReuseSpMM(src, dst, 200, 200, max_width=8, feature_dim=4,
                   rank1_factor=f)
    h = jnp.asarray(np.random.default_rng(1).normal(size=(200, 4)),
                    dtype=jnp.bfloat16)

    def loss_static(h):
        return (op.apply_static(op.arrays, h).astype(jnp.float32) ** 2).sum()

    g = jax.grad(loss_static)(h)
    assert g.dtype == jnp.bfloat16 and bool(jnp.isfinite(
        g.astype(jnp.float32)).all())

    op2 = ReuseSpMM(src, dst, 200, 200, max_width=8, feature_dim=4)
    dv = jnp.asarray(f)

    def loss_dst(h):
        return (op2.apply_dst(op2.arrays, h, dv).astype(jnp.float32)
                ** 2).sum()

    g2 = jax.grad(loss_dst)(h)
    assert g2.dtype == jnp.bfloat16
