"""HybSpMM (hybrid ELL + chunked top bucket) must match the edgewise
oracle exactly — forward, all three apply flavors, both gradients, hub
spill rows, halo tables, and the msgs scan-chunk path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dorylus_tpu.ops.hyb_spmm import HybSpMM, build_hyb_plan, _choose_widths
from dorylus_tpu.ops.spmm import spmm_edgewise


def _random_graph(v_in, v_out, e, f, seed, powerlaw=False):
    rng = np.random.default_rng(seed)
    if powerlaw:
        deg = np.minimum(rng.zipf(1.5, v_out), 200)
        dst = np.repeat(np.arange(v_out, dtype=np.int32), deg)[:e]
        dst = np.sort(dst)
        e = len(dst)
    else:
        dst = np.sort(rng.integers(0, v_out, size=e).astype(np.int32))
    src = rng.integers(0, v_in, size=e).astype(np.int32)
    val = rng.normal(0, 1, size=e).astype(np.float32)
    h = rng.normal(0, 1, size=(v_in, f)).astype(np.float32)
    return src, dst, val, h


def _oracle(src, dst, val, h, v_out):
    out = np.zeros((v_out, h.shape[1]), np.float32)
    for e in range(len(src)):
        out[dst[e]] += val[e] * h[src[e]]
    return out


def test_choose_widths_covers_and_merges():
    deg = np.sort(np.r_[np.full(100, 5), np.full(3, 60)])
    # lam huge -> one bucket at the max width class
    assert _choose_widths(deg, lam=10**9) == [64]
    # lam tiny -> one bucket per width class
    assert _choose_widths(deg, lam=0) == [8, 64]


@pytest.mark.parametrize("powerlaw", [False, True])
def test_forward_matches_oracle(powerlaw):
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=3,
                                     powerlaw=powerlaw)
    ref = _oracle(src, dst, val, h, 41)
    op = HybSpMM(src, dst, 57, 41, lam_slots=16)
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_hub_spill_rows():
    """max_width small enough that vertices spill into the chunked top
    bucket with a segment reduce (the power-law hub path)."""
    src, dst, val, h = _random_graph(60, 40, 500, 7, seed=5)
    ref = _oracle(src, dst, val, h, 40)
    op = HybSpMM(src, dst, 60, 40, max_width=8, lam_slots=4)
    assert op.arrays["fwd"]["top"] is not None
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_gradients_match_edgewise():
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=7)
    op = HybSpMM(src, dst, 57, 41, max_width=16, lam_slots=8)
    sj, dj = jnp.asarray(src), jnp.asarray(dst)

    def loss_hyb(h, v):
        return (op.apply(op.arrays, h, v) ** 2).sum()

    def loss_ew(h, v):
        return (spmm_edgewise(h, sj, dj, v, 41, sorted_dst=True) ** 2).sum()

    gh = jax.grad(loss_hyb, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    ge = jax.grad(loss_ew, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    np.testing.assert_allclose(np.asarray(gh[0]), np.asarray(ge[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gh[1]), np.asarray(ge[1]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_static_vals_match_dynamic():
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=9)
    dyn = HybSpMM(src, dst, 57, 41, lam_slots=8)
    sta = HybSpMM(src, dst, 57, 41, lam_slots=8, static_val=val)
    assert sta.has_static_vals
    hj, vj = jnp.asarray(h), jnp.asarray(val)
    np.testing.assert_allclose(
        np.asarray(sta.apply_static(sta.arrays, hj)),
        np.asarray(dyn.apply(dyn.arrays, hj, vj)), rtol=1e-5, atol=1e-5)

    def loss_s(hh):
        return (sta.apply_static(sta.arrays, hh) ** 2).sum()

    def loss_d(hh):
        return (dyn.apply(dyn.arrays, hh, vj) ** 2).sum()

    np.testing.assert_allclose(np.asarray(jax.grad(loss_s)(hj)),
                               np.asarray(jax.grad(loss_d)(hj)),
                               rtol=1e-4, atol=1e-4)


def test_apply_dst_matches_per_edge_values():
    """apply_dst must equal apply() with att[e] = dst_val[dst[e]] —
    forward and BOTH gradients (same contract as DegreeSpMM)."""
    src, dst, _, h = _random_graph(57, 41, 400, 9, seed=29)
    rng = np.random.default_rng(30)
    dst_val = rng.normal(0, 1, size=41).astype(np.float32)
    op = HybSpMM(src, dst, 57, 41, max_width=16, lam_slots=8)
    hj = jnp.asarray(h)
    dvj = jnp.asarray(dst_val)
    att = jnp.asarray(dst_val[dst])

    np.testing.assert_allclose(
        np.asarray(op.apply_dst(op.arrays, hj, dvj)),
        np.asarray(op.apply(op.arrays, hj, att)), rtol=1e-5, atol=1e-5)

    def loss_dst(h, dv):
        return (op.apply_dst(op.arrays, h, dv) ** 2).sum()

    def loss_ref(h, a):
        return (op.apply(op.arrays, h, a) ** 2).sum()

    gh_d, gdv = jax.grad(loss_dst, argnums=(0, 1))(hj, dvj)
    gh_r, gatt = jax.grad(loss_ref, argnums=(0, 1))(hj, att)
    np.testing.assert_allclose(np.asarray(gh_d), np.asarray(gh_r),
                               rtol=1e-4, atol=1e-5)
    want = np.zeros(41, np.float32)
    np.add.at(want, dst, np.asarray(gatt))
    np.testing.assert_allclose(np.asarray(gdv), want, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_halo_table_larger_than_num_in_rows():
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=11)
    h_big = np.vstack([h, np.zeros((5, 9), np.float32)])
    op = HybSpMM(src, dst, 62, 41, lam_slots=8)
    out = np.asarray(op(jnp.asarray(h_big), jnp.asarray(val)))
    np.testing.assert_allclose(out, _oracle(src, dst, val, h, 41),
                               rtol=1e-5, atol=1e-5)

    def loss(hh):
        return op.apply(op.arrays, hh, jnp.asarray(val)).sum()

    g = jax.grad(loss)(jnp.asarray(h_big))
    assert g.shape == h_big.shape


def test_isolated_vertices_and_zero_edges():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 1, 3], np.int32)
    val = np.ones(3, np.float32)
    h = np.eye(5, dtype=np.float32)
    op = HybSpMM(src, dst, 5, 5, lam_slots=4)
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, _oracle(src, dst, val, h, 5), atol=1e-6)
    assert np.all(out[0] == 0) and np.all(out[2] == 0) and np.all(out[4] == 0)

    empty = HybSpMM(np.zeros(0, np.int32), np.zeros(0, np.int32), 4, 4)
    assert np.all(np.asarray(empty(jnp.eye(4), jnp.zeros(0))) == 0)


@pytest.mark.slow
def test_msgs_scan_chunk_matches_unchunked(monkeypatch):
    import dorylus_tpu.ops.hyb_spmm as hyb

    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=13)
    op = HybSpMM(src, dst, 57, 41, lam_slots=8)
    ref = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    monkeypatch.setattr(hyb, "_MSGS_CHUNK_BYTES", 64 * 1024)
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    def loss(hh, vv):
        return (op.apply(op.arrays, hh, vv) ** 2).sum()

    gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    monkeypatch.undo()
    gu = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    for a, b in zip(gc, gu):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_bf16_gather_mode_close_to_f32():
    src, dst, val, h = _random_graph(200, 150, 2000, 32, seed=15)
    f32 = HybSpMM(src, dst, 200, 150, lam_slots=64)
    b16 = HybSpMM(src, dst, 200, 150, lam_slots=64,
                  gather_dtype=jnp.bfloat16)
    hj, vj = jnp.asarray(h), jnp.asarray(val)
    o32, o16 = np.asarray(f32(hj, vj)), np.asarray(b16(hj, vj))
    assert np.abs(o16 - o32).max() <= 2e-2 * np.abs(o32).max()


def test_plan_slot_edge_maps_are_consistent():
    """e2s must invert the per-slot s2e maps (the fused-SDDMM routing)."""
    src, dst, val, _ = _random_graph(60, 40, 500, 4, seed=21)
    plan = build_hyb_plan(src, dst, None, 40, max_width=8, lam_slots=4)
    e = len(src)
    flat_s2e = np.concatenate(
        [b["s2e"].ravel() for b in plan["buckets"]]
        + ([plan["top"]["s2e"].ravel()] if plan["top"] is not None else []))
    live = flat_s2e != e
    assert np.array_equal(np.sort(flat_s2e[live]), np.arange(e))
    np.testing.assert_array_equal(flat_s2e[plan["e2s"]], np.arange(e))


def test_hyb_engine_matches_xla():
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(300, 6, 16, 4, seed=41)
    layers = LayerConfig([16, 8, 4])
    r_x = Engine(g, layers, TrainConfig(epochs=4, eval_every=0)).run()
    r_h = Engine(g, layers, TrainConfig(epochs=4, eval_every=0,
                                        kernel="hyb")).run()
    for ex, eh in zip(r_x.epochs, r_h.epochs):
        np.testing.assert_allclose(ex.loss, eh.loss, rtol=5e-4, atol=1e-6)


def test_hyb_engine_gat():
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(200, 5, 12, 3, seed=43)
    layers = LayerConfig([12, 6, 3])
    cfg = dict(model="gat", epochs=3, eval_every=0, learning_rate=0.005)
    r_x = Engine(g, layers, TrainConfig(**cfg)).run()
    r_h = Engine(g, layers, TrainConfig(**cfg, kernel="hyb")).run()
    for ex, eh in zip(r_x.epochs, r_h.epochs):
        np.testing.assert_allclose(ex.loss, eh.loss, rtol=1e-3, atol=1e-6)


@pytest.mark.slow
def test_degree_sorted_identity_path():
    """Ascending-degree renumbering makes the plan's output permutation
    the identity ("_n_iso" static); results must match the gather path
    exactly — fwd, grads, and all three apply flavors."""
    from dorylus_tpu.graph.graph import synthetic_graph
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    g0 = synthetic_graph(300, 6, 8, 4, seed=51)
    g = apply_order(g0, degree_order(g0, ascending=True))
    v = g.num_vertices
    op = HybSpMM(g.src, g.dst, v, v, lam_slots=64)
    # synthetic_graph is undirected: BOTH plans collapse to identity.
    assert op.static[4] is not None and op.static[5] is not None
    assert "inv" not in op.arrays["fwd"]
    rng = np.random.default_rng(0)
    h = rng.normal(0, 1, (v, 8)).astype(np.float32)
    val = rng.normal(0, 1, g.num_edges).astype(np.float32)
    ref = _oracle(np.asarray(g.src), np.asarray(g.dst), val, h, v)
    hj, vj = jnp.asarray(h), jnp.asarray(val)
    np.testing.assert_allclose(np.asarray(op(hj, vj)), ref,
                               rtol=1e-4, atol=1e-4)

    def loss_hyb(hh, vv):
        return (op.apply(op.arrays, hh, vv) ** 2).sum()

    def loss_ew(hh, vv):
        return (spmm_edgewise(hh, jnp.asarray(g.src), jnp.asarray(g.dst),
                              vv, v, sorted_dst=True) ** 2).sum()

    gh = jax.grad(loss_hyb, argnums=(0, 1))(hj, vj)
    ge = jax.grad(loss_ew, argnums=(0, 1))(hj, vj)
    np.testing.assert_allclose(np.asarray(gh[0]), np.asarray(ge[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gh[1]), np.asarray(ge[1]),
                               rtol=1e-4, atol=1e-4)

    # dst-functional and static flavors through the identity path.
    dv = jnp.asarray(rng.normal(0, 1, v).astype(np.float32))
    att = dv[jnp.asarray(g.dst)]
    np.testing.assert_allclose(
        np.asarray(op.apply_dst(op.arrays, hj, dv)),
        np.asarray(op.apply(op.arrays, hj, att)), rtol=1e-4, atol=1e-4)
    sta = HybSpMM(g.src, g.dst, v, v, lam_slots=64, static_val=val)
    np.testing.assert_allclose(
        np.asarray(sta.apply_static(sta.arrays, hj)), ref,
        rtol=1e-4, atol=1e-4)


def test_degree_sorted_engine_matches_unsorted():
    """Engine-level: training on the degree-asc-renumbered graph gives the
    same loss trajectory (params are vertex-order-independent: the loss
    sums over vertices and the split follows split_ids)."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    g0 = synthetic_graph(300, 6, 16, 4, seed=53)
    g1 = apply_order(g0, degree_order(g0, ascending=True))
    layers = LayerConfig([16, 8, 4])
    cfg = TrainConfig(epochs=4, eval_every=0, kernel="hyb")
    r0 = Engine(g0, layers, cfg).run()
    r1 = Engine(g1, layers, cfg).run()
    for a, b in zip(r0.epochs, r1.epochs):
        np.testing.assert_allclose(a.loss, b.loss, rtol=1e-4, atol=1e-6)


def test_dynamic_false_strips_maps_and_matches():
    """dynamic=False drops the slot->edge maps (a capacity lever — they
    are E-sized) without changing static/dst/unit math;
    the dynamic path then raises instead of mis-executing."""
    import jax.numpy as jnp
    import pytest

    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(250, 7, 12, 4, seed=9)
    kw = dict(gather_dtype=jnp.bfloat16, feature_dim=12,
              static_val=np.asarray(g.edge_norm))
    full = HybSpMM(g.src, g.dst, 250, 250, **kw)
    slim = HybSpMM(g.src, g.dst, 250, 250, dynamic=False, **kw)
    assert "e2s" not in slim.arrays["fwd"]
    assert all("s2e" not in b for b in slim.arrays["fwd"]["buckets"])
    # bf16-shipped static vals (one rounding) — same values the full op
    # multiplies with at runtime.
    assert slim.arrays["fwd"]["buckets"][0]["vals"].dtype == jnp.bfloat16
    h = jnp.asarray(np.random.default_rng(3).normal(size=(250, 12)),
                    jnp.float32)
    np.testing.assert_allclose(
        np.asarray(full.apply_static(full.arrays, h)),
        np.asarray(slim.apply_static(slim.arrays, h)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(full.apply_unit(full.arrays, h)),
        np.asarray(slim.apply_unit(slim.arrays, h)), rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="dynamic=False"):
        slim.apply(slim.arrays, h, jnp.ones(g.num_edges))


def test_padded_nbytes_and_budget_cpu_noop(monkeypatch):
    """tree_nbytes counts logical bytes (the GPU pads no lanes);
    fit_msgs_budget keeps the fixed guard on the CPU, sizes the guard from
    an accelerator's memory_stats()["bytes_limit"], and refuses to guess
    when an accelerator reports none."""
    from dorylus_tpu.ops import hyb_spmm
    from dorylus_tpu.ops.hyb_spmm import fit_msgs_budget, tree_nbytes

    tree = {
        "grid": np.zeros((1000, 32), np.int32),
        "flat": np.zeros(1000, np.float32),
        "wide": {"x": np.zeros((3, 5, 7), np.float16)},
        "scalar": np.float32(1.0),
    }
    assert tree_nbytes(tree) == 1000 * 32 * 4 + 1000 * 4 + 3 * 5 * 7 * 2
    before = hyb_spmm._MSGS_CHUNK_BYTES
    assert fit_msgs_budget(50 << 30) == before  # CPU: the fixed guard
    assert hyb_spmm._MSGS_CHUNK_BYTES == before  # pure: never mutated

    class Card:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    limit = 60 << 30
    monkeypatch.setattr(hyb_spmm.jax, "local_devices",
                        lambda: [Card({"bytes_limit": limit})])
    logged = []
    got = fit_msgs_budget(10 << 30, 3 << 30,
                          log_fn=lambda *a: logged.append(a))
    assert got == limit - (10 << 30) - (3 << 30) - (2 << 30)
    assert logged
    assert fit_msgs_budget(limit, 0) == 1 << 30  # floor: 1 GB
    for stats in (None, {}):
        monkeypatch.setattr(hyb_spmm.jax, "local_devices",
                            lambda stats=stats: [Card(stats)])
        with pytest.raises(RuntimeError, match="bytes_limit"):
            fit_msgs_budget(0)


def test_msgs_budget_is_engine_scoped():
    """set_msgs_budget rides the op's static tuple: a tiny budget on op A
    forces scan-chunking (same result) while op B in the same process
    keeps the default — no module-global sharing (round-4 Weak #6)."""
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=13)
    a = HybSpMM(src, dst, 57, 41, lam_slots=8)
    b = HybSpMM(src, dst, 57, 41, lam_slots=8)
    ref = np.asarray(b(jnp.asarray(h), jnp.asarray(val)))
    a.set_msgs_budget(64 * 1024)
    assert a.static[6] == 64 * 1024 and b.static[6] == 0
    out = np.asarray(a(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    def loss(op):
        return lambda hh, vv: (op.apply(op.arrays, hh, vv) ** 2).sum()

    ga = jax.grad(loss(a), argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    gb = jax.grad(loss(b), argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)
