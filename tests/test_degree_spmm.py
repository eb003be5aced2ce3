"""DegreeSpMM (degree-padded blocked aggregation) must match the edgewise
oracle exactly — forward, both gradients, chunked rows, halo tables, and
dynamic edge values (GAT attention routing through slot_to_edge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dorylus_tpu.ops.degree_spmm import DegreeSpMM
from dorylus_tpu.ops.spmm import spmm_edgewise


def _random_graph(v_in, v_out, e, f, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v_in, size=e).astype(np.int32)
    dst = np.sort(rng.integers(0, v_out, size=e).astype(np.int32))
    val = rng.normal(0, 1, size=e).astype(np.float32)
    h = rng.normal(0, 1, size=(v_in, f)).astype(np.float32)
    return src, dst, val, h


def _oracle(src, dst, val, h, v_out):
    out = np.zeros((v_out, h.shape[1]), np.float32)
    for e in range(len(src)):
        out[dst[e]] += val[e] * h[src[e]]
    return out


@pytest.mark.parametrize("block", [4, 8, 16])
def test_forward_matches_oracle(block):
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=3)
    ref = _oracle(src, dst, val, h, 41)
    op = DegreeSpMM(src, dst, 57, 41, block=block)
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_gradients_match_edgewise():
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=5)
    op = DegreeSpMM(src, dst, 57, 41, block=8)
    sj, dj = jnp.asarray(src), jnp.asarray(dst)

    def loss_deg(h, v):
        return (op.apply(op.arrays, h, v) ** 2).sum()

    def loss_ew(h, v):
        return (spmm_edgewise(h, sj, dj, v, 41, sorted_dst=True) ** 2).sum()

    gd = jax.grad(loss_deg, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    ge = jax.grad(loss_ew, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(val))
    np.testing.assert_allclose(np.asarray(gd[0]), np.asarray(ge[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gd[1]), np.asarray(ge[1]),
                               rtol=1e-4, atol=1e-4)


def test_row_chunk_matches_unchunked():
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=7)
    a = DegreeSpMM(src, dst, 57, 41, block=8)
    b = DegreeSpMM(src, dst, 57, 41, block=8, row_chunk=7)
    oa = np.asarray(a(jnp.asarray(h), jnp.asarray(val)))
    ob = np.asarray(b(jnp.asarray(h), jnp.asarray(val)))
    np.testing.assert_allclose(oa, ob, rtol=1e-5, atol=1e-6)


def test_halo_table_larger_than_num_in_rows():
    """h may include ghost rows past num_in; bwd dh is truncated to h rows."""
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=9)
    h_big = np.vstack([h, np.zeros((5, 9), np.float32)])
    op = DegreeSpMM(src, dst, 62, 41, block=8)
    out = np.asarray(op(jnp.asarray(h_big), jnp.asarray(val)))
    np.testing.assert_allclose(out, _oracle(src, dst, val, h, 41),
                               rtol=1e-5, atol=1e-5)

    def loss(hh):
        return op.apply(op.arrays, hh, jnp.asarray(val)).sum()

    g = jax.grad(loss)(jnp.asarray(h_big))
    assert g.shape == h_big.shape


def test_dynamic_edge_values_follow_edge_order():
    """val is given in original edge order (the GAT attention contract):
    permuting (src,dst,val) together must not change the result."""
    src, dst, val, h = _random_graph(30, 30, 200, 5, seed=11)
    op = DegreeSpMM(src, dst, 30, 30, block=4)
    out1 = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    ref = _oracle(src, dst, val, h, 30)
    np.testing.assert_allclose(out1, ref, rtol=1e-5, atol=1e-5)
    # different val, same structure -> slot routing must track edges
    val2 = val * np.arange(1, len(val) + 1, dtype=np.float32)
    out2 = np.asarray(op(jnp.asarray(h), jnp.asarray(val2)))
    np.testing.assert_allclose(out2, _oracle(src, dst, val2, h, 30),
                               rtol=1e-4, atol=1e-4)


def test_empty_and_isolated_vertices():
    """Vertices with zero in-degree must produce zero rows."""
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 1, 3], np.int32)
    val = np.ones(3, np.float32)
    h = np.eye(5, dtype=np.float32)
    op = DegreeSpMM(src, dst, 5, 5, block=4)
    out = np.asarray(op(jnp.asarray(h), jnp.asarray(val)))
    ref = _oracle(src, dst, val, h, 5)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.all(out[0] == 0) and np.all(out[2] == 0) and np.all(out[4] == 0)


def test_zero_edges():
    op = DegreeSpMM(np.zeros(0, np.int32), np.zeros(0, np.int32), 4, 4)
    out = np.asarray(op(jnp.eye(4), jnp.zeros(0, jnp.float32)))
    assert np.all(out == 0)


def test_degree_engine_matches_xla():
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(300, 6, 16, 4, seed=41)
    layers = LayerConfig([16, 8, 4])
    r_x = Engine(g, layers, TrainConfig(epochs=4, eval_every=0)).run()
    r_d = Engine(g, layers, TrainConfig(epochs=4, eval_every=0,
                                        kernel="degree")).run()
    for ex, ed in zip(r_x.epochs, r_d.epochs):
        np.testing.assert_allclose(ex.loss, ed.loss, rtol=5e-4, atol=1e-6)


def test_degree_engine_gat():
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.engine.engine import Engine
    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(200, 5, 12, 3, seed=43)
    layers = LayerConfig([12, 6, 3])
    cfg = dict(model="gat", epochs=3, eval_every=0, learning_rate=0.005)
    r_x = Engine(g, layers, TrainConfig(**cfg)).run()
    r_d = Engine(g, layers, TrainConfig(**cfg, kernel="degree")).run()
    for ex, ed in zip(r_x.epochs, r_d.epochs):
        np.testing.assert_allclose(ex.loss, ed.loss, rtol=1e-3, atol=1e-6)


def test_blocked_final_reduce_matches_plain():
    """out_block_rows (the large-V cliff path) must be numerically
    identical to the plain final segment_sum — fwd and both grads."""
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=13)
    plain = DegreeSpMM(src, dst, 57, 41, block=8, out_block_rows=0)
    blocked = DegreeSpMM(src, dst, 57, 41, block=8, out_block_rows=7)
    assert blocked.static[4] == 7 and blocked.static[5] == 7
    assert "out_idx" in blocked.arrays["fwd"]
    hj, vj = jnp.asarray(h), jnp.asarray(val)
    np.testing.assert_allclose(np.asarray(plain(hj, vj)),
                               np.asarray(blocked(hj, vj)),
                               rtol=1e-6, atol=1e-6)

    def loss(op):
        return lambda hh, vv: (op.apply(op.arrays, hh, vv) ** 2).sum()

    gp = jax.grad(loss(plain), argnums=(0, 1))(hj, vj)
    gb = jax.grad(loss(blocked), argnums=(0, 1))(hj, vj)
    np.testing.assert_allclose(np.asarray(gp[0]), np.asarray(gb[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gp[1]), np.asarray(gb[1]),
                               rtol=1e-5, atol=1e-6)


def test_auto_row_chunk_is_oom_guard_only():
    """row_chunk auto-enables only when the (slots, F) message tensor would
    be very large; small graphs must stay unchunked (chunking is slower)."""
    src, dst, val, h = _random_graph(57, 41, 400, 9, seed=17)
    small = DegreeSpMM(src, dst, 57, 41, block=8, feature_dim=128)
    assert small.static[2] == 0
    huge_f = DegreeSpMM(src, dst, 57, 41, block=8,
                        feature_dim=(8 << 30) // (4 * 400) + 41 * 8)
    assert huge_f.static[2] == (1 << 18)
    # explicit row_chunk always wins
    forced = DegreeSpMM(src, dst, 57, 41, block=8, row_chunk=7,
                        feature_dim=128)
    assert forced.static[2] == 7


def test_bf16_gather_mode_close_to_f32():
    """agg_dtype=bfloat16: messages gathered/multiplied in bf16 with f32
    accumulation (half the gathered bytes). Output must stay within
    bf16 mantissa error of the f32 path, gradients included."""
    src, dst, val, h = _random_graph(200, 150, 2000, 32, seed=11)
    f32 = DegreeSpMM(src, dst, 200, 150, block=8)
    b16 = DegreeSpMM(src, dst, 200, 150, block=8, gather_dtype=jnp.bfloat16)
    hj, vj = jnp.asarray(h), jnp.asarray(val)
    o32 = np.asarray(f32(hj, vj))
    o16 = np.asarray(b16(hj, vj))
    scale = np.abs(o32).max()
    assert np.abs(o16 - o32).max() <= 2e-2 * scale

    def loss(op):
        return lambda hh, vv: (op.apply(op.arrays, hh, vv) ** 2).sum()

    g32 = jax.grad(loss(f32), argnums=(0, 1))(hj, vj)
    g16 = jax.grad(loss(b16), argnums=(0, 1))(hj, vj)
    for a, b in zip(g32, g16):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 3e-2 * np.abs(a).max()


def test_apply_dst_matches_per_edge_values():
    """apply_dst (dst-functional edge weights, the Dorylus GAT case) must
    equal apply() with att[e] = dst_val[dst[e]] — forward and BOTH
    gradients (d_dst_val via the unit-pass row-dot identity)."""
    src, dst, _, h = _random_graph(57, 41, 400, 9, seed=29)
    rng = np.random.default_rng(30)
    dst_val = rng.normal(0, 1, size=41).astype(np.float32)
    op = DegreeSpMM(src, dst, 57, 41, block=8)
    hj = jnp.asarray(h)
    dvj = jnp.asarray(dst_val)
    att = jnp.asarray(dst_val[dst])

    out_dst = np.asarray(op.apply_dst(op.arrays, hj, dvj))
    out_ref = np.asarray(op.apply(op.arrays, hj, att))
    np.testing.assert_allclose(out_dst, out_ref, rtol=1e-5, atol=1e-5)

    def loss_dst(h, dv):
        return (op.apply_dst(op.arrays, h, dv) ** 2).sum()

    def loss_ref(h, a):
        return (op.apply(op.arrays, h, a) ** 2).sum()

    gh_d, gdv = jax.grad(loss_dst, argnums=(0, 1))(hj, dvj)
    gh_r, gatt = jax.grad(loss_ref, argnums=(0, 1))(hj, att)
    np.testing.assert_allclose(np.asarray(gh_d), np.asarray(gh_r),
                               rtol=1e-4, atol=1e-5)
    # d dst_val[v] must equal the per-edge gradients summed over v's edges.
    want = np.zeros(41, np.float32)
    np.add.at(want, dst, np.asarray(gatt))
    np.testing.assert_allclose(np.asarray(gdv), want, rtol=1e-4, atol=1e-4)
