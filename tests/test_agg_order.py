"""Aggregation ordering: both layer orderings compute the same operator.

GCN aggregates at the narrower width (transform-first when a layer
shrinks, optimize_order) or at the input width (aggregate-first); GAT's
dst-functional slot path (apply_dst) and its edgewise path must agree.
An H100 measurement (tools/derive_constants.py) found the narrow table
cheaper at every table size, so no size-dependent ordering rule remains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu.engine.batch import build_batch
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.models.gat import GAT
from dorylus_tpu.models.gcn import GCN
from dorylus_tpu.ops.hyb_spmm import HybSpMM


@pytest.fixture()
def graph():
    return synthetic_graph(300, 6, 16, 8, seed=3)


def _op(g, model, dtype=jnp.bfloat16):
    return HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices,
                   feature_dim=32, gather_dtype=dtype,
                   static_val=(g.edge_norm if model == "gcn" else None))


def _loss_and_grads(model, params, batch):
    return jax.value_and_grad(model.loss)(params, batch)


def _tree_close(a, b, rtol):
    # atol=0.1 against O(10-50) gradient magnitudes: the two orderings
    # move the bf16 rounding point (the factored form is EXACT in f32 —
    # verified to 1.5e-5 abs during development).
    for ka in a:
        np.testing.assert_allclose(np.asarray(a[ka], np.float32),
                                   np.asarray(b[ka], np.float32),
                                   rtol=rtol, atol=0.1, err_msg=ka)


@pytest.mark.slow
def test_gcn_agg_first_matches_transform_first(graph):
    layers = LayerConfig([16, 32, 8])
    op = _op(graph, "gcn")
    batch = build_batch(graph)._replace(aux={"spmm": op.arrays})
    model = GCN(layers, spmm_op=op)
    params = model.init_params(exact_reference=False)

    loss_tf, g_tf = _loss_and_grads(model, params, batch)
    assert model.spmm_op.gather_itemsize == 2
    loss_af, g_af = _loss_and_grads(
        GCN(layers, spmm_op=op, optimize_order=False), params, batch)

    # Same operator; only the bf16 rounding point moves (gather at width
    # 16 of h vs width 8 of h·W).
    np.testing.assert_allclose(float(loss_af), float(loss_tf), rtol=2e-2)
    _tree_close(g_af, g_tf, rtol=8e-2)


def test_gcn_wide_input_keeps_transform_first(graph, monkeypatch):
    """A shrinking layer (l0: 160 -> 8) transforms first and aggregates
    the narrow width, whatever the table size. Asserts the ORDERING
    decision directly by spying on the table widths apply_static
    receives — a loss comparison alone is ordering-invariant (both
    orderings compute the same operator)."""
    g = synthetic_graph(300, 6, 160, 8, seed=3)
    layers = LayerConfig([160, 8, 8])
    op = HybSpMM(g.src, g.dst, g.num_vertices, g.num_vertices,
                 feature_dim=160, gather_dtype=jnp.bfloat16,
                 static_val=g.edge_norm)
    batch = build_batch(g)._replace(aux={"spmm": op.arrays})
    model = GCN(layers, spmm_op=op)
    params = model.init_params(exact_reference=False)

    widths = []
    orig_apply_static = HybSpMM.apply_static

    def spy(self, arrays, h):
        widths.append(int(h.shape[1]))
        return orig_apply_static(self, arrays, h)

    monkeypatch.setattr(HybSpMM, "apply_static", spy)
    model.loss(params, batch)
    # l0 (160 -> 8): aggregates the TRANSFORMED width 8, not the raw 160.
    # l1 (8 -> 8): not shrinking, aggregate-first at width 8.
    assert widths == [8, 8]


def test_gat_agg_first_matches_dst_apply(graph):
    """GAT's dst-functional hyb path (apply_dst at width fout) against
    the edgewise path (per-edge attention values), f32 tables."""
    layers = LayerConfig([16, 32, 8])
    op = _op(graph, "gat", dtype=None)
    batch = build_batch(graph, for_gat=True)._replace(aux={"spmm": op.arrays})
    params = GAT(layers).init_params(exact_reference=False)

    loss_d, g_d = _loss_and_grads(GAT(layers, spmm_op=op), params, batch)
    loss_e, g_e = _loss_and_grads(GAT(layers), params, batch)

    np.testing.assert_allclose(float(loss_d), float(loss_e), rtol=1e-4)
    for k in g_e:
        np.testing.assert_allclose(np.asarray(g_d[k]), np.asarray(g_e[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_apply_unit_matches_dst_ones(graph):
    """apply_unit (the regime path's unit-weight entry point) must equal
    apply_dst with a ones vector — value AND h-gradient — on both slot
    kernels."""
    from dorylus_tpu.ops.degree_spmm import DegreeSpMM

    h = jnp.asarray(np.random.default_rng(0).normal(
        size=(graph.num_vertices, 16)).astype(np.float32))
    for op in (_op(graph, "gat"),
               DegreeSpMM(graph.src, graph.dst, graph.num_vertices,
                          graph.num_vertices, feature_dim=16,
                          gather_dtype=jnp.bfloat16)):
        ones = jnp.ones(graph.num_vertices, jnp.float32)

        def f_unit(x):
            return (op.apply_unit(op.arrays, x) ** 2).sum()

        def f_dst(x):
            return (op.apply_dst(op.arrays, x, ones) ** 2).sum()

        v_u, g_u = jax.value_and_grad(f_unit)(h)
        v_d, g_d = jax.value_and_grad(f_dst)(h)
        np.testing.assert_allclose(float(v_u), float(v_d), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(g_u), np.asarray(g_d),
                                   rtol=1e-4, atol=1e-4)


def test_reddit_shape_below_cliff_unchanged():
    """The op width the engines size plans for follows the layer widths
    alone — no table-size rule widens it (Reddit 602-128-41: 128 for both
    models; a shrinking 128 -> 32 layer aggregates 32)."""
    from dorylus_tpu.common.config import TrainConfig
    from dorylus_tpu.engine.engine import _max_agg_width

    reddit = LayerConfig([602, 128, 41])
    assert _max_agg_width(reddit, TrainConfig(model="gcn")) == 128
    assert _max_agg_width(reddit, TrainConfig(model="gat")) == 128
    assert _max_agg_width(LayerConfig([128, 32, 8]),
                          TrainConfig(model="gcn")) == 32
    assert _max_agg_width(LayerConfig([128, 32, 8]),
                          TrainConfig(model="gcn", optimize_order=False)) == 128
