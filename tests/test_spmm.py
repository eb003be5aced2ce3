"""SpMM kernel variants must agree: unchunked, chunked, sorted, and the
transform-first layer ordering."""

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.batch import build_batch
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.models.gcn import GCN
from dorylus_tpu.ops.spmm import spmm_edgewise


def test_chunked_matches_unchunked():
    g = synthetic_graph(500, 10, 32, 4, seed=2)
    h = jnp.asarray(g.features)
    a = spmm_edgewise(h, jnp.asarray(g.src), jnp.asarray(g.dst),
                      jnp.asarray(g.edge_norm), g.num_vertices, sorted_dst=True)
    b = spmm_edgewise(h, jnp.asarray(g.src), jnp.asarray(g.dst),
                      jnp.asarray(g.edge_norm), g.num_vertices, edge_chunk=777)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_chunked_gradients():
    g = synthetic_graph(200, 8, 16, 4, seed=4)
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    val = jnp.asarray(g.edge_norm)

    def f_plain(h):
        return jnp.sum(spmm_edgewise(h, src, dst, val, g.num_vertices) ** 2)

    def f_chunk(h):
        return jnp.sum(spmm_edgewise(h, src, dst, val, g.num_vertices,
                                     edge_chunk=300) ** 2)

    h = jnp.asarray(g.features)
    g1 = jax.grad(f_plain)(h)
    g2 = jax.grad(f_chunk)(h)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-4, atol=1e-5)


def test_transform_first_ordering_equivalent():
    g = synthetic_graph(300, 8, 32, 4, seed=6)
    layers = LayerConfig([32, 8, 4])
    batch = build_batch(g)
    m1 = GCN(layers, optimize_order=False)
    m2 = GCN(layers, optimize_order=True)
    params = m1.init_params()
    l1 = m1.forward(params, batch)
    l2 = m2.forward(params, batch)
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=1e-4, atol=1e-5)


def test_edgewise_dynamic_values_match_dense():
    """Per-edge runtime values (the GAT path on the xla kernel), sorted
    and chunked, against a dense float64 product — value and h-gradient."""
    g = synthetic_graph(700, 9, 24, 4, seed=8)
    val = np.random.default_rng(1).normal(size=g.num_edges).astype(np.float32)
    a = np.zeros((g.num_vertices, g.num_vertices))
    np.add.at(a, (g.dst, g.src), val.astype(np.float64))
    h = jnp.asarray(g.features)
    src, dst, v = jnp.asarray(g.src), jnp.asarray(g.dst), jnp.asarray(val)
    cot = np.random.default_rng(2).normal(
        size=(g.num_vertices, 24)).astype(np.float32)
    for chunk in (0, 1000):
        def f(x, chunk=chunk):
            return spmm_edgewise(x, src, dst, v, g.num_vertices,
                                 sorted_dst=True, edge_chunk=chunk)

        out, vjp = jax.vjp(f, h)
        np.testing.assert_allclose(np.asarray(out),
                                   a @ np.asarray(g.features, np.float64),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vjp(jnp.asarray(cot))[0]),
                                   a.T @ cot.astype(np.float64),
                                   rtol=1e-5, atol=1e-5)


def test_take_sorted_matches_plain_gather_grad():
    """take_sorted: x[idx] forward-identical to plain gather; backward is a
    sorted segment_sum that must equal the autodiff scatter-add."""
    import jax
    import jax.numpy as jnp

    from dorylus_tpu.ops.spmm import take_sorted

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=23).astype(np.float32))
    idx = jnp.asarray(np.sort(rng.integers(0, 23, 200)).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(take_sorted(x, idx, 23)),
                                  np.asarray(x[idx]))
    g1 = jax.grad(lambda x: (take_sorted(x, idx, 23) ** 3).sum())(x)
    g2 = jax.grad(lambda x: (x[idx] ** 3).sum())(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-5)
