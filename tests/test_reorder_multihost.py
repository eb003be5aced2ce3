"""Vertex reordering (split-preserving) + multihost/mesh helpers +
weak-scaling harness smoke."""

import subprocess
import sys

import numpy as np

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.reorder import apply_order, bfs_order, degree_order


def test_reorder_preserves_training_semantics():
    """Training on a BFS-reordered graph must give identical losses: the
    graph is isomorphic and the split follows original ids."""
    g = synthetic_graph(300, 6, 16, 4, seed=61)
    order = bfs_order(g)
    g2 = apply_order(g, order)
    assert g2.num_edges == g.num_edges
    layers = LayerConfig([16, 8, 4])
    r1 = Engine(g, layers, TrainConfig(epochs=5, eval_every=0)).run()
    r2 = Engine(g2, layers, TrainConfig(epochs=5, eval_every=0)).run()
    for a, b in zip(r1.epochs, r2.epochs):
        np.testing.assert_allclose(a.loss, b.loss, rtol=2e-4)


def test_degree_order_is_permutation():
    g = synthetic_graph(200, 5, 8, 3, seed=63)
    order = degree_order(g)
    assert sorted(order.tolist()) == list(range(200))


def test_multihost_helpers():
    from dorylus_tpu.parallel.multihost import global_mesh, init_multihost
    init_multihost()  # single-process no-op
    mesh = global_mesh(2)
    assert mesh.shape["graph"] == 2


def test_init_multihost_cluster_guard(monkeypatch):
    """Auto-init failures fall back quietly on a single host, but raise
    when the environment claims a real cluster (a coordinator address)."""
    import pytest

    from jax._src import distributed as _dist
    from dorylus_tpu.parallel.multihost import init_multihost
    if getattr(_dist.global_state, "client", None) is not None:
        pytest.skip("distributed client already initialized in-process")

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    init_multihost()  # must NOT raise: no cluster claimed

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "")  # empty = unset-like
    init_multihost()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "host0:1234")
    with pytest.raises((ValueError, RuntimeError)):
        init_multihost()
