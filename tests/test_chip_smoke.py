"""chip_smoke.py off the card: its float64 host references agree with the
numpy oracle, its phases pass at a small size on the CPU, and the script
itself refuses to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import oracle

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def small_graph():
    return cs.reddit_graph(num_vertices=400, avg_degree=6)


def test_host_references_match_oracle(small_graph):
    g = small_graph
    s_dense = g.dense_norm_adj()
    h = np.random.default_rng(0).normal(size=(g.num_vertices, 5))
    a = cs.host_adjacency(g)
    np.testing.assert_allclose(
        a @ h, (s_dense - np.diag(g.self_norm.astype(np.float64))) @ h,
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cs.host_adjacency(g, self_loops=True).toarray(),
                               s_dense, rtol=1e-12, atol=1e-12)
    unit = cs.host_adjacency(g, weighted=False).toarray()
    want_unit = np.zeros_like(unit)
    np.add.at(want_unit, (g.dst, g.src), 1.0)
    np.testing.assert_array_equal(unit, want_unit)

    rng = np.random.default_rng(1)
    ws = [rng.normal(0, 0.1, size=(cs.DIMS[0], cs.DIMS[1])),
          rng.normal(0, 0.1, size=(cs.DIMS[1], cs.DIMS[2]))]
    train, _, _ = g.masks()
    onehot = np.eye(g.num_classes)[g.labels]
    want, _ = oracle.gcn_loss_and_grads(
        s_dense, g.features.astype(np.float64), ws, onehot, train,
        g.num_vertices * 0.66)
    logits, loss = cs.host_gcn_forward(g, ws)
    np.testing.assert_allclose(loss, want, rtol=1e-10)
    np.testing.assert_allclose(logits, oracle.gcn_forward(
        s_dense, g.features.astype(np.float64), ws)[-1][2], rtol=1e-10)


def test_kernel_and_loss_phases_pass_small(small_graph):
    """Phases b and c at a small size on the CPU (the same checks and
    tolerances the card runs at full size)."""
    cs.phase_kernels(small_graph)
    cs.phase_loss(small_graph)


def test_four_card_phase_on_virtual_mesh(small_graph):
    """Phase d on four virtual CPU devices: sharded hyb GCN/GAT match
    single-device; ragged does not lower on XLA:CPU and is reported."""
    assert cs.phase_four_cards(small_graph, jax.devices()) is False


def test_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
