"""Checks that need the card. Run them there with

    DORYLUS_TEST_GPU=1 python -m pytest tests/ -m gpu -o addopts=""

(`-o addopts=""` drops pytest.ini's xdist workers: one process per card.)
Elsewhere the `gpu` fixture (tests/conftest.py) skips them."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

pytestmark = pytest.mark.gpu


def test_msgs_budget_from_device_memory(gpu):
    from dorylus_tpu.ops.hyb_spmm import fit_msgs_budget

    limit = gpu.memory_stats()["bytes_limit"]
    assert fit_msgs_budget(0, 0) == limit - (2 << 30)


def test_kernels_and_loss_match_float64_on_card(gpu):
    import chip_smoke as cs

    g = cs.reddit_graph(num_vertices=20_000, avg_degree=20)
    cs.phase_kernels(g)
    cs.phase_loss(g)
