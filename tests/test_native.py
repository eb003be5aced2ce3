"""Native graphcore library vs numpy fallbacks (builds the .so if absent)."""

import numpy as np
import pytest

from dorylus_tpu import native


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("g++/native build unavailable")
    return True


def test_sort_by_dst(lib_ok):
    rng = np.random.default_rng(0)
    dst = rng.integers(0, 100, 5000).astype(np.int32)
    order = native.sort_by_dst(dst, 100)
    assert (np.diff(dst[order]) >= 0).all()
    # stability: within equal dst, original index order preserved
    for v in (0, 17, 99):
        sel = order[dst[order] == v]
        assert (np.diff(sel) > 0).all()


def test_gcn_norms_match_numpy(lib_ok):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 200, 3000).astype(np.int32)
    dst = rng.integers(0, 200, 3000).astype(np.int32)
    deg, en, sn = native.gcn_norms(src, dst, 200)
    want_deg = np.bincount(dst, minlength=200)
    np.testing.assert_array_equal(deg, want_deg)
    inv = (want_deg + 1.0) ** -0.5
    np.testing.assert_allclose(en, (inv[src] * inv[dst]).astype(np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(sn, ((want_deg + 1.0) ** -1).astype(np.float32),
                               rtol=1e-6)


def test_sort_by_key64(lib_ok):
    rng = np.random.default_rng(2)
    key = rng.integers(0, 1 << 40, 10000).astype(np.uint64)
    order = native.sort_by_key64(key)
    np.testing.assert_array_equal(key[order], np.sort(key))
    want = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(order, want)


def test_ldg_partition_balance_and_locality(lib_ok):
    rng = np.random.default_rng(3)
    # Two clear communities.
    v = 400
    src = np.r_[rng.integers(0, 200, 3000), rng.integers(200, 400, 3000)]
    dst = np.r_[rng.integers(0, 200, 3000), rng.integers(200, 400, 3000)]
    parts = native.ldg_partition(src.astype(np.int32), dst.astype(np.int32),
                                 v, 2)
    sizes = np.bincount(parts, minlength=2)
    assert sizes.min() > v * 0.3  # balanced-ish
    cut = (parts[src] != parts[dst]).mean()
    assert cut < 0.3  # far better than random (0.5)



def test_ldg_refinement_recovers_scrambled_communities(lib_ok):
    """Restreaming refinement (gc_refine_partition) must recover most of a
    scrambled clustered graph's structure: single-pass LDG on a random
    vertex order leaves ~0.49 cut; refined must land well under it while
    staying capacity-balanced."""
    from dorylus_tpu.graph.graph import clustered_synthetic_graph
    from dorylus_tpu.graph.reorder import apply_order

    g = clustered_synthetic_graph(4000, 12, 4, 4, seed=5, window=256,
                                  cut=0.05)
    g = apply_order(g, np.random.default_rng(0).permutation(4000))
    raw = native.ldg_partition(g.src, g.dst, 4000, 4, refine_iters=0)
    ref = native.ldg_partition(g.src, g.dst, 4000, 4, refine_iters=8)
    cut_raw = float((raw[g.src] != raw[g.dst]).mean())
    cut_ref = float((ref[g.src] != ref[g.dst]).mean())
    assert cut_ref < cut_raw * 0.6, (cut_raw, cut_ref)
    sizes = np.bincount(ref, minlength=4)
    assert sizes.max() <= int(4000 / 4 * 1.05) + 1


def test_mine_pairs_native_exact_and_matches_numpy(lib_ok):
    """gc_mine_pairs must produce an EXACT rewrite (same aggregation
    operator) and agree with the numpy miner on the aggregate accounting
    (pair count / uses / rewritten rows may differ only on selection
    tie-breaks; the operator must always match)."""
    if not native.has_mine_pairs():
        pytest.skip("libgraphcore < v3")
    from dorylus_tpu.graph.reuse import _mine_one
    from test_reuse import clustered_graph, dense_unit

    src, dst = clustered_graph(num_vertices=500, communities=15, deg=10,
                               seed=7)
    v = 500
    for max_pairs in (0, 25):
        pairs_n, s_n, d_n, st_n = native.mine_pairs_native(
            src, dst, v, 3, max_pairs)
        pairs_p, s_p, d_p, st_p = _mine_one(src, dst, v, 3, max_pairs)
        if max_pairs:
            assert len(pairs_n) <= max_pairs
        assert st_n["candidates"] == st_p["candidates"]
        # Rewrite exactness: dense operator equality.
        h = np.random.default_rng(8).normal(size=(v, 4))
        tbl = np.concatenate([h, h[pairs_n[:, 0]] + h[pairs_n[:, 1]]])
        out = np.zeros((v, 4))
        np.add.at(out, d_n, tbl[s_n])
        np.testing.assert_allclose(out, dense_unit(src, dst, v) @ h,
                                   rtol=1e-12, atol=1e-12)
        assert (np.diff(d_n) >= 0).all()  # CSC order for the plan builder
        # Row accounting: both miners must save a comparable row count.
        assert st_n["rows_saved"] > 0
        if not max_pairs:
            assert st_n["pairs"] == st_p["pairs"]
            assert st_n["uses"] == st_p["uses"]
            assert len(s_n) == len(s_p)


def test_mine_pairs_native_speed_smoke(lib_ok):
    """The native miner must stay fast enough for the hermetic suite on a
    mid-sized graph."""
    if not native.has_mine_pairs():
        pytest.skip("libgraphcore < v3")
    import time

    from dorylus_tpu.graph.graph import community_core_edges

    src, dst = community_core_edges(200_000, 12, comm=2000, core=40, seed=9)
    t0 = time.perf_counter()
    pairs, s2, d2, st = native.mine_pairs_native(src, dst, 200_000, 3, 0)
    dt = time.perf_counter() - t0
    assert st["rows_saved"] > 0.05 * len(src)
    assert dt < 5.0, f"native mining too slow: {dt:.2f}s for {len(src)} edges"
