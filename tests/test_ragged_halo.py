"""Exact (ragged) halo wire format (parallel/halo.py build_ragged_plan /
ragged_halo_recv): construction-level and numpy-emulation tests.

lax.ragged_all_to_all does not lower on XLA:CPU, so the collective itself
cannot execute in the hermetic suite; these tests instead pin (a) the
plan arrays against the padded layout's ground truth, (b) the FORWARD
result by emulating the documented ragged_all_to_all semantics in numpy
across all shards and comparing against the padded halo table, and
(c) the BACKWARD by emulating the reverse exchange + segment_sum and
comparing against the padded path's autodiff gradient. The engine rules
(TrainConfig.halo="auto" -> padded; an explicit "ragged" whose canary
fails raises) are asserted at the engine surface. Reference: exact per-destination scatter, gcn_ops.cpp:204-260.
"""

import jax
import numpy as np
import pytest

from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.parallel.halo import build_ragged_plan

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")


def emulate_ragged(operands, outputs, in_offs, send_szs, out_offs):
    """jax.lax.ragged_all_to_all semantics (its docstring), numpy: sender
    q's slice for peer p lands at q's output_offsets[p] on p."""
    n = len(operands)
    results = [o.copy() for o in outputs]
    for q in range(n):
        for p in range(n):
            c = int(send_szs[q][p])
            io, oo = int(in_offs[q][p]), int(out_offs[q][p])
            results[p][oo: oo + c] = operands[q][io: io + c]
    return results


@pytest.fixture(scope="module")
def setup():
    g = synthetic_graph(400, 6, 16, 5, seed=13)
    sg = partition_graph(g, 4, method="hash")  # hash: uneven pair counts
    rg = build_ragged_plan(sg)
    rng = np.random.default_rng(7)
    hs = [rng.normal(size=(sg.vp, 5)).astype(np.float32)
          for _ in range(sg.n_shards)]
    return g, sg, rg, hs


def _padded_tables(sg, hs):
    """Ground truth: the padded all_to_all's ghost block layout."""
    n, mh = sg.n_shards, sg.max_h
    tabs = []
    for p in range(n):
        t = np.zeros((n * mh, hs[0].shape[1]), np.float32)
        for q, sq in enumerate(sg.shards):
            t[q * mh: (q + 1) * mh] = hs[q][np.asarray(sq.send_idx[p])]
        tabs.append(t)
    return tabs


def test_plan_construction(setup):
    g, sg, rg, hs = setup
    n, mh = sg.n_shards, sg.max_h
    cnt = rg["send_sz"]
    # Wire-size invariant required by lax.ragged_all_to_all:
    # send_sizes == all_to_all(recv_sizes).
    assert (rg["recv_sz"] == cnt.T).all()
    assert (rg["bwd_out_off"] == rg["in_off"].T).all()
    # Exact counts == distinct ghost rows each receiver references
    # (recomputed independently from edge indices).
    for p, s in enumerate(sg.shards):
        src = np.asarray(s.src[: s.num_edges])
        gsrc = src[src >= sg.vp] - sg.vp
        for q in range(n):
            refs = gsrc[(gsrc // mh) == q] % mh
            assert cnt[q, p] == (len(np.unique(refs)) if len(refs) else 0)
    # Exact rows are the send_idx prefixes, grouped by destination.
    for q, s in enumerate(sg.shards):
        for p in range(n):
            o, c = int(rg["in_off"][q, p]), int(cnt[q, p])
            np.testing.assert_array_equal(
                rg["rows"][q, o: o + c], np.asarray(s.send_idx[p][:c]))
    # Padding on the wire is gone: rows shipped == rows needed.
    assert cnt.sum() == sum(
        len(np.unique(np.asarray(s.src[: s.num_edges])[
            np.asarray(s.src[: s.num_edges]) >= sg.vp]))
        for s in sg.shards)


def test_forward_emulation_matches_padded(setup):
    g, sg, rg, hs = setup
    n, mh = sg.n_shards, sg.max_h
    operands = [hs[q][rg["rows"][q]] for q in range(n)]
    outputs = [np.zeros((n * mh, 5), np.float32) for _ in range(n)]
    got = emulate_ragged(operands, outputs, rg["in_off"], rg["send_sz"],
                         rg["out_off"])
    want = _padded_tables(sg, hs)
    for p in range(n):
        for q in range(n):
            c = int(rg["send_sz"][q, p])
            blk = slice(q * mh, q * mh + c)
            np.testing.assert_allclose(got[p][blk], want[p][blk])
            # Slots past the exact count are zero (never referenced).
            assert (got[p][q * mh + c: (q + 1) * mh] == 0).all()


def test_backward_emulation_matches_padded_autodiff(setup):
    g, sg, rg, hs = setup
    n, mh = sg.n_shards, sg.max_h
    rng = np.random.default_rng(11)
    # Ghost-grad cotangents, zero on slots past each pair's exact count
    # (real programs never produce gradients there: no edge reads them).
    gs = []
    for p in range(n):
        gp = rng.normal(size=(n * mh, 5)).astype(np.float32)
        for q in range(n):
            gp[q * mh + int(rg["send_sz"][q, p]): (q + 1) * mh] = 0
        gs.append(gp)
    # Padded-path ground truth: dh[q][r] = sum of g over every slot row r
    # was sent to (the autodiff scatter-add of the all_to_all gather).
    want = [np.zeros((sg.vp, 5), np.float32) for _ in range(n)]
    for q, s in enumerate(sg.shards):
        for p in range(n):
            c = int(rg["send_sz"][q, p])
            rows = np.asarray(s.send_idx[p][:c])
            np.add.at(want[q], rows, gs[p][q * mh: q * mh + c])
    # Ragged backward: reverse exchange (roles swapped) + segment_sum.
    S = rg["rows"].shape[1]
    in_off_b = np.tile(np.arange(n, dtype=np.int32)[None, :] * mh, (n, 1))
    back = emulate_ragged(gs, [np.zeros((S, 5), np.float32)
                               for _ in range(n)],
                          in_off_b, rg["recv_sz"], rg["bwd_out_off"])
    for q in range(n):
        dh = np.zeros((sg.vp, 5), np.float32)
        np.add.at(dh, rg["rsort"][q], back[q][rg["order"][q]])
        np.testing.assert_allclose(dh, want[q], rtol=1e-6, atol=1e-6)


def test_engine_gate_cpu_auto_is_padded():
    """halo='auto' is the padded format and trains like halo='padded'; an
    explicitly requested 'ragged' hits the first-use canary, which FAILS
    on CPU (no lowering), and the engine raises instead of training on
    the padded format."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.parallel.halo import RaggedHaloUnavailable
    from dorylus_tpu.parallel.mesh import make_mesh
    from dorylus_tpu.parallel.train_step import ShardedEngine

    g = synthetic_graph(300, 5, 16, 5, seed=2)
    layers = LayerConfig([16, 8, 5])
    eng = ShardedEngine(g, layers, TrainConfig(epochs=1, eval_every=0),
                        mesh=make_mesh(4))
    assert "ragged" not in eng.arrs
    padded = ShardedEngine(g, layers, TrainConfig(epochs=1, eval_every=0,
                                                  halo="padded"),
                           mesh=make_mesh(4))
    np.testing.assert_allclose([e.loss for e in eng.run(2).epochs],
                               [e.loss for e in padded.run(2).epochs],
                               rtol=1e-6)
    with pytest.raises(RaggedHaloUnavailable):
        ShardedEngine(g, layers,
                      TrainConfig(epochs=1, eval_every=0, halo="ragged"),
                      mesh=make_mesh(4))


def test_canary_fake_pass_builds_ragged(monkeypatch):
    """Faking a canary PASS exercises the build side of the gate: the
    exact-wire plan arrays ship with the batch (what a healthy mesh
    gets)."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.parallel import train_step
    from dorylus_tpu.parallel.mesh import make_mesh

    import dorylus_tpu.parallel.halo as halo_mod
    monkeypatch.setattr(halo_mod, "ragged_canary",
                        lambda mesh, dtype=None: True)
    g = synthetic_graph(300, 5, 16, 5, seed=2)
    eng = train_step.ShardedEngine(
        g, LayerConfig([16, 8, 5]),
        TrainConfig(epochs=1, eval_every=0, halo="ragged"),
        mesh=make_mesh(4))
    assert "ragged" in eng.arrs
    assert eng.arrs["ragged"]["rows"].shape[0] == 4


def test_canary_fake_failure_falls_back(monkeypatch):
    """Faking a canary FAILURE with an explicit halo='ragged' raises
    RaggedHaloUnavailable: no silent fall-back to the padded format."""
    from dorylus_tpu.common.config import LayerConfig, TrainConfig
    from dorylus_tpu.parallel import train_step
    from dorylus_tpu.parallel.mesh import make_mesh

    import dorylus_tpu.parallel.halo as halo_mod
    monkeypatch.setattr(halo_mod, "ragged_canary",
                        lambda mesh, dtype=None: False)
    g = synthetic_graph(300, 5, 16, 5, seed=2)
    for model in ("gcn", "gat"):
        with pytest.raises(halo_mod.RaggedHaloUnavailable,
                           match="halo='padded'"):
            train_step.ShardedEngine(
                g, LayerConfig([16, 8, 5]),
                TrainConfig(model=model, epochs=1, eval_every=0,
                            halo="ragged"),
                mesh=make_mesh(4))


def test_canary_expectation_matches_ragged_semantics():
    """The canary's numeric expectation must agree with the documented
    ragged_all_to_all semantics (emulated in numpy) — a wrong expectation
    would fail healthy meshes. Payloads must also survive a bf16
    round-trip EXACTLY at the reference's 32-shard width (the first canary
    revision used p + q/8, which rounds at >=30 shards in bf16 and would
    have false-failed a healthy mesh)."""
    import jax.numpy as jnp
    import numpy as np

    for n in (2, 8, 32, 64):
        base = np.arange(n, dtype=np.float32)
        x = np.zeros((n, n, 2), np.float32)
        x[..., 0] = base[:, None]
        x[..., 1] = base[None, :]
        operands = [x[p] for p in range(n)]
        outputs = [np.zeros((2 * n, 2), np.float32) for _ in range(n)]
        ones = np.ones(n, np.int64)
        in_offs = [np.arange(n) for _ in range(n)]
        out_offs = [np.full(n, 2 * me) for me in range(n)]
        # emulate: sender q's row for peer p lands at q's out_off[p] on p
        got = emulate_ragged(operands, outputs, in_offs,
                             [ones] * n, out_offs)
        want = np.zeros((n, 2 * n, 2), np.float32)
        want[:, 0::2, 0] = base[None, :]
        want[:, 0::2, 1] = base[:, None]
        np.testing.assert_array_equal(np.stack(got), want)
        # bf16 exactness of both operand and expectation.
        for arr in (x, want):
            rt = np.asarray(jnp.asarray(arr, jnp.bfloat16)).astype(
                np.float32)
            np.testing.assert_array_equal(rt, arr)
