"""End-to-end single-device engine runs (Cora-shaped synthetic)."""

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine
from dorylus_tpu.graph.graph import synthetic_graph


def test_gcn_end_to_end_learns():
    g = synthetic_graph(600, 8, 32, 6, seed=7)
    eng = Engine(g, LayerConfig([32, 16, 6]), TrainConfig(epochs=40, eval_every=10))
    report = eng.run()
    assert report.final_accuracy is not None
    # Planted-structure graph: must beat random guessing (1/6) solidly.
    assert report.final_accuracy > 0.35, report.summary()
    assert len(report.epochs) == 40


def test_early_stop():
    g = synthetic_graph(400, 8, 32, 4, seed=9)
    cfg = TrainConfig(epochs=200, eval_every=1, target_accuracy=0.5)
    eng = Engine(g, LayerConfig([32, 16, 4]), cfg)
    report = eng.run()
    assert len(report.epochs) < 200


def test_gat_end_to_end():
    g = synthetic_graph(300, 6, 16, 4, seed=11)
    cfg = TrainConfig(model="gat", epochs=15, eval_every=5, learning_rate=0.005)
    eng = Engine(g, LayerConfig([16, 8, 4]), cfg)
    report = eng.run()
    assert report.final_accuracy is not None


def test_group_len_boundaries():
    """Eval now runs INSIDE the scanned group (lax.cond flags), so the
    default eval cadence no longer breaks groups; checkpoints, the
    early-stop mode, and the epochs_per_call cap still do."""
    import numpy as np

    from dorylus_tpu.common.config import TrainConfig
    from dorylus_tpu.engine.engine import AUTO_GROUP_CAP, eval_flags, group_len

    # Default (eval_every=1, no target acc): groups engage to the cap.
    cfg = TrainConfig()
    assert group_len(0, 100, cfg) == AUTO_GROUP_CAP
    assert group_len(0, 20, cfg) == 20  # tail truncates at end-1
    # Eval flags mark every epoch at the default cadence.
    assert eval_flags(0, 20, 20, cfg).all()
    cfg5 = TrainConfig(eval_every=5)
    assert group_len(1, 20, cfg5) == 19
    np.testing.assert_array_equal(
        eval_flags(1, 19, 20, cfg5),
        [(e % 5 == 0) or e == 19 for e in range(1, 20)])
    # target_accuracy: early stop must inspect accuracy promptly, so eval
    # boundaries bound the group again (weightserver.cpp:270-294).
    cfgt = TrainConfig(eval_every=5, target_accuracy=0.9)
    assert group_len(0, 20, cfgt) == 1
    assert group_len(1, 20, cfgt) == 5
    assert group_len(6, 20, cfgt) == 5
    # target_accuracy=0 means DISABLED (reference targetAcc=0 semantics,
    # matching ConvergeMonitor) — groups engage to the cap, not 1/epoch.
    cfgt0 = TrainConfig(eval_every=1, target_accuracy=0.0)
    assert group_len(0, 100, cfgt0) == AUTO_GROUP_CAP
    # The auto cap depends on nothing but AUTO_GROUP_CAP: no graph-size
    # budget shortens groups. An explicit epochs_per_call replaces it.
    assert group_len(0, 100, TrainConfig(epochs_per_call=40)) == 40
    assert group_len(0, 100, TrainConfig(epochs_per_call=40,
                                         eval_every=0)) == 40
    # explicit per-epoch mode
    cfg1 = TrainConfig(eval_every=0, epochs_per_call=1)
    assert group_len(3, 20, cfg1) == 1
    # no eval at all -> no flags
    cfg0 = TrainConfig(eval_every=0)
    assert group_len(0, 20, cfg0) == 20
    assert not eval_flags(0, 20, 20, cfg0).any()
    # checkpoint boundary
    cfgc = TrainConfig(eval_every=0, checkpoint_dir="/tmp/x",
                       checkpoint_every=4)
    assert group_len(0, 20, cfgc) == 4
    assert group_len(4, 20, cfgc) == 4
    # cap
    cfgcap = TrainConfig(eval_every=0, epochs_per_call=3)
    assert group_len(0, 20, cfgcap) == 3


def test_run_zero_epochs_is_noop():
    """group_len on an empty range returns 0 and run(0) terminates (the
    round-2 advisory: it hung forever with eval_every=0)."""
    from dorylus_tpu.engine.engine import group_len

    assert group_len(0, 0, TrainConfig(eval_every=0)) == 0
    assert group_len(5, 5, TrainConfig(eval_every=1)) == 0
    assert group_len(7, 3, TrainConfig(eval_every=0, epochs_per_call=1)) == 0
    g = synthetic_graph(200, 4, 16, 4, seed=3)
    eng = Engine(g, LayerConfig([16, 8, 4]), TrainConfig(eval_every=0))
    report = eng.run(0)
    assert len(report.epochs) == 0


def test_engine_gat_degree_matches_xla():
    """Single-device GAT: the degree kernel's dst-functional attention path
    (apply_dst) must train identically to the edgewise XLA path."""
    import numpy as np

    from dorylus_tpu.graph.graph import synthetic_graph

    g = synthetic_graph(500, 6, 16, 5, seed=33)
    layers = LayerConfig([16, 8, 5])
    cfg = dict(model="gat", epochs=4, eval_every=0, learning_rate=0.003)
    r_x = Engine(g, layers, TrainConfig(**cfg, kernel="xla")).run()
    r_d = Engine(g, layers, TrainConfig(**cfg, kernel="degree")).run()
    for a, b in zip(r_x.epochs, r_d.epochs):
        np.testing.assert_allclose(a.loss, b.loss, rtol=2e-3, atol=1e-6)
