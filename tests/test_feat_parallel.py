"""Feature/tensor parallelism (mesh 'feat' axis, models/gcn.py
_forward_tp): slicing the aggregation into F/m column blocks and
psum-assembling the layer matmuls must reproduce the single-device
trajectory exactly — an extension of this rebuild with no reference analog
(the reference has only graph parallelism)."""

import jax
import numpy as np
import pytest

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine.engine import Engine
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu.parallel.mesh import make_mesh
from dorylus_tpu.parallel.train_step import ShardedEngine

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 devices (virtual CPU mesh)")


@pytest.mark.parametrize("n,m,kernel", [(2, 2, "xla"), (1, 4, "xla"),
                                        (2, 2, "hyb"), (2, 4, "hyb")])
def test_tp_matches_single_device(n, m, kernel):
    g = synthetic_graph(400, 6, 16, 5, seed=13)
    layers = LayerConfig([16, 8, 5])
    cfg = TrainConfig(epochs=5, eval_every=5, kernel=kernel, reuse="off")
    r1 = Engine(g, layers, cfg).run()
    import dataclasses
    cfg2 = dataclasses.replace(cfg, feat_shards=m, num_shards=n)
    r2 = ShardedEngine(g, layers, cfg2,
                       mesh=make_mesh(n, feat_shards=m)).run()
    for e1, e2 in zip(r1.epochs, r2.epochs):
        np.testing.assert_allclose(e1.loss, e2.loss, rtol=5e-4, atol=1e-6)
    assert abs(r1.final_accuracy - r2.final_accuracy) < 0.03


def test_tp_rejects_indivisible_width():
    g = synthetic_graph(200, 5, 10, 4, seed=3)
    with pytest.raises(AssertionError, match="divisible"):
        ShardedEngine(g, LayerConfig([10, 8, 4]),
                      TrainConfig(epochs=1, feat_shards=4, reuse="off"),
                      mesh=make_mesh(2, feat_shards=4))


@pytest.mark.parametrize("n,m,kernel", [(2, 2, "hyb"), (1, 4, "xla"),
                                        (2, 2, "xla")])
def test_tp_gat_matches_single_device(n, m, kernel):
    """GAT TP: block-wise attention matvec + sliced (hyb) or
    full-replicated (xla fallback / indivisible width) aggregation must
    reproduce the single-device trajectory — including d(a) assembly
    under the dual-axis grad reduction."""
    g = synthetic_graph(240, 5, 12, 4, seed=17)
    layers = LayerConfig([12, 8, 4])  # output width 4 % 2 == 0 and 4 % 4
    cfg = TrainConfig(model="gat", epochs=4, eval_every=4,
                      learning_rate=0.005, kernel=kernel, reuse="off")
    r1 = Engine(g, layers, cfg).run()
    import dataclasses
    cfg2 = dataclasses.replace(cfg, feat_shards=m, num_shards=n)
    r2 = ShardedEngine(g, layers, cfg2,
                       mesh=make_mesh(n, feat_shards=m)).run()
    for e1, e2 in zip(r1.epochs, r2.epochs):
        np.testing.assert_allclose(e1.loss, e2.loss, rtol=1e-3, atol=1e-5)


def test_tp_gat_indivisible_output_width():
    """Widths that don't divide feat_shards fall back to full-replicated
    aggregation per layer (the column-mask za keeps d(a) block-local) —
    output classes=5 with m=2."""
    g = synthetic_graph(240, 5, 12, 5, seed=19)
    layers = LayerConfig([12, 8, 5])  # 5 % 2 != 0 -> full branch layer 2
    cfg = TrainConfig(model="gat", epochs=4, eval_every=0,
                      learning_rate=0.005, kernel="hyb", reuse="off")
    r1 = Engine(g, layers, cfg).run()
    import dataclasses
    cfg2 = dataclasses.replace(cfg, feat_shards=2, num_shards=2)
    r2 = ShardedEngine(g, layers, cfg2,
                       mesh=make_mesh(2, feat_shards=2)).run()
    for e1, e2 in zip(r1.epochs, r2.epochs):
        np.testing.assert_allclose(e1.loss, e2.loss, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("model_name,lr", [("gcn", 0.01), ("gat", 0.005)])
@pytest.mark.slow
def test_tp_gradients_exact(model_name, lr):
    """DIRECT gradient parity (not just loss trajectories): Adam is
    invariant to per-parameter constant scalings, so trajectory tests
    alone cannot catch the manual-mode psum-transpose over-count this
    path once had (grad(lax.psum) under check_vma=False is ANOTHER psum;
    see _psum_feat in models/gcn.py). Compares the dual-axis-psum'd TP
    gradients against single-device jax.grad element-wise."""
    import dataclasses
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from dorylus_tpu.parallel.halo import make_halo_fn
    from dorylus_tpu.parallel.mesh import FEAT_AXIS, GRAPH_AXIS
    from dorylus_tpu.parallel.train_step import _local_batch

    g = synthetic_graph(240, 5, 12, 4, seed=17)
    layers = LayerConfig([12, 8, 4])
    cfg = TrainConfig(model=model_name, epochs=1, eval_every=0,
                      learning_rate=lr, kernel="hyb", reuse="off")
    eng1 = Engine(g, layers, cfg)
    g1 = jax.grad(lambda p: eng1.model.loss(p, eng1.batch))(eng1.params)
    cfg2 = dataclasses.replace(cfg, feat_shards=2, num_shards=2)
    eng2 = ShardedEngine(g, layers, cfg2, mesh=make_mesh(2, feat_shards=2))
    model, denom = eng2.model, eng2.sharded.denom

    @partial(shard_map, mesh=eng2.mesh, in_specs=(P(), P(GRAPH_AXIS)),
             out_specs=P(), check_vma=False)
    def gradfn(params, arrs):
        batch, halo_args = _local_batch(arrs, denom, False)
        halo = make_halo_fn(halo_args, False, True)
        grads = jax.grad(lambda p: model.loss(p, batch, halo=halo))(params)
        return jax.lax.psum(grads, (GRAPH_AXIS, FEAT_AXIS))

    g2 = gradfn(eng2.params, eng2.arrs)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g2[k]), np.asarray(g1[k]),
                                   rtol=1e-4, atol=1e-5)


def test_tp_with_reuse_matches_plain():
    """TP composes with the pair-reuse rewrite (the budget is computed
    against the SLICED table width under TP); trajectory must match the
    plain single-device run on an overlap-heavy graph."""
    from test_reuse import _overlap_graph_obj

    g = _overlap_graph_obj()
    layers = LayerConfig([24, 12, 5])
    kw = dict(epochs=4, eval_every=0, kernel="hyb")
    r1 = Engine(g, layers, TrainConfig(reuse="off", **kw)).run()
    import dataclasses
    cfg2 = TrainConfig(reuse="pairs", feat_shards=2, num_shards=2, **kw)
    eng = ShardedEngine(g, layers, cfg2, mesh=make_mesh(2, feat_shards=2))
    from dorylus_tpu.ops.reuse_sharded import ShardedReuseSpMM
    assert isinstance(eng.model.spmm_op, ShardedReuseSpMM)
    r2 = eng.run()
    for e1, e2 in zip(r1.epochs, r2.epochs):
        np.testing.assert_allclose(e1.loss, e2.loss, rtol=2e-3, atol=2e-3)


def test_tp_mesh_mismatch_raises():
    g = synthetic_graph(200, 5, 16, 4, seed=3)
    with pytest.raises(ValueError, match="feat axis"):
        ShardedEngine(g, LayerConfig([16, 8, 4]),
                      TrainConfig(epochs=1, feat_shards=2, reuse="off"),
                      mesh=make_mesh(4))  # no feat axis of size 2
