"""Generate the golden accuracy fixture (run once; artifacts are committed).

This is the training-level analog of the reference's
miscs/check-correctness/check-correctness.py:95-123: a fixed small dataset
is checked in as bsnap files, and the expected loss/accuracy trajectory is
computed by the PURE-NUMPY oracle (tests/oracle.py gcn_loss_and_grads +
adam_step) trained independently of jax. tests/test_golden.py asserts that
Engine and ShardedEngine reproduce this trajectory — an end-to-end training
golden that does not share the jax compute path.

Usage:  python tools/make_golden_fixture.py   (rewrites tests/data/golden/)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

V, DEG, F, C = 400, 6, 32, 6
EPOCHS = 20
LR = 0.01
SEED = 77


def train_numpy_oracle(g, dims, epochs, lr):
    from dorylus_tpu.common.config import TRAIN_PORTION
    from dorylus_tpu.models.init import xavier
    from oracle import adam_step, gcn_loss_and_grads, gcn_forward, np_softmax

    S = g.dense_norm_adj().astype(np.float64)
    X = g.features.astype(np.float64)
    onehot = np.eye(g.num_classes, dtype=np.float64)[g.labels]
    train_mask, val_mask, test_mask = (m.astype(np.float64) for m in g.masks())
    denom = g.num_vertices * TRAIN_PORTION

    Ws = [xavier(dims[i], dims[i + 1], seed=8888).astype(np.float64)
          for i in range(len(dims) - 1)]
    ms = [np.zeros_like(w) for w in Ws]
    vs = [np.zeros_like(w) for w in Ws]

    def evaluate(mask):
        logits = gcn_forward(S, X, Ws)[-1][2]
        preds = np_softmax(logits)
        idx = mask > 0
        correct = (preds[idx].argmax(1) == g.labels[idx]).sum()
        ce = -np.log(np.maximum(preds[idx, g.labels[idx]], 1e-30))
        return float(correct) / idx.sum(), float(ce.mean())

    losses, val_accs, val_losses = [], [], []
    for epoch in range(epochs):
        loss, dWs = gcn_loss_and_grads(S, X, Ws, onehot, train_mask, denom)
        t = epoch + 1  # reference Adam advances t once per epoch
        for l in range(len(Ws)):
            Ws[l], ms[l], vs[l] = adam_step(Ws[l], dWs[l], ms[l], vs[l], t, lr=lr)
        losses.append(float(loss))
        acc, vloss = evaluate(val_mask)
        val_accs.append(acc)
        val_losses.append(vloss)
    test_acc, _ = evaluate(test_mask)
    return losses, val_accs, val_losses, test_acc


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")  # no accelerator needed to make data

    from dorylus_tpu.graph.dataio import save_dataset, load_dataset
    from dorylus_tpu.graph.graph import synthetic_graph

    out = REPO / "tests" / "data" / "golden"
    out.mkdir(parents=True, exist_ok=True)
    g = synthetic_graph(V, DEG, F, C, seed=SEED)
    save_dataset(out, g)
    # Train from the RELOADED dataset so the golden run exercises the exact
    # bytes the test will load.
    g2 = load_dataset(out, feature_dim=F)
    assert g2.num_edges == g.num_edges

    dims = [F, 16, C]
    losses, val_accs, val_losses, test_acc = train_numpy_oracle(
        g2, dims, EPOCHS, LR)
    golden = {
        "dims": dims, "epochs": EPOCHS, "lr": LR, "seed": SEED,
        "num_vertices": g2.num_vertices, "num_edges": g2.num_edges,
        "train_loss": losses, "val_acc": val_accs, "val_loss": val_losses,
        "test_acc": test_acc,
    }
    (out / "golden.json").write_text(json.dumps(golden, indent=1))
    print(json.dumps({"final_train_loss": losses[-1],
                      "final_val_acc": val_accs[-1], "test_acc": test_acc}))


if __name__ == "__main__":
    main()
