"""Adam optimizer matching the reference weight server bit-for-bit in math.

Reference: src/weight-server/AdamOptimizer.{hpp,cpp} —
    BETA1=0.9, BETA2=0.999, EPSILON=1e-7, WEIGHT_DECAY=0
    lr_t = lr * sqrt(1 - B2^t) / (1 - B1^t)        (nextIteration, :29-34)
    m = B1*m + (1-B1)*g ;  v = B2*v + (1-B2)*g^2
    w -= lr_t * m / (sqrt(v) + eps)                 (update, :36-51)

The step counter t advances once per *epoch* (nextIteration fires when
layer 0 — the last layer updated in backward order — completes), and the
constructor pre-increments so the first update uses t=1; we replicate both.

The reference's weight-server tier (replication across servers, ghost-update
ACK counting, versioned weight stashing for async chunks —
weightserver.cpp:89-187, weighttensor.cpp) collapses here to replicated
parameter pytrees + psum'd gradients inside the compiled step; the optimizer
below is the only surviving state machine.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import jax
import jax.numpy as jnp


class AdamState(NamedTuple):
    step: jnp.ndarray  # scalar int32, = reference `epochs` counter
    m: Any  # momentum pytree
    v: Any  # decay pytree


def adam_init(params: Any) -> AdamState:
    zeros = jax.tree.map(jnp.zeros_like, params)
    return AdamState(step=jnp.zeros((), jnp.int32), m=zeros,
                     v=jax.tree.map(jnp.zeros_like, params))


def adam_update(
    params: Any,
    grads: Any,
    state: AdamState,
    lr: float | jnp.ndarray = 0.01,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-7,
    weight_decay: float = 0.0,
) -> tuple[Any, AdamState]:
    t = state.step + 1
    tf = t.astype(jnp.float32)
    lr_t = lr * jnp.sqrt(1.0 - beta2 ** tf) / (1.0 - beta1 ** tf)

    def upd(p, g, m, v):
        gt = g + weight_decay * p
        m = beta1 * m + (1.0 - beta1) * gt
        v = beta2 * v + (1.0 - beta2) * gt * gt
        return p - lr_t * m / (jnp.sqrt(v) + eps), m, v

    out = jax.tree.map(upd, params, grads, state.m, state.v)
    # out is a pytree of 3-tuples at the leaves; unzip.
    new_params = jax.tree.map(lambda x: x[0], out,
                              is_leaf=lambda x: isinstance(x, tuple))
    new_m = jax.tree.map(lambda x: x[1], out,
                         is_leaf=lambda x: isinstance(x, tuple))
    new_v = jax.tree.map(lambda x: x[2], out,
                         is_leaf=lambda x: isinstance(x, tuple))
    return new_params, AdamState(step=t, m=new_m, v=new_v)


def sgd_update(params: Any, grads: Any, lr: float | jnp.ndarray) -> Any:
    """Plain SGD, the reference's non-Adam path (weighttensor.cpp:253-262)."""
    return jax.tree.map(lambda p, g: p - lr * g, params, grads)


def decay_lr(lr: float, epoch: int, every: int = 20, factor: float = 0.7) -> float:
    """LR decay hook mirroring WeightServer's (disabled-by-default) schedule
    (weightserver.cpp:296-305)."""
    return lr * (factor ** (epoch // every))
