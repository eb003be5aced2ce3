"""Halo (ghost vertex) exchange as a single collective.

Replaces the reference's push-based scatter + ghost-receiver thread pair
(Engine::scatterGCN gcn_ops.cpp:204-260 — batch boundary features per
destination node over ZMQ PUB; ghostReceiverGCN :262-362 — parse and write
into the "fg"/"bg" ghost tensors) with one all_to_all per layer:

  1. gather: buf[p] = h[send_idx[p]]  — rows peer p needs from us
  2. all_to_all over the 'graph' mesh axis (XLA-scheduled; NCCL on GPUs)
  3. the received (n_shards, max_h, F) block IS the ghost tensor; edge
     source indices address concat(local, ghosts) directly.

The backward pass of this function (gather -> all_to_all -> concat) is
derived by autodiff: scatter-add of ghost gradients back to their owner —
exactly the reference's backward scatter of "bg" gradients.

Two wire formats (TrainConfig.halo):

  * padded (the default, "auto"): every (shard, peer) pair ships max_h
    rows — the fixed-shape all_to_all every backend lowers, including
    XLA:CPU for the hermetic suite and the virtual-mesh dryrun
    (ragged-all-to-all is UNIMPLEMENTED in the CPU ThunkEmitter).
  * ragged (only when asked for, n > 1): lax.ragged_all_to_all ships
    each pair's EXACT row count — the reference's exact per-destination
    ZMQ scatter (gcn_ops.cpp:204-260) — while writing into the SAME
    padded (n·max_h, F) ghost layout, so edge source indices are
    unchanged. Plan arrays from build_ragged_plan; backward is the
    reverse ragged exchange + a sorted segment_sum (no scatter).
    Numpy-emulation-tested on CPU (tests/test_ragged_halo.py). Before the
    big program compiles, a tiny ragged_all_to_all of the same dtype/rank
    runs and is checked numerically (ragged_canary); when it fails, the
    engine raises RaggedHaloUnavailable instead of training on a format
    the user did not ask for.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.parallel.mesh import GRAPH_AXIS


class RaggedHaloUnavailable(RuntimeError):
    """halo="ragged" was asked for, but lax.ragged_all_to_all failed its
    canary on this mesh."""


def halo_exchange(h: jnp.ndarray, send_idx: jnp.ndarray,
                  axis_name: str = GRAPH_AXIS, plan=None) -> jnp.ndarray:
    """h: (vp, F) local features; send_idx: (n_shards, max_h) local rows.
    Returns feature table (vp + n_shards*max_h, F): local rows then ghosts
    grouped by owner shard. Must run inside shard_map over `axis_name`."""
    return jnp.concatenate([h, halo_recv(h, send_idx, axis_name, plan)],
                           axis=0)


def halo_recv(h: jnp.ndarray, send_idx: jnp.ndarray,
              axis_name: str = GRAPH_AXIS, plan=None) -> jnp.ndarray:
    """Ghost rows only: (n_shards*max_h, F). Used by the overlap path,
    where interior aggregation proceeds concurrently with this collective.

    plan: optional (order, rows) from build_recv_plan — routes the
    backward through a SORTED segment_sum instead of the gather-VJP's
    XLA scatter-add (the degree kernel avoids scatter-add for the same
    reason, ops/degree_spmm.py)."""
    if plan is not None:
        return _halo_recv_planned(axis_name, h, send_idx, plan[0], plan[1])
    buf = h[send_idx]  # (n_shards, max_h, F)
    recv = jax.lax.all_to_all(buf, axis_name, split_axis=0, concat_axis=0,
                              tiled=True)
    return recv.reshape(-1, h.shape[1])


def make_halo_fn(halo_args, overlap: bool, multi: bool):
    """One halo callable from the batch's halo args — THE dispatch shared
    by the train step and the stage profiler (wire format, planned
    backward, and overlap semantics must never diverge between them).
    halo_args = (send_idx, order, rows, ragged_plan); overlap=True
    returns ghost rows only (halo_recv), else the full feature table.
    None when single-shard."""
    if not multi:
        return None
    send_idx, order, rows, rg = halo_args
    if rg is not None:
        # Exact wire format: lax.ragged_all_to_all ships each pair's
        # exact row count — gcn_ops.cpp:204-260 analog.
        n_sh, mh = send_idx.shape

        def recv(h):
            return ragged_halo_recv(GRAPH_AXIS, n_sh, mh, h, rg)

        if overlap:
            return recv
        return lambda h: jnp.concatenate([h, recv(h)], axis=0)
    plan = None if order is None else (order, rows)
    if overlap:
        return lambda h: halo_recv(h, send_idx, plan=plan)
    return lambda h: halo_exchange(h, send_idx, plan=plan)


def build_recv_plan(send_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side backward plan for one shard's send lists: (order, rows)
    with order a stable argsort of the flattened send_idx and rows the
    sorted local row per flat send slot. The halo backward then reduces
    returned ghost gradients with segment_sum(g[order], rows, sorted=True)
    — rows repeat when a local row is sent to several peers, and the
    zero-padded send slots simply accumulate zero into row 0."""
    flat = np.asarray(send_idx).ravel()
    order = np.argsort(flat, kind="stable").astype(np.int32)
    return order, flat[order].astype(np.int32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _halo_recv_planned(axis_name, h, send_idx, order, rows):
    buf = h[send_idx]  # (n_shards, max_h, F)
    recv = jax.lax.all_to_all(buf, axis_name, split_axis=0, concat_axis=0,
                              tiled=True)
    return recv.reshape(-1, h.shape[1])


def _planned_fwd(axis_name, h, send_idx, order, rows):
    out = _halo_recv_planned(axis_name, h, send_idx, order, rows)
    # dtype token: residuals must be jax values, not dtype objects.
    return out, (send_idx, order, rows, h.shape[0], jnp.zeros((), h.dtype))


def _planned_bwd(axis_name, res, g):
    send_idx, order, rows, vp, dtype_token = res
    dtype = dtype_token.dtype
    n, mh = send_idx.shape
    # Ghost-gradient return trip: the tiled split0/concat0 all_to_all is a
    # block permutation (i -> j), so applying it again sends each block
    # back to its owner (the reference's backward scatter of "bg" grads,
    # gcn_ops.cpp backward dir).
    gmine = jax.lax.all_to_all(g.reshape(n, mh, -1), axis_name,
                               split_axis=0, concat_axis=0, tiled=True)
    gflat = gmine.reshape(n * mh, -1).astype(jnp.float32)
    dh = jax.ops.segment_sum(gflat[order], rows, num_segments=vp,
                             indices_are_sorted=True)
    return dh.astype(dtype), None, None, None


_halo_recv_planned.defvjp(_planned_fwd, _planned_bwd)


# ---------------------------------------------------------------------------
# Exact (ragged) halo: the reference's per-destination exact scatter.
# ---------------------------------------------------------------------------


def ragged_canary(mesh, dtype=jnp.float32) -> bool:
    """First-use canary for lax.ragged_all_to_all on this mesh.

    Runs a tiny exchange of the production shape class (rank-2 operand,
    same dtype, every (owner, receiver) pair shipping one exact row into
    a strided output layout — the ragged_halo_recv pattern) and checks
    the received rows NUMERICALLY. Returns False on any exception or
    wrong result, so the engine can refuse the format before the big
    program ever compiles (a lowering or layout surprise becomes a clear
    error, not a crash deep inside the training program).

    Payloads are small INTEGERS, exact in bf16/fp8 for any shard count up
    to 256 — fractional encodings like p + q/8 silently round at >=30
    shards in bf16 and would false-fail a healthy mesh — and the verdict
    leaves the device as a REPLICATED mismatch count (psum'd scalar),
    because fetching a sharded result spans non-addressable devices on a
    multi-controller mesh."""
    import functools as _ft

    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    n = mesh.shape[GRAPH_AXIS]
    if n > 256:
        # Payload exactness only holds to 256 shards — treat a wider mesh
        # as a canary failure.
        from dorylus_tpu.common.logging import log
        log("ragged halo canary skipped: %d shards > 256 (payload "
            "exactness bound)", n)
        return False
    try:
        @_ft.partial(shard_map, mesh=mesh,
                     in_specs=(P(GRAPH_AXIS), P(GRAPH_AXIS)),
                     out_specs=P(), check_vma=False)
        def tiny(x, want):
            x = x[0]        # (n, 2) — row q is what I send to peer q
            want = want[0]  # (2n, 2) — what I must receive
            out = jnp.zeros((2 * n, x.shape[1]), x.dtype)
            ones = jnp.ones((n,), jnp.int32)
            me = jax.lax.axis_index(GRAPH_AXIS)
            r = jax.lax.ragged_all_to_all(
                x, out,
                jnp.arange(n, dtype=jnp.int32),      # in_off
                ones,                                 # send_sz
                jnp.full((n,), 2 * me, jnp.int32),    # out_off (strided)
                ones,                                 # recv_sz
                axis_name=GRAPH_AXIS)
            bad = (r != want).sum().astype(jnp.float32)
            return jax.lax.psum(bad, GRAPH_AXIS)

        # Shard p sends row (p, q) to peer q; receiver p's slot 2q must
        # hold (q, p). Integer payloads: exact in every dtype we ship.
        base = np.arange(n, dtype=np.float32)
        x = np.zeros((n, n, 2), np.float32)
        x[..., 0] = base[:, None]   # sender id
        x[..., 1] = base[None, :]   # receiver id
        want = np.zeros((n, 2 * n, 2), np.float32)
        want[:, 0::2, 0] = base[None, :]   # owner id at slot 2q
        want[:, 0::2, 1] = base[:, None]   # my id
        sh = NamedSharding(mesh, P(GRAPH_AXIS))
        xd = jax.device_put(x.astype(dtype), sh)
        wd = jax.device_put(want.astype(dtype), sh)
        return float(tiny(xd, wd)) == 0.0
    except Exception as e:  # noqa: BLE001 — ANY failure fails the canary
        from dorylus_tpu.common.logging import log
        log("ragged halo canary failed (%s: %s)", type(e).__name__, e)
        return False

def build_ragged_plan(sharded) -> dict:
    """Host-side plan for the exact-row halo exchange, stacked on a
    leading shard axis (rides the sharded batch like the SpMM plans).

    The wire carries each (owner q -> receiver p) pair's EXACT ghost-row
    count cnt[q, p]; the received rows still land at the padded layout
    offset q*max_h on p, so the feature-table indices partition_graph
    baked into edge sources are untouched. Counts are recovered from each
    receiver's ghost ranks (dense [0, cnt) by construction,
    graph/partition.py ghost_rank).

    Per-shard leaves (squeeze the leading axis inside shard_map):
      rows     (S,)  exact send rows, grouped by destination peer
      in_off   (n,)  operand offset of peer p's block
      send_sz  (n,)  cnt[me, p]
      out_off  (n,)  where my block lands on p  (= me*max_h, all p)
      recv_sz  (n,)  cnt[q, me]
      bwd_out_off (n,)  where my returned grad block lands on q
                        (= q's in_off[me])
      order/rsort (S,)  sorted segment-sum backward plan (build_recv_plan
                        analog over the exact rows)
    """
    n, vp, mh = sharded.n_shards, sharded.vp, sharded.max_h
    cnt = np.zeros((n, n), np.int64)  # [owner, receiver]
    for p, s in enumerate(sharded.shards):
        src = np.asarray(s.src[: s.num_edges])
        gsrc = src[src >= vp] - vp
        # Ghost ranks are dense [0, cnt) per owner block by construction
        # (graph/partition.py ghost_rank), so cnt = max rank + 1 — one
        # O(E_p) grouped max per shard (the round-4 version masked the
        # edge array once per (owner, receiver) pair: O(n²·E), a real
        # wall at the reference's 32-shard width on big graphs).
        mx = np.full(n, -1, np.int64)
        np.maximum.at(mx, gsrc // mh, gsrc % mh)
        cnt[:, p] = mx + 1
    S = max(int(cnt.sum(axis=1).max()), 1)
    in_off = np.zeros((n, n), np.int64)
    np.cumsum(cnt[:, :-1], axis=1, out=in_off[:, 1:])
    rows = np.zeros((n, S), np.int32)
    for q, s in enumerate(sharded.shards):
        for p in range(n):
            c = int(cnt[q, p])
            rows[q, in_off[q, p]: in_off[q, p] + c] = \
                np.asarray(s.send_idx[p][:c])
    order = np.argsort(rows, axis=1, kind="stable").astype(np.int32)
    rsort = np.take_along_axis(rows, order, axis=1)
    return {
        "rows": rows,
        "in_off": in_off.astype(np.int32),
        "send_sz": cnt.astype(np.int32),
        "out_off": np.tile((np.arange(n, dtype=np.int32) * mh)[:, None],
                           (1, n)),
        "recv_sz": cnt.T.astype(np.int32).copy(),
        "bwd_out_off": in_off.T.astype(np.int32).copy(),
        "order": order,
        "rsort": rsort,
    }


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def ragged_halo_recv(axis_name, n_shards, max_h, h, rg):
    """Ghost rows only, exact wire traffic: (n_shards*max_h, F) with the
    slots past each pair's exact count left zero (never referenced by
    real edges). Must run inside shard_map over `axis_name`."""
    buf = h[rg["rows"]]  # (S, F) exact rows, grouped by destination
    out = jnp.zeros((n_shards * max_h, h.shape[1]), h.dtype)
    return jax.lax.ragged_all_to_all(
        buf, out, rg["in_off"], rg["send_sz"], rg["out_off"],
        rg["recv_sz"], axis_name=axis_name)


def _ragged_fwd(axis_name, n_shards, max_h, h, rg):
    out = ragged_halo_recv(axis_name, n_shards, max_h, h, rg)
    return out, (rg, h.shape[0], jnp.zeros((), h.dtype))


def _ragged_bwd(axis_name, n_shards, max_h, res, g):
    rg, vp, dtype_token = res
    # Reverse exact exchange: each received block returns to its owner,
    # landing at the owner's operand offset for me (bwd_out_off = the
    # transposed in_off); then the sorted segment_sum accumulates per
    # local row (rows repeat across peers). Slots past my exact send
    # total stay zero (rows pad = 0 accumulates zeros into row 0).
    S = rg["rows"].shape[0]
    outb = jnp.zeros((S, g.shape[1]), g.dtype)
    back = jax.lax.ragged_all_to_all(
        g, outb, jnp.arange(n_shards, dtype=jnp.int32) * max_h,
        rg["recv_sz"], rg["bwd_out_off"], rg["send_sz"],
        axis_name=axis_name)
    gf = back.astype(jnp.float32)
    dh = jax.ops.segment_sum(gf[rg["order"]], rg["rsort"],
                             num_segments=vp, indices_are_sorted=True)
    return dh.astype(dtype_token.dtype), None


ragged_halo_recv.defvjp(_ragged_fwd, _ragged_bwd)
