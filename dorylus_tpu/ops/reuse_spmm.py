"""Pair-reuse aggregation op: hyb SpMM over a rewritten graph.

Wraps ops/hyb_spmm.py's mask-mode pass with the graph/reuse.py pair
rewrite: the gather table is h with appended pair rows (h[a] + h[b] for
mined common neighbor pairs), and the slot plans are built from the
rewritten edge list — fewer gathered rows for the same exact operator.

Only unit-weight inner sums are supported — which covers both production
models (see graph/reuse.py): GCN through its rank-1 norm factorization
(edge value = f(src)·f(dst), f = (deg+1)^-1/2, reference
dataloader.cpp:153-185) and GAT through its dst-only attention. Dynamic
per-edge values (`apply`) cannot ride a pair rewrite and raise.

Backward: the rewrite computes EXACTLY the original operator A, so the
VJP is Aᵀ — served by an independently-mined rewrite of the transposed
graph. No scatter ops appear anywhere (autodiff of the pair build would
emit (P, F) scatter-adds; the custom VJP routes around them).

Same duck-type as HybSpMM / DegreeSpMM: `.arrays` rides the batch
pytree; apply_static (GCN) / apply_dst (GAT) dispatch from the models.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dorylus_tpu.graph.reuse import mine_reuse
from dorylus_tpu.ops.hyb_spmm import _hyb_pass, build_hyb_plan


def _build_table(h, levels):
    tbl = h
    for p in levels:
        tbl = jnp.concatenate([tbl, tbl[p[:, 0]] + tbl[p[:, 1]]])
    return tbl


# static = (num_in, num_out, gather_dtype, n_iso_fwd, n_iso_bwd
#           [, msgs_budget]) — budget = the engine-scoped scan-chunk
# guard (absent/0 = the hyb_spmm module default).
@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def reuse_unit_pass(static, arrs, h):
    """out[v] = sum_{u in N(v)} h[u] over the rewritten fwd plan."""
    _, num_out, gdt, ni = static[:4]
    bud = static[5] if len(static) > 5 else 0
    return _hyb_pass(_build_table(h, arrs["lvl_fwd"]), arrs["fwd"],
                     num_out, "mask", None, gdt, n_iso=ni, budget=bud)


def _fwd(static, arrs, h):
    # Zero-size dtype token: dh must come back in h's dtype (bf16 under
    # compute_dtype=bf16), not the f32 primal output's — returning f32
    # made the h*f multiply's transpose throw at trace time (r5 review).
    return reuse_unit_pass(static, arrs, h), (arrs, jnp.zeros((), h.dtype))


def _bwd(static, res, gout):
    arrs, h_tok = res
    num_in, _, gdt = static[:3]
    nib = static[4]
    bud = static[5] if len(static) > 5 else 0
    # Exactness of the rewrite => the Jacobian is the ORIGINAL transposed
    # operator, served by the transposed graph's own rewrite.
    dh = _hyb_pass(_build_table(gout.astype(jnp.float32), arrs["lvl_bwd"]),
                   arrs["bwd"], num_in, "mask", None, gdt, n_iso=nib,
                   budget=bud)
    d_arrs = jax.tree.map(
        lambda x: jnp.zeros_like(x) if jnp.issubdtype(x.dtype, jnp.floating)
        else None, arrs)
    return d_arrs, dh.astype(h_tok.dtype)


reuse_unit_pass.defvjp(_fwd, _bwd)


class ReuseSpMM:
    """Drop-in aggregation op (HybSpMM protocol) with pair reuse.

    rank1_factor: per-vertex f with edge value = f(src)·f(dst) (GCN:
    sqrt(self_norm)); enables apply_static. None for unit/dst-weighted
    aggregation (GAT apply_dst)."""

    def __init__(self, src, dst, num_in: int, num_out: int,
                 max_width: int = 512, gather_dtype=None,
                 feature_dim: int = 128, rank1_factor=None,
                 min_uses: int = 3, passes: int = 1, max_pairs: int = 0):
        """max_pairs: per-pass pair budget (0 = unlimited) — mine_reuse
        keeps the highest-count pairs, bounding the appended table
        rows."""
        assert num_in == num_out, "reuse op is single-shard (square) only"
        src = np.asarray(src)
        dst = np.asarray(dst)
        self.num_in, self.num_out = num_in, num_out
        self.has_static_vals = rank1_factor is not None
        fwd = mine_reuse(src, dst, num_out, min_uses=min_uses, passes=passes,
                         max_pairs=max_pairs)
        bwd = mine_reuse(dst, src, num_in, min_uses=min_uses, passes=passes,
                         max_pairs=max_pairs)
        self.plan_fwd, self.plan_bwd = fwd, bwd
        pf = build_hyb_plan(fwd.src, fwd.dst, None, num_out, max_width)
        pb = build_hyb_plan(bwd.src, bwd.dst, None, num_in, max_width)
        self.rows_fwd = fwd.stats["rows_after"]
        n_iso = []
        for p in (pf, pb):
            p.pop("n_slots", None)
            n_iso.append(p.pop("_n_iso", None))
            p.pop("e2s", None)  # mask mode never maps slots back to edges
            for b in p["buckets"]:
                b.pop("s2e", None)  # nor slot->edge within buckets
            if p["top"] is not None:
                p["top"].pop("s2e", None)
        self.arrays = {
            "fwd": jax.tree.map(jnp.asarray, pf),
            "bwd": jax.tree.map(jnp.asarray, pb),
            "lvl_fwd": tuple(jnp.asarray(l) for l in fwd.levels),
            "lvl_bwd": tuple(jnp.asarray(l) for l in bwd.levels),
        }
        if rank1_factor is not None:
            self.arrays["f"] = jnp.asarray(
                np.asarray(rank1_factor, np.float32))
        self.static = (num_in, num_out,
                       None if gather_dtype is None
                       else jnp.dtype(gather_dtype)) + tuple(n_iso) + (0,)

    @property
    def gather_itemsize(self) -> int:
        """Bytes per element of the gather table (4 = f32, 2 = bf16)."""
        gdt = self.static[2]
        return 4 if gdt is None else jnp.dtype(gdt).itemsize

    def set_msgs_budget(self, budget: int) -> None:
        """Engine-scoped msgs scan-chunk guard (fit_msgs_budget)."""
        self.static = self.static[:5] + (int(budget),)

    def apply_static(self, arrays, h):
        """GCN factorized norms: diag(f) · A_unit · diag(f) · h."""
        f = arrays["f"].astype(h.dtype)[:, None]
        u = reuse_unit_pass(self.static, arrays, h * f)
        return u * f.astype(u.dtype)

    def apply_dst(self, arrays, h, dst_val):
        """GAT dst-only attention: diag(dst_val) · A_unit · h."""
        u = reuse_unit_pass(self.static, arrays, h)
        return u * dst_val.astype(u.dtype)[:, None]

    def apply_unit(self, arrays, h):
        """Unit-weight aggregation (the regime-aware GAT ordering)."""
        return reuse_unit_pass(self.static, arrays, h)

    def apply(self, arrays, h, val):
        raise NotImplementedError(
            "pair reuse requires factorizable edge weights; dynamic "
            "per-edge values cannot ride a rewrite — use kernel='hyb'")
