"""Windowed Sakoe-Chiba banded DTW: O(T*W) compute, not just masking.

`ops/dtw.py` supports `band_frac` by masking out-of-band cells BIG but
still sweeps the full U width per row.  This module actually *bounds*
the work (SURVEY.md §5 long-sequence story): each row's DP state is a
W-wide window that slides along the stretched diagonal

    o(i) = clip(floor(i * (len_b-1)/(len_a-1)) - W/2, 0, U - W)

so compute and the assoc-scan width scale with the band, not the
sequence.  W is static; choose it from the band via `window_for_band`
(W >= 2*radius + 4 guarantees the window contains the whole band, making
results EXACTLY equal to the masked implementation/golden).  The window
realignment between rows is one dynamic slice (shift delta = o(i) -
o(i-1)), and the final cell is harvested in window coordinates.

Off the production path: vmapped ``lax.dynamic_slice`` with per-pair
starts lowers to a gather, and this XLA form measured far slower than
the full-width masked scan on the previous accelerator.  Banded matching
in production is ``DtwConfig(band_frac=...)`` through
pipeline.dtw_pairs, whose GPU kernel (kernels/dtw_fused_banded.py)
realises the O(T*W) bound.  Kept as an exact reference of the sliding
window.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dsp_asr.config import DtwConfig
from dsp_asr.ops.dtw import BIG, _minplus_combine, masked_cost


def window_for_band(band_frac: float, t: int, u: int, lane: int = 128) -> int:
    """Smallest lane-multiple window that contains the Sakoe-Chiba band."""
    radius = max(1.0, band_frac * max(t, u))
    w = int(2 * radius + 4)
    w = -(-w // lane) * lane
    return min(w, -(-u // lane) * lane)


def dtw_distance_windowed(a: jax.Array, b: jax.Array,
                          len_a: jax.Array, len_b: jax.Array,
                          window: int,
                          cfg: DtwConfig = DtwConfig(band_frac=0.1),
                          precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Banded DTW with a sliding W-wide DP window; a [T,F] vs b [U,F].

    Requires cfg.band_frac set (the band mask defines the semantics; the
    window only bounds compute).  Exact vs golden banded DTW when
    window >= 2*radius + 4.
    """
    assert cfg.band_frac is not None, "windowed DTW requires band_frac"
    if cfg.slope is not None:
        raise ValueError("dtw_distance_windowed implements the "
                         "unconstrained step set only; use impl='scan' "
                         "or 'fused_banded' for cfg.slope")
    t, f = a.shape
    u = b.shape[0]
    w = min(window, u)
    cost = masked_cost(a, b, len_a, len_b, cfg, precision)    # [T, U] banded BIG
    scale = (len_b - 1).astype(jnp.float32) / jnp.maximum(len_a - 1, 1)
    offsets = jnp.clip((jnp.arange(t).astype(jnp.float32) * scale).astype(jnp.int32)
                       - w // 2, 0, max(u - w, 0))            # [T]
    idx_w = jnp.arange(w)

    def row_step(carry, inp):
        d_prev, acc, o_prev = carry
        c_row, i, o = inp
        c_win = jax.lax.dynamic_slice(c_row, (o,), (w,))
        delta = o - o_prev
        # realign previous window: aligned[x] = d_prev[x + delta]
        padded = jnp.concatenate([d_prev, jnp.full((w,), BIG, cost.dtype)])
        aligned = jax.lax.dynamic_slice(padded, (jnp.clip(delta, 0, w),), (w,))
        # shift for the j-1 terms, with the virtual origin at (0, -1)
        start_val = jnp.where((i == 0) & (o == 0), 0.0, BIG).astype(cost.dtype)
        shifted = jnp.concatenate([start_val[None], aligned[:-1]])
        m = jnp.minimum(aligned, shifted)
        acc_row = m + c_win
        d_row, _ = jax.lax.associative_scan(_minplus_combine, (acc_row, c_win))
        end_w = len_b - 1 - o
        hit = jnp.sum(d_row * (idx_w == end_w).astype(cost.dtype))
        acc = jnp.where(i == len_a - 1, hit, acc)
        return (d_row, acc, o), None

    init = (jnp.full((w,), BIG, cost.dtype) + 0 * cost[0, :w],
            jnp.zeros_like(cost[0, 0]),
            jnp.zeros((), jnp.int32))
    (_, dist, _), _ = jax.lax.scan(
        row_step, init, (cost, jnp.arange(t), offsets))
    return dist / (len_a + len_b).astype(cost.dtype)


@functools.partial(jax.jit, static_argnames=("window", "cfg", "precision"))
def dtw_batch_windowed(queries: jax.Array, q_lens: jax.Array,
                       bank: jax.Array, bank_lens: jax.Array,
                       window: int = 128,
                       cfg: DtwConfig = DtwConfig(band_frac=0.1),
                       precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """All-pairs windowed banded DTW -> [B, K]."""
    from dsp_asr.utils.logging import warn_once
    warn_once("dtw-banded-windowed",
              "ops/dtw_banded.dtw_batch_windowed is a reference "
              "implementation off the production path; use "
              "DtwConfig(band_frac=...) through pipeline.dtw_pairs")

    def one(q, ql, tmpl, tl):
        return dtw_distance_windowed(q, tmpl, ql, tl, window, cfg, precision)

    per_template = jax.vmap(one, in_axes=(None, None, 0, 0))
    per_query = jax.vmap(per_template, in_axes=(0, 0, None, None))
    return per_query(queries, q_lens, bank, bank_lens)
