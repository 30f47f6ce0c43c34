"""DTW alignment paths and DBA template averaging.

The reference's enrollment step optionally condenses multiple recordings
per word into one template (SURVEY.md §3.2 "average/medoid template
selection").  Implemented on the device:

* ``dtw_alignment`` — full DP table via the min-plus row scan, then a
  fixed-length `lax.scan` backtrace (static T+U-1 steps, padded with
  -1), so paths are jit/vmap friendly.
* ``medoid`` — argmin of summed all-pairs DTW distance.
* ``dba_average`` — DTW Barycenter Averaging: iteratively align every
  recording to the center and average the frames mapped to each center
  frame (scatter-add over path indices, vmapped over recordings).

Oracle: dsp_asr/golden/dtw.py `return_path=True`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dsp_asr.config import DtwConfig
from dsp_asr.ops.dtw import BIG, _minplus_combine, masked_cost


def _dp_table(cost: jax.Array) -> jax.Array:
    """Full DP table D [T, U] from a masked cost matrix (row min-plus scan).

    LOCKSTEP: this row recurrence (and _dp_tables_itakura below) must
    stay bit-identical to ops/dtw.py's dtw_from_cost /
    dtw_from_cost_itakura — the only difference is emitting every row
    for the backtrace instead of harvesting one cell.  Any masking or
    start-value change there must be mirrored here (the alignment
    path-parity tests vs golden catch divergence).
    """
    t, u = cost.shape

    def row_step(d_prev, inp):
        c_row, i = inp
        start_val = jnp.where(i == 0, 0.0, BIG).astype(cost.dtype)
        shifted = jnp.concatenate([start_val[None], d_prev[:-1]])
        m = jnp.minimum(d_prev, shifted)
        a = m + c_row
        d_row, _ = jax.lax.associative_scan(_minplus_combine, (a, c_row))
        return d_row, d_row

    init = jnp.full_like(cost[0], BIG)
    _, table = jax.lax.scan(row_step, init, (cost, jnp.arange(t)))
    return table


def _dp_tables_itakura(cost: jax.Array):
    """(D, N) tables of the Itakura recurrence (golden: _dp_itakura_tables)."""
    t, u = cost.shape
    big2 = jnp.full(2, BIG, cost.dtype)

    def row_step(carry, inp):
        d_prev, n_prev = carry
        c_row, i = inp
        start = jnp.where(i == 0, 0.0, BIG).astype(cost.dtype)
        s1 = jnp.concatenate([start[None], d_prev[:-1]])
        s2 = jnp.concatenate([big2, d_prev[:-2]])
        n_row = c_row + jnp.minimum(s1, s2)
        d_row = jnp.minimum(n_row, c_row + n_prev)
        return (d_row, n_row), (d_row, n_row)

    init = (jnp.full_like(cost[0], BIG), jnp.full_like(cost[0], BIG))
    _, (dtab, ntab) = jax.lax.scan(row_step, init, (cost, jnp.arange(t)))
    return dtab, ntab


def _backtrace_itakura(cost, dtab, ntab, len_a, len_b, steps):
    """End-first Itakura path via the two-state value tables.

    Tie rules (non-vertical branch first, then the (1,1) step) mirror
    golden/dtw.py:_backtrace_itakura exactly, so paths match the oracle
    element-for-element.
    """
    def back_step(carry, _):
        i, j, vert_ok, done = carry
        ndm1 = jnp.where(i > 0, ntab[jnp.maximum(i - 1, 0), j], BIG)
        vert = vert_ok & (i > 0) & (cost[i, j] + ndm1 < ntab[i, j])
        d1 = jnp.where((i > 0) & (j > 0),
                       dtab[jnp.maximum(i - 1, 0), jnp.maximum(j - 1, 0)], BIG)
        d2 = jnp.where((i > 0) & (j > 1),
                       dtab[jnp.maximum(i - 1, 0), jnp.maximum(j - 2, 0)], BIG)
        dj = jnp.where(vert, 0, jnp.where(d1 <= d2, 1, 2))
        at_origin = i == 0
        out = (jnp.where(done, -1, i), jnp.where(done, -1, j))
        new_done = done | at_origin
        ni = jnp.where(new_done, 0, i - 1)
        # j<0 only on UNREACHABLE end cells (all-BIG walk); clamp at 0
        nj = jnp.where(new_done, 0, jnp.maximum(j - dj, 0))
        return (ni, nj, ~vert, new_done), out

    init = (len_a - 1, len_b - 1, jnp.asarray(True), jnp.asarray(False))
    _, (path_i, path_j) = jax.lax.scan(back_step, init, None, length=steps)
    return path_i, path_j


def dtw_alignment(a: jax.Array, b: jax.Array,
                  len_a: jax.Array | None = None,
                  len_b: jax.Array | None = None,
                  cfg: DtwConfig = DtwConfig(),
                  precision=jax.lax.Precision.HIGHEST):
    """Align a [T,F] to b [U,F].

    Returns (dist, path_i [L], path_j [L], n_steps) with L = T+U-1.
    The path is emitted END-FIRST — entry 0 is (len_a-1, len_b-1), entry
    n_steps-1 is (0, 0) — and padded with -1 beyond n_steps.  With
    ``cfg.slope="itakura"`` the path obeys the slope-constrained step
    set (backtraced from the two-state (D, N) tables).
    """
    t, u = a.shape[0], b.shape[0]
    if len_a is None:
        len_a = jnp.asarray(t)
    if len_b is None:
        len_b = jnp.asarray(u)
    cost = masked_cost(a, b, len_a, len_b, cfg, precision)
    if cfg.slope == "itakura":
        dtab, ntab = _dp_tables_itakura(cost)
        dist = dtab[len_a - 1, len_b - 1] / (len_a + len_b).astype(cost.dtype)
        path_i, path_j = _backtrace_itakura(cost, dtab, ntab,
                                            len_a, len_b, t + u - 1)
        return dist, path_i, path_j, jnp.sum(path_i >= 0)
    table = _dp_table(cost)
    dist = table[len_a - 1, len_b - 1] / (len_a + len_b).astype(cost.dtype)

    def back_step(carry, _):
        i, j, done = carry
        d_diag = jnp.where((i > 0) & (j > 0), table[i - 1, j - 1], BIG)
        d_up = jnp.where(i > 0, table[i - 1, j], BIG)
        d_left = jnp.where(j > 0, table[i, j - 1], BIG)
        best = jnp.argmin(jnp.stack([d_diag, d_up, d_left]))
        ni = jnp.where(best != 2, i - 1, i)
        nj = jnp.where(best != 1, j - 1, j)
        at_origin = (i == 0) & (j == 0)
        out = (jnp.where(done, -1, i), jnp.where(done, -1, j))
        new_done = done | at_origin
        ni = jnp.where(at_origin | done, 0, ni)
        nj = jnp.where(at_origin | done, 0, nj)
        return (ni, nj, new_done), out

    steps = t + u - 1
    init = (len_a - 1, len_b - 1, jnp.asarray(False))
    _, (path_i, path_j) = jax.lax.scan(back_step, init, None, length=steps)
    n_steps = jnp.sum(path_i >= 0)
    return dist, path_i, path_j, n_steps


def medoid(feats: jax.Array, lens: jax.Array,
           cfg: DtwConfig = DtwConfig(),
           precision=jax.lax.Precision.HIGHEST):
    """Index of the recording minimising total DTW distance to the rest."""
    from dsp_asr.ops.dtw import dtw_batch

    d = dtw_batch(feats, lens, feats, lens, cfg, precision)   # [N, N]
    return jnp.argmin(jnp.sum(d, axis=-1))


@functools.partial(jax.jit, static_argnames=("n_iter", "cfg", "precision"))
def dba_average(feats: jax.Array, lens: jax.Array,
                center: jax.Array, len_c: jax.Array,
                n_iter: int = 3,
                cfg: DtwConfig = DtwConfig(),
                precision=jax.lax.Precision.HIGHEST):
    """DTW Barycenter Averaging of feats [N, T, F] onto center [U, F].

    Frames of the center beyond ``len_c`` stay zero.  Returns the updated
    center (same shape).
    """
    n, t, f = feats.shape
    u = center.shape[0]

    def one_round(center, _):
        def align_one(x, lx):
            _, pi, pj, _ = dtw_alignment(center, x, len_c, lx, cfg, precision)
            valid = pi >= 0
            ci = jnp.where(valid, pi, 0)
            sj = jnp.where(valid, pj, 0)
            frames = x[sj] * valid[:, None]                   # [L, F]
            sums = jax.ops.segment_sum(frames, ci, num_segments=u)
            counts = jax.ops.segment_sum(valid.astype(x.dtype), ci,
                                         num_segments=u)
            return sums, counts

        sums, counts = jax.vmap(align_one)(feats, lens)       # [N, U, F], [N, U]
        tot = counts.sum(0)[:, None]
        new = jnp.where(tot > 0, sums.sum(0) / jnp.maximum(tot, 1.0), center)
        new = jnp.where((jnp.arange(u) < len_c)[:, None], new, 0.0)
        return new, None

    center, _ = jax.lax.scan(one_round, center, None, length=n_iter)
    return center
