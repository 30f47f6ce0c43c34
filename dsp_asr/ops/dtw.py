"""Dynamic time warping on the accelerator (XLA).

The reference computes DTW with a nested Python DP loop (SURVEY.md L3).
The work splits by kind:

* **Local cost matrix -> one matmul.**  Euclidean cost expands to
  ``|a|^2 + |b|^2 - 2 a.b``; the cross term is one batched matmul
  ``[T,F] @ [F,U]``, batched again over (utterance x template) pairs.

* **DP recurrence -> elementwise min-plus associative scan.**  Within a row,

      D[i,j] = c[i,j] + min(m[j], D[i,j-1]),
      m[j]   = min(D[i-1,j], D[i-1,j-1])

  is affine in the (min,+) semiring: D_j = min(A_j, D_{j-1} + c_j) with
  A_j = m_j + c_j.  These elements compose associatively:

      (A2,c2) o (A1,c1) = (min(A2, A1 + c2), c1 + c2)

  so a row is solved by `lax.associative_scan` in O(log U) vector steps,
  and a `lax.scan` walks the T rows.  No gathers, no diagonal skewing.

Variable lengths are handled with a finite BIG mask (1e30 — no infs, so
no NaN traps) and the answer is read from cell (len_a-1, len_b-1) via a
one-hot dot accumulated during the row scan.  Exact-parity oracle:
dsp_asr/golden/dtw.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from dsp_asr.config import DtwConfig
from dsp_asr.window_plan import LANE, plan_window, round_up as _round_up

BIG = 1e30


def pairwise_sq_cost(a: jax.Array, b: jax.Array,
                     precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Squared Euclidean cost matrix: a [T,F], b [U,F] -> [T,U] (>=0)."""
    cross = jnp.matmul(a, b.T, precision=precision)
    sq_a = jnp.sum(a * a, axis=-1, keepdims=True)
    sq_b = jnp.sum(b * b, axis=-1, keepdims=True).T
    return jnp.maximum(sq_a + sq_b - 2.0 * cross, 0.0)


def _minplus_combine(e1, e2):
    """Compose D -> min(A2, (min(A1, D + c1)) + c2); e1 is the earlier op."""
    a1, c1 = e1
    a2, c2 = e2
    return jnp.minimum(a2, a1 + c2), c1 + c2


def dtw_from_cost(cost: jax.Array, len_a: jax.Array, len_b: jax.Array) -> jax.Array:
    """DP over a (masked) cost matrix [T, U] -> normalised DTW distance.

    ``cost`` must already be BIG at masked cells (cols >= len_b, banded
    region).  Rows >= len_a are never read.
    """
    t, u = cost.shape
    onehot_end = (jnp.arange(u) == len_b - 1).astype(cost.dtype)

    def row_step(carry, inp):
        d_prev, acc = carry
        c_row, i = inp
        start_val = jnp.where(i == 0, 0.0, BIG).astype(cost.dtype)
        shifted = jnp.concatenate([start_val[None], d_prev[:-1]])
        m = jnp.minimum(d_prev, shifted)
        a = m + c_row
        d_row, _ = jax.lax.associative_scan(_minplus_combine, (a, c_row))
        hit = jnp.sum(d_row * onehot_end)
        acc = jnp.where(i == len_a - 1, hit, acc)
        return (d_row, acc), None

    # derive the init carry from `cost` so its sharding/varying-axis type
    # matches the scan output under shard_map (vma typing)
    init = (jnp.full_like(cost[0], BIG), jnp.zeros_like(cost[0, 0]))
    (_, dist), _ = jax.lax.scan(row_step, init, (cost, jnp.arange(t)))
    return dist / (len_a + len_b).astype(cost.dtype)


def dtw_from_cost_itakura(cost: jax.Array, len_a: jax.Array,
                          len_b: jax.Array) -> jax.Array:
    """Itakura slope-constrained DP over a masked cost matrix [T, U].

    Steps {(1,0),(1,1),(1,2)}, no two consecutive (1,0) (golden oracle:
    golden/dtw.py:_dp_itakura).  Every step advances the query row, so
    each row is PURE elementwise work — no associative scan at all:

        N_i = c_i + min(shift1(D_{i-1}), shift2(D_{i-1}))
        D_i = min(N_i, c_i + N_{i-1})

    Cheaper per row than the min-plus scan (no O(log U) sweeps); pairs
    with length ratio > 2 come out ~BIG (unreachable).
    """
    t, u = cost.shape
    onehot_end = (jnp.arange(u) == len_b - 1).astype(cost.dtype)
    big2 = jnp.full(2, BIG, cost.dtype)

    def row_step(carry, inp):
        d_prev, n_prev, acc = carry
        c_row, i = inp
        start_val = jnp.where(i == 0, 0.0, BIG).astype(cost.dtype)
        s1 = jnp.concatenate([start_val[None], d_prev[:-1]])
        s2 = jnp.concatenate([big2, d_prev[:-2]])
        n_row = c_row + jnp.minimum(s1, s2)
        d_row = jnp.minimum(n_row, c_row + n_prev)
        hit = jnp.sum(d_row * onehot_end)
        acc = jnp.where(i == len_a - 1, hit, acc)
        return (d_row, n_row, acc), None

    init = (jnp.full_like(cost[0], BIG), jnp.full_like(cost[0], BIG),
            jnp.zeros_like(cost[0, 0]))
    (_, _, dist), _ = jax.lax.scan(row_step, init, (cost, jnp.arange(t)))
    return dist / (len_a + len_b).astype(cost.dtype)


def band_r2(len_a: jax.Array, len_b: jax.Array, band_frac: float) -> jax.Array:
    """Integer Sakoe-Chiba threshold: in-band iff |j*lam1 - i*lbm1| <= r2.

    The band |j - i*(lb-1)/(la-1)| <= radius is evaluated in the integer
    domain (multiply through by la-1) so every implementation — XLA scan,
    numpy golden, Pallas kernel scalar unit, Pallas vector unit — computes
    the *same* boundary cells from the same f32 multiply + floor.
    """
    lam1 = jnp.maximum(len_a - 1, 1)
    radius = jnp.maximum(
        jnp.float32(1.0),
        jnp.float32(band_frac) * jnp.maximum(len_a, len_b).astype(jnp.float32))
    return jnp.floor(radius * lam1.astype(jnp.float32)).astype(jnp.int32)


def masked_cost(a: jax.Array, b: jax.Array, len_a: jax.Array, len_b: jax.Array,
                cfg: DtwConfig = DtwConfig(),
                precision=jax.lax.Precision.HIGHEST,
                window_mask: jax.Array | None = None) -> jax.Array:
    """Local cost with length + optional Sakoe-Chiba band masking.

    ``window_mask`` overrides the window-schedule validity (a [T, U]
    bool, True = inside).  The bidirectional split uses it to hand each
    half-depth pass its slice of the FULL problem's schedule — computing
    the schedule from the half's own row count would narrow the window
    (plan_window scales with T) and silently mask in-band cells.
    """
    sq = pairwise_sq_cost(a, b, precision)
    cost = sq if cfg.squared else jnp.sqrt(sq)
    t, u = cost.shape
    j = jnp.arange(u)[None, :]
    invalid = j >= len_b
    if cfg.band_frac is not None:
        i = jnp.arange(t, dtype=jnp.int32)[:, None]
        lam1 = jnp.maximum(len_a - 1, 1).astype(jnp.int32)
        lbm1 = (len_b - 1).astype(jnp.int32)
        r2 = band_r2(len_a, len_b, cfg.band_frac)
        invalid = invalid | (jnp.abs(j.astype(jnp.int32) * lam1 - i * lbm1) > r2)
        if window_mask is None:
            window_mask = window_valid(t, u, len_a, len_b, r2, cfg)
        invalid = invalid | ~window_mask
    return jnp.where(invalid, jnp.asarray(BIG, cost.dtype), cost)


def window_offsets(t: int, u: int, len_a: jax.Array, len_b: jax.Array,
                   r2: jax.Array, cfg: DtwConfig):
    """Per-row-block window starts of the banded window schedule.

    The same integer recursion as the Pallas kernel (and the golden
    oracle): off quantised to 8 lanes, -8 slack, right edge clipped to
    len_b, advance clamped to S_MAX per block.  Returns (offs [nb], w,
    row_block) or None when the window is the full row.
    """
    w, s_max, _, rb, _ = plan_window(cfg.band_frac, t, u, cfg.max_warp_scale)
    if w >= _round_up(u, LANE):
        return None
    lam1 = jnp.maximum(len_a - 1, 1).astype(jnp.int32)
    lbm1 = (len_b - 1).astype(jnp.int32)
    nb = -(-t // rb)
    i0 = jnp.arange(nb, dtype=jnp.int32) * rb
    num = jnp.maximum(i0 * lbm1 - r2, 0)
    jlo = (num + lam1 - 1) // lam1
    off_raw = jnp.maximum((jlo // 8) * 8 - 8, 0)
    clip8 = ((jnp.maximum(len_b - w, 0) + 7) // 8) * 8
    off_raw = jnp.minimum(off_raw, clip8)

    def clamp(prev, x):
        off = jnp.minimum(x, prev + s_max)
        return off, off

    _, offs = jax.lax.scan(clamp, jnp.asarray(0, jnp.int32), off_raw)
    return offs, w, rb


def window_valid(t: int, u: int, len_a: jax.Array, len_b: jax.Array,
                 r2: jax.Array, cfg: DtwConfig) -> jax.Array:
    """[t, u] bool: cell inside the banded window schedule (True if the
    schedule is disabled or the window is the full row)."""
    if cfg.max_warp_scale is None:
        return jnp.ones((t, u), dtype=bool)
    plan = window_offsets(t, u, len_a, len_b, r2, cfg)
    if plan is None:
        return jnp.ones((t, u), dtype=bool)
    offs, w, rb = plan
    off_i = offs[jnp.arange(t) // rb][:, None]               # [t, 1]
    j = jnp.arange(u, dtype=jnp.int32)[None, :]
    return (j >= off_i) & (j < off_i + w)


def dtw_distance(a: jax.Array, b: jax.Array,
                 len_a: jax.Array | None = None,
                 len_b: jax.Array | None = None,
                 cfg: DtwConfig = DtwConfig(),
                 precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """DTW distance between a [T,F] and b [U,F] (padded, with true lengths)."""
    if len_a is None:
        len_a = jnp.asarray(a.shape[0])
    if len_b is None:
        len_b = jnp.asarray(b.shape[0])
    cost = masked_cost(a, b, len_a, len_b, cfg, precision)
    if cfg.slope == "itakura":
        return dtw_from_cost_itakura(cost, len_a, len_b)
    return dtw_from_cost(cost, len_a, len_b)


def dtw_distance_bidi(a: jax.Array, b: jax.Array,
                      len_a: jax.Array, len_b: jax.Array,
                      cfg: DtwConfig = DtwConfig(),
                      precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """DTW via bidirectional (Hirschberg-split) row scans.

    Every monotone warp path visits row m = len_a // 2, so

        D = min_j ( F[m, j] + B[m, j] - cost[m, j] )

    where F is the forward DP into (m, j) and B the backward DP from
    (m, j) — itself a forward DP on the index-reversed sequences.  Both
    half-depth scans run **stacked in the batch dimension of one scan**,
    halving the scan trip count (the scan is bound by its
    per-iteration overhead).  Exact same result as dtw_distance.
    """
    if cfg.slope is not None:
        # the F+B merge at the split row cannot see the vertical-step
        # flag across the seam (two (1,0) steps could meet there)
        raise ValueError("dtw_distance_bidi does not support cfg.slope")
    t, f = a.shape
    u = b.shape[0]
    n_rows = t // 2 + 1
    idx_n = jnp.arange(n_rows)
    idx_u = jnp.arange(u)
    m_f = len_a // 2
    m_r = len_a - 1 - m_f                    # reversed row index of m_f

    # Only rows < n_rows of each direction are ever used (m_f, m_r are
    # both <= (len_a-1)//2 < n_rows), so the cost work and bytes equal
    # the unidirectional scan.  vmap out_axes=1 lays the cost out as
    # [n_rows, 2, U] so the scan slices its leading axis with NO relayout.
    a2 = jnp.stack([
        a[:n_rows],
        jnp.take(a, jnp.clip(len_a - 1 - idx_n, 0, t - 1), axis=0),
    ])                                       # [2, n_rows, F] (tiny)
    b_rev = jnp.take(b, jnp.clip(len_b - 1 - idx_u, 0, u - 1), axis=0)
    b2 = jnp.stack([b, b_rev])               # [2, U, F]

    # The rhombus band (band_r2, true lengths) is point-symmetric under
    # (i, j) -> (len_a-1-i, len_b-1-j), so each half evaluates it
    # correctly in its own coordinates.  The quantised window SCHEDULE
    # is defined forward over the FULL row count (plan_window scales
    # with T), so build it once on the full geometry and hand the
    # forward half its row prefix and the backward half the
    # point-reflected view — computing it per-half from n_rows would
    # narrow the window and BIG-mask in-band cells (wrong distances).
    if cfg.band_frac is not None and cfg.max_warp_scale is not None:
        wv = window_valid(t, u, len_a, len_b,
                          band_r2(len_a, len_b, cfg.band_frac), cfg)
        wv_b = jnp.take(
            jnp.take(wv, jnp.clip(len_a - 1 - idx_n, 0, t - 1), axis=0),
            jnp.clip(len_b - 1 - idx_u, 0, u - 1), axis=1)
        masks2 = jnp.stack([wv[:n_rows], wv_b])          # [2, n_rows, U]
    else:
        masks2 = jnp.ones((2, n_rows, u), dtype=bool)
    cost2 = jax.vmap(
        lambda x, y, m: masked_cost(x, y, len_a, len_b, cfg, precision,
                                    window_mask=m),
        in_axes=0, out_axes=1,
    )(a2, b2, masks2)                        # [n_rows, 2, U]

    m2 = jnp.stack([m_f, m_r])               # [2]

    def row_step(carry, inp):
        d_prev, kept = carry                 # [2, U] each
        c_row, i = inp                       # [2, U], scalar
        start_val = jnp.where(i == 0, 0.0, BIG).astype(cost2.dtype)
        col0 = jnp.broadcast_to(start_val, d_prev[..., :1].shape)
        shifted = jnp.concatenate([col0, d_prev[..., :-1]], axis=-1)
        acc = jnp.minimum(d_prev, shifted) + c_row
        d_row, _ = jax.lax.associative_scan(
            _minplus_combine, (acc, c_row), axis=-1)
        kept = jnp.where((i == m2)[..., None], d_row, kept)
        return (d_row, kept), None

    init = (jnp.full((2, u), BIG, cost2.dtype) + 0 * cost2[0],
            jnp.full((2, u), BIG, cost2.dtype) + 0 * cost2[0])
    (_, kept), _ = jax.lax.scan(row_step, init, (cost2, idx_n))

    f_row = kept[0]
    # align the backward row: B[m_f, j] = F_rev[m_r, len_b-1-j]
    b_row = jnp.take(kept[1], jnp.clip(len_b - 1 - idx_u, 0, u - 1))
    c_row = jnp.take(cost2[:, 0], jnp.clip(m_f, 0, n_rows - 1), axis=0)
    comb = f_row + b_row - c_row
    # columns >= len_b hold BIG+finite-BIG == 0 in f32 — mask them out
    total = jnp.min(jnp.where(idx_u < len_b, comb, BIG))
    return total / (len_a + len_b).astype(a.dtype)


@functools.partial(jax.jit, static_argnames=("cfg", "precision"))
def dtw_batch_bidi(queries: jax.Array, q_lens: jax.Array,
                   bank: jax.Array, bank_lens: jax.Array,
                   cfg: DtwConfig = DtwConfig(),
                   precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """All-pairs DTW with the bidirectional half-depth scan."""

    def one(q, ql, tmpl, tl):
        return dtw_distance_bidi(q, tmpl, ql, tl, cfg, precision)

    per_template = jax.vmap(one, in_axes=(None, None, 0, 0))
    per_query = jax.vmap(per_template, in_axes=(0, 0, None, None))
    return per_query(queries, q_lens, bank, bank_lens)


@functools.partial(jax.jit, static_argnames=("cfg", "precision"))
def dtw_batch(queries: jax.Array, q_lens: jax.Array,
              bank: jax.Array, bank_lens: jax.Array,
              cfg: DtwConfig = DtwConfig(),
              precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """All-pairs DTW: queries [B,T,F] x bank [K,U,F] -> distances [B,K].

    This is the headline benchmark op (BASELINE.json config 1): the cost
    matmuls batch over B*K pairs into one matmul, the row scan is shared.
    """
    def one(q, ql, t, tl):
        return dtw_distance(q, t, ql, tl, cfg, precision)

    per_template = jax.vmap(one, in_axes=(None, None, 0, 0))
    per_query = jax.vmap(per_template, in_axes=(0, 0, None, None))
    return per_query(queries, q_lens, bank, bank_lens)
