"""Keyword spotting: subsequence (open-begin / open-end) DTW.

The reference framework (SURVEY.md §2a) can only classify
silence-delimited utterances — its endpoint detector must find the word
before DTW sees it.  This module matches an enrolled keyword template
against ANY contiguous span of a long unsegmented stream, the classical
unconstrained-endpoint DTW (online form: SPRING, Sakurai et al. 2007).

Device mapping (same split as ops/dtw.py):

* **Offline batch** (`subseq_dtw_batch`) — the [T,F]x[F,U] local-cost
  GEMM is batched over (stream x template) pairs; the DP is
  the row-major min-plus associative scan of ops/dtw.py with two
  boundary changes: the virtual row above the table is 0 (open begin —
  a path may start at any stream column) and the WHOLE last row is kept
  (open end — every column is a candidate match end).  Each column
  additionally carries a START WITNESS through the semiring: elements
  (A, c, s) compose as

      (A2,c2,s2) o (A1,c1,s1) = (min(A2, A1+c2), c1+c2,
                                 where(A2 <= A1+c2, s2, s1))

  — the tropical affine composition with argmin payload.  Witness
  tie-breaks mirror golden/spot.py (diagonal, vertical, horizontal;
  fresh start wins row-0 ties); like any parallel argmin they are only
  deterministic when scores are tie-free, which holds for continuous
  features.  The streaming column order below resolves exact ties as
  diagonal > horizontal > vertical instead (the horizontal predecessor
  is fused into the pre-scan min there), so on EXACT float ties the
  two orders can return different witnesses — and therefore different
  span-normalised scores — for the same audio; values are identical
  either way.

* **Streaming** (`spot_chunk`) — the SPRING column update: one new
  stream frame advances a [K, T] state (per-template DP column + start
  witnesses) with a min-plus scan along the SHORT template axis, so the
  per-frame work is O(T) vector ops and the state is chunk-invariant:
  feeding the same stream in any chunking is bit-exact (the recurrence
  is evaluated in the same sequential column order either way).

Scores are normalised per end column by the repo's (Ta + Tb) convention
applied to the matched span: norm[j] = D[Ta-1, j] / (Ta + j - s[j] + 1).

Golden oracle: dsp_asr/golden/spot.py.  Event extraction from the
per-column score field is host-side numpy (`extract_events`) — the
output is tiny and the greedy suppression loop is data-dependent.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr.ops.dtw import BIG, pairwise_sq_cost


def _combine(e1, e2):
    """Tropical affine composition with start-witness payload."""
    a1, c1, s1 = e1
    a2, c2, s2 = e2
    take2 = a2 <= a1 + c2          # tie prefers the LATER (fresher) start
    return (jnp.minimum(a2, a1 + c2), c1 + c2,
            jnp.where(take2, s2, s1))


def subseq_dtw_from_cost(cost: jax.Array, len_a: jax.Array,
                         len_b: jax.Array):
    """Subsequence DP over a cost matrix [T, U] (template rows, stream
    columns; BIG already at cols >= len_b).

    Returns (norm [U], start [U]): per-end-column normalised match cost
    and the stream column the match began at.  Columns >= len_b are BIG.
    """
    t, u = cost.shape
    iota = jnp.arange(u, dtype=jnp.int32)

    def row_step(carry, inp):
        d_prev, s_prev, acc_d, acc_s = carry
        c_row, i = inp
        shifted = jnp.concatenate([jnp.full((1,), BIG, d_prev.dtype),
                                   d_prev[:-1]])
        shifted_s = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                     s_prev[:-1]])
        # diagonal preferred over vertical on ties (golden order)
        m = jnp.minimum(shifted, d_prev)
        sm = jnp.where(shifted <= d_prev, shifted_s, s_prev)
        # open begin: the virtual row above row 0 is 0 with witness j
        m = jnp.where(i == 0, 0.0, m)
        sm = jnp.where(i == 0, iota, sm)
        a = m + c_row
        d_row, _, s_row = jax.lax.associative_scan(
            _combine, (a, c_row, sm))
        at_end = i == len_a - 1
        acc_d = jnp.where(at_end, d_row, acc_d)
        acc_s = jnp.where(at_end, s_row, acc_s)
        return (d_row, s_row, acc_d, acc_s), None

    # derive the init carry (incl. the int32 witness rows) from `cost`
    # so its varying-axes type matches the scan output under shard_map
    # (same discipline as ops/dtw.py:dtw_from_cost)
    zero_i = (0 * cost[0]).astype(jnp.int32)
    init = (jnp.full_like(cost[0], BIG), zero_i,
            jnp.full_like(cost[0], BIG), zero_i)
    (_, _, d_end, s_end), _ = jax.lax.scan(
        row_step, init, (cost, jnp.arange(t)))
    span = (iota - s_end + 1).astype(cost.dtype)
    norm = d_end / (len_a.astype(cost.dtype) + span)
    norm = jnp.where(iota < len_b, norm, BIG)
    return norm, s_end


def subseq_cost(tmpl: jax.Array, stream: jax.Array, len_b: jax.Array,
                squared: bool = False,
                precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Local cost template [T,F] x stream [U,F] -> [T,U], BIG at
    cols >= len_b.  No band: the stream axis is unbounded relative to
    the template, a Sakoe-Chiba band is meaningless here."""
    sq = pairwise_sq_cost(tmpl, stream, precision)
    c = sq if squared else jnp.sqrt(sq)
    return jnp.where(jnp.arange(stream.shape[0])[None, :] < len_b, c,
                     jnp.asarray(BIG, c.dtype))


def subseq_dtw_batch_impl(streams: jax.Array, stream_lens: jax.Array,
                          bank: jax.Array, bank_lens: jax.Array,
                          squared: bool = False,
                          precision=jax.lax.Precision.HIGHEST):
    """Unjitted all-pairs spotting body (shared with the bank-sharded
    mesh path, parallel/sharding.py:spot_sharded)."""
    def one(stream, slen, tmpl, tlen):
        c = subseq_cost(tmpl, stream, slen, squared, precision)
        return subseq_dtw_from_cost(c, tlen, slen)

    per_tmpl = jax.vmap(one, in_axes=(None, None, 0, 0))
    per_stream = jax.vmap(per_tmpl, in_axes=(0, 0, None, None))
    return per_stream(streams, stream_lens, bank, bank_lens)


@functools.partial(jax.jit, static_argnames=("squared", "precision"))
def _subseq_dtw_batch_scan(streams: jax.Array, stream_lens: jax.Array,
                           bank: jax.Array, bank_lens: jax.Array,
                           squared: bool = False,
                           precision=jax.lax.Precision.HIGHEST):
    return subseq_dtw_batch_impl(streams, stream_lens, bank, bank_lens,
                                 squared, precision)


def subseq_dtw_batch(streams: jax.Array, stream_lens: jax.Array,
                     bank: jax.Array, bank_lens: jax.Array,
                     squared: bool = False,
                     precision=jax.lax.Precision.HIGHEST):
    """Spot every bank template in every stream.

    streams [B,U,F], bank [K,T,F] -> (norm [B,K,U], start [B,K,U]).
    The B*K cost GEMMs batch into one matmul; the row scan is shared.
    """
    return _subseq_dtw_batch_scan(streams, stream_lens, bank, bank_lens,
                                  squared, precision)


# ---------------------------------------------------------------- streaming

class SpotState(NamedTuple):
    """SPRING DP state: one column per template.

    d_col [K, T] — D[:, j] after the last fed frame (BIG before any).
    s_col [K, T] — start witness of the best path into each cell.
    n_fed [] int32 — stream frames consumed so far.
    """
    d_col: jax.Array
    s_col: jax.Array
    n_fed: jax.Array


def spot_init(n_templates: int, t: int, dtype=jnp.float32) -> SpotState:
    return SpotState(jnp.full((n_templates, t), BIG, dtype),
                     jnp.zeros((n_templates, t), jnp.int32),
                     jnp.zeros((), jnp.int32))


@functools.partial(jax.jit, static_argnames=("squared", "precision"))
def spot_chunk(state: SpotState, chunk: jax.Array, n_valid: jax.Array,
               bank: jax.Array, bank_lens: jax.Array,
               squared: bool = False,
               precision=jax.lax.Precision.HIGHEST):
    """Advance the SPRING state by a chunk of stream frames.

    chunk [C, F] (first n_valid rows real), bank [K, T, F].  Returns
    (state', norm [K, C], start [K, C]): per-frame match scores ending
    at each fed frame (BIG at invalid frames).  Bit-exact under any
    chunking of the same stream.
    """
    k, t, f = bank.shape
    # cost columns for the whole chunk in one batched GEMM: [K, T, C] —
    # the SAME clamped squared-Euclidean as the offline path (shared
    # ops/dtw.py:pairwise_sq_cost, so the two can never drift)
    cost = jax.vmap(lambda tm: pairwise_sq_cost(tm, chunk, precision))(bank)
    if not squared:
        cost = jnp.sqrt(cost)
    iota_t = jnp.arange(t)[None, :]                      # [1, T]

    def frame_step(carry, inp):
        d_col, s_col, j = carry                          # [K,T],[K,T],[]
        c_col, valid = inp                               # [K, T], bool
        # open begin: virtual row above = 0 with witness j
        up = jnp.concatenate([jnp.zeros((k, 1), d_col.dtype),
                              d_col[:, :-1]], axis=1)    # D[i-1, j-1]
        up_s = jnp.concatenate([
            jnp.full((k, 1), j, jnp.int32), s_col[:, :-1]], axis=1)
        # d_col here is the HORIZONTAL predecessor D[i, j-1]; ties
        # resolve diag > horiz (> vert via the scan) — see module doc
        m = jnp.minimum(up, d_col)
        sm = jnp.where(up <= d_col, up_s, s_col)
        a = m + c_col
        # vertical continuation D[i-1, j] -> min-plus scan along T
        new_d, _, new_s = jax.lax.associative_scan(
            _combine, (a, c_col, sm), axis=1)
        d_col = jnp.where(valid, new_d, d_col)
        s_col = jnp.where(valid, new_s, s_col)
        end_hot = (iota_t == bank_lens[:, None] - 1)
        d_end = jnp.sum(jnp.where(end_hot, new_d, 0.0), axis=1)
        s_end = jnp.sum(jnp.where(end_hot, new_s, 0), axis=1)
        span = (j - s_end + 1).astype(d_end.dtype)
        norm = d_end / (bank_lens.astype(d_end.dtype) + span)
        norm = jnp.where(valid, norm, BIG)
        return (d_col, s_col, j + valid.astype(jnp.int32)), (norm, s_end)

    c = chunk.shape[0]
    valid = jnp.arange(c) < n_valid
    cost_cols = jnp.moveaxis(cost, 2, 0)                 # [C, K, T]
    (d_col, s_col, n_fed), (norms, starts) = jax.lax.scan(
        frame_step, (state.d_col, state.s_col, state.n_fed),
        (cost_cols, valid))
    return (SpotState(d_col, s_col, n_fed),
            jnp.moveaxis(norms, 0, 1), jnp.moveaxis(starts, 0, 1))


@functools.partial(jax.jit, static_argnames=("squared",))
def rerank_windows(wins: jax.Array, win_lens: jax.Array, mids: jax.Array,
                   bank: jax.Array, bank_lens: jax.Array,
                   squared: bool = False):
    """Cascade stage-2 rerank, argmin ON DEVICE (VERDICT r4 #2).

    wins [N,W,F] candidate windows, mids [N] landmark midpoints (window
    frames).  Each window is matched against the whole bank; the best
    (template, end-column) must CONTAIN the landmark midpoint
    (start <= mid <= end — an unconstrained argmin elects a stronger
    NEIGHBORING word, docs/RESULTS.md).  Returns per window
    (row [N], end [N], start [N], score [N]) — a few KB fetched instead
    of the full [N,K,W] norm/start fields.
    """
    norm, start = subseq_dtw_batch(wins, win_lens, bank, bank_lens,
                                   squared=squared)          # [N,K,W]
    n, k, w = norm.shape
    cols = jnp.arange(w, dtype=jnp.int32)[None, None, :]
    mid3 = mids[:, None, None]
    ok = (cols.astype(mids.dtype) >= mid3) & (start.astype(mids.dtype)
                                              <= mid3)
    m = jnp.where(ok, norm, BIG)
    flat = m.reshape(n, k * w)
    idx = jnp.argmin(flat, axis=1).astype(jnp.int32)         # first-min,
    r, j = idx // w, idx % w                                 # host order
    score = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    s = jnp.take_along_axis(start.reshape(n, k * w), idx[:, None],
                            axis=1)[:, 0]
    return r, j, s, score


# ------------------------------------------------------------- host events

def extract_events(norm: np.ndarray, start: np.ndarray, threshold: float,
                   labels: np.ndarray | None = None, min_gap: int = 0):
    """Greedy best-first spotting events from per-column scores.

    norm/start [K, U] (numpy, fetched).  Emits the globally best column
    under threshold, suppresses all columns whose span overlaps it
    (across all templates), repeats.  ``min_gap`` widens the suppressed
    region by that many frames on both sides — the classical remedy for
    LANDMARK-style scorers (the HMM LLR peaks on a word's high-contrast
    core, so two peaks inside one occurrence may not literally overlap).
    Returns [(label, start, end, score)] sorted by start.  Mirrors
    golden/spot.py:spot_events.
    """
    norm = np.atleast_2d(np.asarray(norm, dtype=np.float64)).copy()
    start = np.atleast_2d(np.asarray(start, dtype=np.int64))
    k, u = norm.shape
    cols = np.arange(u)[None, :]
    events = []
    while True:
        flat = int(np.argmin(norm))
        r, j = divmod(flat, u)
        score = norm[r, j]
        if not score < threshold:
            break
        s, e = int(start[r, j]), int(j)
        lbl = int(labels[r]) if labels is not None else r
        events.append((lbl, s, e, float(score)))
        norm[(start <= e + min_gap) & (cols >= s - min_gap)] = BIG
    events.sort(key=lambda ev: ev[1])
    return events
