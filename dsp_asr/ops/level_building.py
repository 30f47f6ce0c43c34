"""Level-building connected-word decoding over a template bank.

The VAD-splitter connected path (ops/vad.py:detect_segments ->
pipeline.decode_connected) requires silence gaps between words; for
coarticulated/GAPLESS speech the classical answer is the level-building
DP of Myers & Rabiner (1981) (equivalently Ney's 1984 one-stage DP run
per word level): jointly choose the word count, word identities and
their boundaries by dynamic programming over (level, query frame,
template, template frame), instead of trusting an energy detector to
find the boundaries first.  This module is the missing-gap remedy
called out in VERDICT round 3 (#4); reference behavior: SURVEY.md §1a
L1 ("splits utterances") taken to its limit.

Device mapping
--------------
* The local-cost tensor ``C[T, K, U]`` (query frame x template x
  template frame) is ONE ``[T, F] @ [F, K*U]`` matmul (squared-Euclidean
  expansion) — all the FLOPs land in matmuls, like the LTW matcher.
* Each level is a ``lax.scan`` over query frames carrying the live DP
  front ``[K, U]`` (plus an int32 token plane for the start-frame
  backpointer — classical token passing); the level axis is an outer
  ``lax.scan``.  All shapes static, no data-dependent control flow.
* The per-step transition is the query-synchronous step set
  {(1,0),(1,1),(1,2)} (Itakura-style: every query frame is consumed
  exactly once), so the accumulated cost of ANY decode of a T-frame
  recording is a sum of exactly T local distances — costs are directly
  comparable across word counts, and the only cross-count bias is the
  explicit per-word ``word_penalty``.

Semantics (shared bit-for-bit with golden/level_building.py):
* entering template v at query frame t starts at template frame 0 and
  costs ``prev_level[t] + word_penalty + C[t, v, 0]``;
* within a word, ``dp[t, v, j] = C[t, v, j] + min(dp[t-1, v, j],
  dp[t-1, v, j-1], dp[t-1, v, j-2])``;
* a word ends only at its true last frame ``lens[v] - 1``;
* ``costs[l, t]`` = best cost of exactly ``l+1`` words consuming query
  frames ``0..t``; the caller picks the level at the recording's last
  valid frame and backtracks via the recorded (template, start) pairs.

Masked template frames (j >= lens[v]) carry the finite sentinel BIG
(ops/dtw.py discipline — masked lanes must stay finite so min/argmin
never see NaN/inf arithmetic).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr.ops.dtw import BIG


def local_costs(q: jax.Array, bank: jax.Array, bank_lens: jax.Array,
                squared: bool = False,
                precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Query [T, F] x bank [K, U, F] -> local distances [T, K, U].

    One matmul via the squared-Euclidean expansion; frames past a
    template's true length are masked to BIG.
    """
    t, f = q.shape
    k, u, _ = bank.shape
    bf = bank.reshape(k * u, f)
    cross = jnp.matmul(q, bf.T, precision=precision)          # [T, K*U]
    d = (jnp.sum(q * q, axis=-1, keepdims=True)
         + jnp.sum(bf * bf, axis=-1)[None, :] - 2.0 * cross)
    d = jnp.maximum(d, 0.0).reshape(t, k, u)
    if not squared:
        d = jnp.sqrt(d)
    dead = jnp.arange(u)[None, :] >= bank_lens[:, None]       # [K, U]
    return jnp.where(dead[None], BIG, d)


def _shift_j(x: jax.Array, by: int, fill):
    """Shift [K, U] one/two steps up the template-frame axis."""
    return jnp.concatenate(
        [jnp.full((x.shape[0], by), fill, x.dtype), x[:, :-by]], axis=1)


def level_pass(c: jax.Array, prev: jax.Array, lens_idx: jax.Array,
               word_penalty: jax.Array, init=None, frame_offset=0,
               return_carry: bool = False):
    """ONE level of the DP for one recording.

    Args: cost tensor ``c [T, K, U]``, previous level's ``prev [T+1]``
    (``prev[s]`` = best cost of the earlier levels consuming exactly
    ``s`` frames), ``lens_idx [K, 1]`` = template end indices.

    Returns per query frame ``(cost [T], word [T] local template index,
    start [T])``.  Shared by the single-device scan-of-scans below and
    the bank-sharded mesh path (parallel/sharding.py:
    level_build_sharded), which reduces these [T] triples across bank
    shards between levels.

    ``init``/``frame_offset``/``return_carry`` serve the STREAMING
    chunked variant (:func:`level_build_chunk`): resume the frame scan
    from a carried ``(dp, tok)`` front, number frames globally (token
    backpointers are absolute recording indices), and hand the final
    front back.  Defaults reproduce the one-shot behavior exactly.
    """
    t_frames, k, u = c.shape
    entry_costs = prev[:t_frames] + word_penalty                # [T]

    def step(carry, inp):
        dp, tok = carry                                         # [K,U]
        c_t, e_t, t = inp
        entry = jnp.full((k, u), BIG, jnp.float32).at[:, 0].set(e_t)
        cands = jnp.stack([dp,
                           _shift_j(dp, 1, BIG),
                           _shift_j(dp, 2, BIG),
                           entry])                              # [4, K, U]
        toks = jnp.stack([tok,
                          _shift_j(tok, 1, 0),
                          _shift_j(tok, 2, 0),
                          jnp.full((k, u), t, jnp.int32)])
        sel = jnp.argmin(cands, axis=0)                         # [K, U]
        dp = jnp.min(cands, axis=0) + c_t
        # finite-BIG discipline: several masked candidates can stack
        # (BIG + BIG local costs) — clamp so the carry never drifts
        # toward f32 overflow over long scans
        dp = jnp.minimum(dp, BIG)
        tok = jnp.take_along_axis(toks, sel[None], axis=0)[0]
        ends = jnp.take_along_axis(dp, lens_idx, axis=1)[:, 0]
        best_v = jnp.argmin(ends)                               # scalar
        out = (ends[best_v], best_v.astype(jnp.int32),
               jnp.take_along_axis(tok, lens_idx, axis=1)[:, 0][best_v])
        return (dp, tok), out

    if init is None:
        init = (jnp.full((k, u), BIG, jnp.float32),
                jnp.zeros((k, u), jnp.int32))
    frames = frame_offset + jnp.arange(t_frames, dtype=jnp.int32)
    carry, (cost_t, v_t, s_t) = jax.lax.scan(
        step, init, (c, entry_costs, frames))
    if return_carry:
        return (cost_t, v_t, s_t), carry
    return cost_t, v_t, s_t


@functools.partial(jax.jit, static_argnames=("max_levels", "squared",
                                             "precision"))
def level_build(q_feats: jax.Array, q_lens: jax.Array,
                bank_feats: jax.Array, bank_lens: jax.Array,
                max_levels: int = 8,
                word_penalty: jax.Array | float = 0.0,
                squared: bool = False,
                precision=jax.lax.Precision.HIGHEST):
    """Batched level-building DP.

    Args:
      q_feats:    [B, T, F] whole-recording features (padding zeroed).
      q_lens:     [B] valid frame counts (readout only — the DP runs the
                  full static T; entries past the valid frame are never
                  read because the caller indexes costs at t_valid-1).
      bank_feats: [K, U, F] template bank, bank_lens [K].
      max_levels: static maximum word count L.
      word_penalty: added once per word — biases the level choice
                  (0.0 = pure distance; costs are length-comparable
                  because every decode sums exactly T local distances).

    Returns (costs [B, L, T], words [B, L, T] int32 template ids,
    starts [B, L, T] int32): entry ``[l, t]`` describes the best decode
    of ``l+1`` words consuming query frames ``0..t`` — its total cost,
    its LAST word's template, and how many frames the first ``l`` words
    consumed (the backtrack pointer into level ``l-1``).
    """
    word_penalty = jnp.asarray(word_penalty, jnp.float32)
    lens_idx = (jnp.maximum(bank_lens, 1) - 1)[:, None]        # [K, 1]

    def one(q, _qlen):
        c = local_costs(q, bank_feats, bank_lens, squared, precision)
        t_frames = c.shape[0]

        def level(prev, _):
            # prev: [T+1], prev[s] = best cost of the previous levels
            # consuming exactly s query frames (prev[0]=0 at level 0)
            cost_t, v_t, s_t = level_pass(c, prev, lens_idx, word_penalty)
            # next level's prev: consuming 0 frames is impossible once
            # any word has been decoded
            nxt = jnp.concatenate([jnp.asarray([BIG], jnp.float32), cost_t])
            return nxt, (cost_t, v_t, s_t)

        prev0 = jnp.full((t_frames + 1,), BIG,
                         jnp.float32).at[0].set(0.0)
        _, (costs, words, starts) = jax.lax.scan(
            level, prev0, None, length=max_levels)
        return costs, words, starts

    return jax.vmap(one)(q_feats, q_lens)


class LevelStreamState(NamedTuple):
    """Carried DP state for STREAMING level building (one stream).

    ``dp/tok [L, K, U]``: each level's live front (token plane holds
    ABSOLUTE recording frame indices); ``last_cost [L]``: each level's
    output cost at the last processed frame — the next chunk's first
    entry value for the level above; ``offset``: frames processed so
    far (drives the virtual-start plane and global token numbering).
    """

    dp: jax.Array
    tok: jax.Array
    last_cost: jax.Array
    offset: jax.Array


def level_stream_init(max_levels: int, n_templates: int,
                      u_max: int) -> LevelStreamState:
    """Fresh stream state (all fronts dead, zero frames seen)."""
    return LevelStreamState(
        dp=jnp.full((max_levels, n_templates, u_max), BIG, jnp.float32),
        tok=jnp.zeros((max_levels, n_templates, u_max), jnp.int32),
        last_cost=jnp.full((max_levels,), BIG, jnp.float32),
        offset=jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnames=("squared", "precision"))
def level_build_chunk(state: LevelStreamState, q_chunk: jax.Array,
                      bank_feats: jax.Array, bank_lens: jax.Array,
                      word_penalty: jax.Array | float = 0.0,
                      squared: bool = False,
                      precision=jax.lax.Precision.HIGHEST):
    """One chunk of STREAMING level building — bit-exact vs the batch DP.

    The joint DP is frame-synchronous, so it streams exactly: level
    ``l`` at frame ``t`` needs only (l, t-1) and (l-1, t-1).  Per chunk
    we run the levels IN ORDER over the chunk's frames; the only
    cross-chunk memory is :class:`LevelStreamState` (each level's
    [K, U] front + its last output cost).  Processing a recording in
    ANY chunking reproduces :func:`level_build`'s (costs, words,
    starts) planes bit-for-bit — same op order per frame, so not even
    float summation order changes (tests/test_level_building.py).

    Args: ``q_chunk [T_c, F]`` new feature frames (T_c static per
    compiled program — stream drivers should feed fixed-size chunks).
    Returns ``(new_state, (costs, words, starts) [L, T_c])`` — the
    planes for THIS chunk's frames; the caller concatenates them
    host-side for backtracking (ops-level :func:`backtrack` unchanged,
    token indices are already global).
    """
    word_penalty = jnp.asarray(word_penalty, jnp.float32)
    lens_idx = (jnp.maximum(bank_lens, 1) - 1)[:, None]
    c = local_costs(q_chunk, bank_feats, bank_lens, squared, precision)
    t_c = c.shape[0]
    # virtual-start plane values for these frames: entering level 0 at
    # frame t means the earlier levels consumed t frames — possible
    # only at the very first frame of the stream
    prev0 = jnp.where(state.offset + jnp.arange(t_c) == 0,
                      0.0, BIG).astype(jnp.float32)

    def one_level(prev_chunk, xs):
        dp_l, tok_l, last_l = xs
        # prev values for this level at frames [c0..c1): the level
        # below's outputs at [c0-1..c1-1) = carried last + this chunk's
        # all-but-last (computed right below for the next level)
        (cost_t, v_t, s_t), (dp_n, tok_n) = level_pass(
            c, jnp.concatenate([prev_chunk, jnp.full((1,), BIG,
                                                     jnp.float32)]),
            lens_idx, word_penalty, init=(dp_l, tok_l),
            frame_offset=state.offset, return_carry=True)
        nxt = jnp.concatenate([last_l[None], cost_t[:-1]])
        return nxt, (dp_n, tok_n, cost_t[-1], cost_t, v_t, s_t)

    _, (dp, tok, last, costs, words, starts) = jax.lax.scan(
        one_level, prev0, (state.dp, state.tok, state.last_cost))
    new_state = LevelStreamState(dp=dp, tok=tok, last_cost=last,
                                 offset=state.offset + t_c)
    return new_state, (costs, words, starts)


def level_pass_grammar(c: jax.Array, prev: jax.Array, mask: jax.Array,
                       lens_idx: jax.Array, word_penalty: jax.Array):
    """ONE grammar-constrained level for one recording.

    Like :func:`level_pass`, but the per-frame output keeps the full
    template axis — with a word-pair grammar the "best word ending at
    frame t" depends on what FOLLOWS it, so the reduction to one
    (cost, word, start) triple per frame is no longer sound.  ``prev``
    is the previous level's ``[T+1, K]`` plane, ``mask [K, K]`` the
    allowed (previous unit u -> this unit v) transitions; the entry
    cost becomes a masked min-plus reduction over u (one [K, K] `where`
    + min per frame, inside the scan — negligible next to the [K, U]
    front update).  Returns ``(cost [T, K], start [T, K])``.
    """
    t_frames, k, u = c.shape

    def step(carry, inp):
        dp, tok = carry                                         # [K, U]
        c_t, p_t, t = inp
        e_t = jnp.min(jnp.where(mask, p_t[:, None], BIG), axis=0)
        e_t = jnp.minimum(e_t + word_penalty, BIG)              # [K]
        entry = jnp.full((k, u), BIG, jnp.float32).at[:, 0].set(e_t)
        cands = jnp.stack([dp,
                           _shift_j(dp, 1, BIG),
                           _shift_j(dp, 2, BIG),
                           entry])                              # [4, K, U]
        toks = jnp.stack([tok,
                          _shift_j(tok, 1, 0),
                          _shift_j(tok, 2, 0),
                          jnp.full((k, u), t, jnp.int32)])
        sel = jnp.argmin(cands, axis=0)
        dp = jnp.minimum(jnp.min(cands, axis=0) + c_t, BIG)
        tok = jnp.take_along_axis(toks, sel[None], axis=0)[0]
        out = (jnp.take_along_axis(dp, lens_idx, axis=1)[:, 0],
               jnp.take_along_axis(tok, lens_idx, axis=1)[:, 0])
        return (dp, tok), out

    init = (jnp.full((k, u), BIG, jnp.float32),
            jnp.zeros((k, u), jnp.int32))
    (_, _), (cost_tk, start_tk) = jax.lax.scan(
        step, init,
        (c, prev[:t_frames], jnp.arange(t_frames, dtype=jnp.int32)))
    return cost_tk, start_tk


@functools.partial(jax.jit, static_argnames=("max_levels", "squared",
                                             "precision"))
def level_build_grammar(q_feats: jax.Array, q_lens: jax.Array,
                        bank_feats: jax.Array, bank_lens: jax.Array,
                        start_mask: jax.Array, pair_mask: jax.Array,
                        max_levels: int = 8,
                        word_penalty: jax.Array | float = 0.0,
                        squared: bool = False,
                        precision=jax.lax.Precision.HIGHEST):
    """Batched level building under a word-pair grammar.

    Same DP as :func:`level_build` with the inter-level entry
    constrained by a finite-state syntax (ops/grammar.py, compiled to
    unit-level masks): ``start_mask [K]`` gates which templates may
    begin the utterance, ``pair_mask [K, K]`` which template may follow
    which.  Masks are TRACED arguments — editing the grammar never
    recompiles.  The `end` mask applies at readout
    (:func:`backtrack_grammar`), not in the DP.

    Returns ``(costs [B, L, T, K], starts [B, L, T, K])`` — the full
    per-template planes (see level_pass_grammar for why the K axis
    can't be reduced).  Memory note: K times the unconstrained planes;
    at the repo's shapes (K tens-of-templates, T hundreds) this is a
    few MB per recording — chunk B at the caller for big banks
    (pipeline.decode_connected already chunks).
    """
    word_penalty = jnp.asarray(word_penalty, jnp.float32)
    lens_idx = (jnp.maximum(bank_lens, 1) - 1)[:, None]         # [K, 1]
    k = bank_feats.shape[0]
    # level 0's "pair" mask: the virtual start allows v iff start[v],
    # whatever the (vacuous) predecessor row is
    masks = jnp.concatenate(
        [jnp.broadcast_to(start_mask[None, None, :], (1, k, k)),
         jnp.broadcast_to(pair_mask[None], (max(max_levels - 1, 0), k, k))])

    def one(q, _qlen):
        c = local_costs(q, bank_feats, bank_lens, squared, precision)
        t_frames = c.shape[0]

        def level(prev, mask):
            cost_tk, start_tk = level_pass_grammar(
                c, prev, mask, lens_idx, word_penalty)
            nxt = jnp.concatenate(
                [jnp.full((1, k), BIG, jnp.float32), cost_tk])
            return nxt, (cost_tk, start_tk)

        prev0 = jnp.full((t_frames + 1, k), BIG,
                         jnp.float32).at[0].set(0.0)
        _, (costs, starts) = jax.lax.scan(level, prev0, masks)
        return costs, starts

    return jax.vmap(one)(q_feats, q_lens)


def backtrack_grammar(costs: np.ndarray, starts: np.ndarray,
                      pair_mask: np.ndarray, end_mask: np.ndarray,
                      t_valid: int, max_levels: int | None = None):
    """Host backtrace for ONE recording under a grammar.

    ``costs/starts`` are the [L, T, K] planes from
    :func:`level_build_grammar`.  The terminal pick applies ``end_mask``;
    each step back recomputes the DP's own entry argmin — the chosen
    predecessor is the ``pair_mask``-allowed template minimising the
    previous level's cost at the boundary (identical min rule and tie
    order, lowest index, as the traced entry reduction).  Returns
    ``(template ids, cost)``; ``([], BIG)`` when the grammar admits no
    decode of the recording.
    """
    t_valid = int(t_valid)
    if t_valid <= 0:
        return [], float(BIG)
    levels = costs.shape[0] if max_levels is None else min(
        max_levels, costs.shape[0])
    final = np.where(end_mask[None, :], costs[:levels, t_valid - 1], BIG)
    l_star, v = np.unravel_index(np.argmin(final), final.shape)
    best = float(final[l_star, v])
    if best >= BIG / 2:
        return [], float(BIG)
    seq = []
    t = t_valid - 1
    v = int(v)
    for lvl in range(int(l_star), -1, -1):
        seq.append(v)
        entered = int(starts[lvl, t, v])
        if lvl > 0:
            prev_row = np.where(pair_mask[:, v],
                                costs[lvl - 1, entered - 1], BIG)
            v = int(np.argmin(prev_row))
            t = entered - 1
        elif entered != 0:   # pragma: no cover - DP invariant
            raise AssertionError(
                f"grammar backtrack did not land at frame 0 ({entered})")
    return seq[::-1], best


def backtrack(costs: np.ndarray, words: np.ndarray, starts: np.ndarray,
              t_valid: int, max_levels: int | None = None):
    """Host backtrace for ONE recording -> (template ids, level cost).

    ``costs/words/starts`` are the [L, T] planes from :func:`level_build`;
    ``t_valid`` the recording's true frame count.  Returns ``([], BIG)``
    when no level reaches the last frame (e.g. every template too long
    for the recording under the slope-2 step set).
    """
    t_valid = int(t_valid)
    if t_valid <= 0:
        return [], float(BIG)
    levels = costs.shape[0] if max_levels is None else min(
        max_levels, costs.shape[0])
    final = costs[:levels, t_valid - 1]
    l_star = int(np.argmin(final))
    best = float(final[l_star])
    if best >= BIG / 2:
        return [], float(BIG)
    seq = []
    t = t_valid - 1
    for lvl in range(l_star, -1, -1):
        seq.append(int(words[lvl, t]))
        consumed_before = int(starts[lvl, t])
        t = consumed_before - 1
    if t != -1:   # pragma: no cover - DP invariant (level 0 starts at 0)
        raise AssertionError(f"backtrack did not land at frame 0 (t={t})")
    return seq[::-1], best
