"""Mesh-sharded classification (shard_map + XLA collectives).

Communication design (BASELINE.json config 4: a template bank sharded
across a device mesh; shard, and let XLA insert the collectives, which
run over NVLink between GPUs):

* queries  [B, T, F]  sharded P('data', None, None)
* bank     [K, U, F]  sharded P('bank', None, None)
* each device computes its local [B/data, K/bank] DTW block entirely
  on its device (DTW kernel or cost matmuls + min-plus scans);
* the cross-device reduction is an argmin over the bank axis carried as
  (min_dist, global_template_idx) pairs — an `all_gather` of TWO scalars
  per query per bank shard, never the full distance matrix.

Everything is a single shard_map-ed XLA program; there is no host-side
orchestration per shard.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from dsp_asr.config import DtwConfig, PipelineConfig
from dsp_asr.ops import dtw as jdtw
from dsp_asr.ops import frontend as fe
from dsp_asr.parallel.mesh import BANK_AXIS, DATA_AXIS
from dsp_asr import pipeline as pl

BIG = jdtw.BIG


def classify_sharded(
    mesh: Mesh,
    queries: jax.Array, q_lens: jax.Array,
    bank: jax.Array, bank_lens: jax.Array,
    bank_label_ids: jax.Array,
    bank_valid: jax.Array | None = None,
    cfg: DtwConfig = DtwConfig(),
    precision=jax.lax.Precision.HIGHEST,
    k: int = 1,
    n_labels: int | None = None,
    return_full: bool = False,
):
    """All-pairs DTW classify over a ('data','bank') mesh.

    Args:
      queries/q_lens: [B, T, F] / [B], B divisible by mesh 'data' size.
      bank/bank_lens: [K, U, F] / [K], K divisible by mesh 'bank' size.
      bank_label_ids: [K] int32, replicated.
      bank_valid: [K] bool; False marks padding templates (excluded).
      k: kNN votes; k>1 gathers per-shard top-k (2k scalars/query/shard
         between devices) and votes on the union — exactly matching the
         single-device kNN (requires n_labels).
      return_full: also all_gather the full distance matrix [B, K]
         (K*4 bytes/query between devices — fine for classification-size banks;
         off by default to keep the reduction at 2k scalars).

    Returns (label_ids [B], best_dist [B]) — or (label_ids, dists [B, K])
    with return_full.
    """
    if bank_valid is None:
        bank_valid = jnp.ones(bank.shape[0], dtype=bool)
    if k > 1 and n_labels is None:
        raise ValueError("n_labels required for k > 1")
    kk = max(1, k)

    def local(q, ql, b, bl, bv):
        # q [Bl,T,F], b [Kl,U,F]; all other operands replicated.
        # pl.dtw_pairs applies the SAME impl="auto" routing as the
        # single-device classify, so on GPUs each shard runs the fused
        # banded DTW kernel.
        kl = b.shape[0]
        d = pl.dtw_pairs(q, ql, b, bl, cfg, precision)           # [Bl, Kl]
        d = jnp.where(bv[None, :], d, BIG)
        # per-shard top-k, then a tiny cross-shard gather of 2k
        # scalars/query/shard between devices — never the full matrix
        neg_top, larg = jax.lax.top_k(-d, min(kk, kl))           # [Bl, k]
        lmin = -neg_top
        offset = jax.lax.axis_index(BANK_AXIS) * kl
        gidx = offset + larg
        mins = jax.lax.all_gather(lmin, BANK_AXIS, axis=-1,
                                  tiled=True)                    # [Bl, nb*k]
        idxs = jax.lax.all_gather(gidx, BANK_AXIS, axis=-1, tiled=True)
        neg_sel, sel = jax.lax.top_k(-mins, kk)                  # global top-k
        top_d = -neg_sel
        top_idx = jnp.take_along_axis(idxs, sel, axis=-1)
        if return_full:
            full = jax.lax.all_gather(d, BANK_AXIS, axis=-1, tiled=True)
            return top_idx, top_d, full
        return top_idx, top_d

    out_specs = ((P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS))
                 if return_full else (P(DATA_AXIS), P(DATA_AXIS)))
    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(BANK_AXIS), P(BANK_AXIS), P(BANK_AXIS)),
        out_specs=out_specs,
        # outputs are replicated over 'bank' by the all_gather+argmin, but
        # that cannot be statically inferred — disable the vma check
        check_vma=False,
    )
    out = mapped(queries, q_lens, bank, bank_lens, bank_valid)
    top_idx, top_d = out[0], out[1]
    if k > 1:
        label_ids = pl.vote_topk(top_d, jnp.take(bank_label_ids, top_idx),
                                 n_labels)
    else:
        # same all-dead sentinel as classify_features' k=1 branch (ADVICE
        # r3): a row whose best candidate is still >= 1e20 (normalized
        # itakura-unreachable ~2.5e27, or raw BIG mesh padding) has no
        # information and must not elect template 0's label
        label_ids = jnp.where(top_d[:, 0] < 1e20,
                              jnp.take(bank_label_ids, top_idx[:, 0]), -1)
    dist = out[2] if return_full else top_d[:, 0]
    return label_ids, dist


def level_build_sharded(
    mesh: Mesh,
    q_feats: jax.Array, q_lens: jax.Array,
    bank: jax.Array, bank_lens: jax.Array,
    bank_valid: jax.Array | None = None,
    max_levels: int = 8,
    word_penalty: float = 0.0,
    squared: bool = False,
    precision=jax.lax.Precision.HIGHEST,
):
    """Level-building connected decode over a ('data','bank') mesh.

    Within a level every template is INDEPENDENT (ops/level_building.py:
    level_pass) — the only cross-template coupling is the per-frame min
    that builds the next level's entry costs.  So the bank shards run
    their local DP scans entirely on-chip and the per-LEVEL reduction is
    an all_gather of three [T] vectors per query per bank shard
    (cost / local-argmin template / start pointer), followed by an
    elementwise argmin — never the [K, U] DP state.  max_levels such
    reductions per recording, each O(T) scalars: communication is
    negligible next to the O(T·K·U/nb) local compute.

    Shapes: q_feats [B, T, F] with B divisible by the 'data' size; bank
    [K, U, F] with K divisible by the 'bank' size (pad with
    ``bank_valid=False`` rows — they are masked to BIG and can never be
    selected).  Returns (costs, words, starts) [B, L, T] with GLOBAL
    template indices, identical to the single-device level_build on the
    valid rows (tests/test_sharding.py).
    """
    from dsp_asr.ops.level_building import BIG as LB_BIG
    from dsp_asr.ops.level_building import level_pass, local_costs

    if bank_valid is None:
        bank_valid = jnp.ones(bank.shape[0], dtype=bool)
    penalty = jnp.asarray(word_penalty, jnp.float32)

    def local(q, ql, b, bl, bv):
        kl = b.shape[0]
        lens_idx = (jnp.maximum(bl, 1) - 1)[:, None]            # [Kl, 1]
        offset = jax.lax.axis_index(BANK_AXIS) * kl

        def one(qi):
            c = local_costs(qi, b, bl, squared, precision)      # [T, Kl, U]
            c = jnp.where(bv[None, :, None], c, LB_BIG)         # pad rows dead
            t_frames = c.shape[0]

            def level(prev, _):
                cost_l, v_l, s_l = level_pass(c, prev, lens_idx, penalty)
                # cross-shard reduce: 3 x [T] per bank shard
                costs = jax.lax.all_gather(cost_l, BANK_AXIS)   # [nb, T]
                vs = jax.lax.all_gather(v_l + offset, BANK_AXIS)
                ss = jax.lax.all_gather(s_l, BANK_AXIS)
                which = jnp.argmin(costs, axis=0)               # [T]
                cost_t = jnp.min(costs, axis=0)
                v_t = jnp.take_along_axis(vs, which[None], axis=0)[0]
                s_t = jnp.take_along_axis(ss, which[None], axis=0)[0]
                nxt = jnp.concatenate([jnp.asarray([LB_BIG], jnp.float32),
                                       cost_t])
                return nxt, (cost_t, v_t, s_t)

            prev0 = jnp.full((t_frames + 1,), LB_BIG,
                             jnp.float32).at[0].set(0.0)
            _, out = jax.lax.scan(level, prev0, None, length=max_levels)
            return out

        return jax.vmap(one)(q)

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(BANK_AXIS), P(BANK_AXIS),
                  P(BANK_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
        # the all_gather+argmin replicates the outputs over 'bank', which
        # the static checker cannot infer (same as classify_sharded)
        check_vma=False,
    )
    return mapped(q_feats, q_lens, bank, bank_lens, bank_valid)


def level_build_grammar_sharded(
    mesh: Mesh,
    q_feats: jax.Array, q_lens: jax.Array,
    bank: jax.Array, bank_lens: jax.Array,
    bank_valid: jax.Array | None,
    start_mask: jax.Array, pair_mask: jax.Array,
    max_levels: int = 8,
    word_penalty: float = 0.0,
    squared: bool = False,
    precision=jax.lax.Precision.HIGHEST,
):
    """Grammar-constrained level building over a ('data','bank') mesh.

    The grammar couples templates ACROSS shards — entry into local
    template v needs the best allowed GLOBAL predecessor — so the
    per-level reduction grows from :func:`level_build_sharded`'s three
    [T] vectors to the full [T, K] cost/start planes (an `all_gather`
    of [T, K/nb] per shard, still tiny next to the O(T·K·U/nb)
    local DP).  The transition masks shard by COLUMN: each shard keeps
    ``pair_mask[:, local]`` ([K, Kl]) — ops/level_building.py:
    level_pass_grammar is written for exactly this rectangular case
    (global predecessor axis x local entry axis).

    Shapes as level_build_sharded plus ``start_mask [K]`` /
    ``pair_mask [K, K]`` (pad rows must arrive pre-masked False — the
    model layer ANDs ``bank_valid`` in).  Returns ``(costs, starts)
    [B, L, T, K]`` with GLOBAL template indices, bit-identical to the
    single-device level_build_grammar on the valid rows
    (tests/test_sharding.py).
    """
    from dsp_asr.ops.level_building import BIG as LB_BIG
    from dsp_asr.ops.level_building import level_pass_grammar, local_costs

    if bank_valid is None:
        bank_valid = jnp.ones(bank.shape[0], dtype=bool)
    penalty = jnp.asarray(word_penalty, jnp.float32)

    def local(q, ql, b, bl, bv, sm, pm):
        kl = b.shape[0]                       # local bank rows
        k_global = pm.shape[0]                # mask rows stay global
        lens_idx = (jnp.maximum(bl, 1) - 1)[:, None]            # [Kl, 1]
        masks = jnp.concatenate(
            [jnp.broadcast_to(sm[None, None, :], (1, k_global, kl)),
             jnp.broadcast_to(pm[None],
                              (max(max_levels - 1, 0), k_global, kl))])

        def gather_plane(x):
            # [T, Kl] local -> [T, K] global (shard axis -> column blocks)
            g = jax.lax.all_gather(x, BANK_AXIS)                # [nb, T, Kl]
            return jnp.moveaxis(g, 0, 1).reshape(x.shape[0], k_global)

        def one(qi):
            c = local_costs(qi, b, bl, squared, precision)      # [T, Kl, U]
            c = jnp.where(bv[None, :, None], c, LB_BIG)
            t_frames = c.shape[0]

            def level(prev, mask):
                # prev: [T+1, K] GLOBAL plane, replicated per shard
                cost_l, start_l = level_pass_grammar(
                    c, prev, mask, lens_idx, penalty)           # [T, Kl]
                cost_g = gather_plane(cost_l)
                start_g = gather_plane(start_l)
                nxt = jnp.concatenate(
                    [jnp.full((1, k_global), LB_BIG, jnp.float32), cost_g])
                return nxt, (cost_g, start_g)

            prev0 = jnp.full((t_frames + 1, k_global), LB_BIG,
                             jnp.float32).at[0].set(0.0)
            _, out = jax.lax.scan(level, prev0, masks)
            return out

        return jax.vmap(one)(q)

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(BANK_AXIS), P(BANK_AXIS),
                  P(BANK_AXIS), P(BANK_AXIS), P(None, BANK_AXIS)),
        out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        # the all_gather replicates the planes over 'bank' (same
        # static-checker caveat as level_build_sharded)
        check_vma=False,
    )
    return mapped(q_feats, q_lens, bank, bank_lens, bank_valid,
                  start_mask, pair_mask)


def recognize_sharded(
    mesh: Mesh,
    signals: jax.Array, n_samples: jax.Array,
    mats: fe.FrontendMatrices,
    bank_feats: jax.Array, bank_lens: jax.Array,
    bank_label_ids: jax.Array,
    bank_valid: jax.Array | None = None,
    cfg: PipelineConfig = PipelineConfig(),
    precision=jax.lax.Precision.HIGHEST,
    k: int = 1,
    n_labels: int | None = None,
    return_full: bool = False,
):
    """Full device pipeline over the mesh: padded signals -> labels.

    Feature extraction is embarrassingly data-parallel (jit propagates the
    'data' sharding through the vmapped front-end with zero collectives);
    classification is the bank-sharded top-k reduction above.
    """
    feats = pl.extract_features(signals, n_samples, mats, cfg, precision)
    return classify_sharded(
        mesh, feats.feats, feats.length, bank_feats, bank_lens,
        bank_label_ids, bank_valid, cfg.dtw, precision,
        k=k, n_labels=n_labels, return_full=return_full)


def spot_sharded(
    mesh: Mesh,
    streams: jax.Array, stream_lens: jax.Array,
    bank: jax.Array, bank_lens: jax.Array,
    bank_valid: jax.Array | None = None,
    squared: bool = False,
    precision=jax.lax.Precision.HIGHEST,
):
    """Subsequence-DTW keyword spotting over a ('data','bank') mesh.

    streams [B, U, F] sharded P('data'), bank [K, T, F] sharded
    P('bank'): each device scans its template shard over its stream
    shard — embarrassingly parallel, ZERO collectives; the per-column
    score field comes back sharded over BOTH axes
    (norm/start [B, K, U], P('data','bank')) and the host-side event
    extraction (ops/spot.py:extract_events) consumes the assembled
    [K, U] planes per stream (K*U scalars — spotting-size banks).
    Padding templates (bank_valid False) score BIG everywhere.
    """
    from dsp_asr.ops import spot as ops_spot

    if bank_valid is None:
        bank_valid = jnp.ones(bank.shape[0], dtype=bool)

    def local(s, sl, b, bl, bv):
        norm, start = ops_spot.subseq_dtw_batch_impl(
            s, sl, b, bl, squared, precision)
        norm = jnp.where(bv[None, :, None], norm, jdtw.BIG)
        return norm, start

    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), P(BANK_AXIS), P(BANK_AXIS),
                  P(BANK_AXIS)),
        out_specs=(P(DATA_AXIS, BANK_AXIS), P(DATA_AXIS, BANK_AXIS)),
    )
    return mapped(streams, stream_lens, bank, bank_lens, bank_valid)
