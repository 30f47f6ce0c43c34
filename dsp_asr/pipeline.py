"""Device pipeline: one jitted function from padded signals to labels.

The reference runs VAD -> MFCC -> DTW -> argmin as separate Python stages
(SURVEY.md §3.1).  Here the *entire* pipeline is a single XLA program:
the only host->device crossing is the jit call on the padded signal
batch, and everything downstream (VAD cummax scans, front-end
matmuls, min-plus DTW) fuses inside it.

Static-shape discipline: signals are padded to ``cfg.max_samples``; all
variable lengths travel as integer scalars next to the data (ragged =
pad + mask, SURVEY.md "hard parts").
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsp_asr.config import PipelineConfig
from dsp_asr.ops import dtw as jdtw
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import vad as jvad


class Features(NamedTuple):
    feats: jax.Array    # [..., T_max, n_feats]
    length: jax.Array   # [...] valid frame count


def pad_signals(signals, max_samples: int):
    """Host list of 1-D signals -> (padded [B, max_samples] f32, lengths [B])."""
    out = np.zeros((len(signals), max_samples), dtype=np.float32)
    lens = np.zeros(len(signals), dtype=np.int32)
    for i, s in enumerate(signals):
        s = np.asarray(s, dtype=np.float32)[:max_samples]
        out[i, : len(s)] = s
        lens[i] = len(s)
    return jnp.asarray(out), jnp.asarray(lens)


def _extract_one(x: jax.Array, n_samples: jax.Array, mats: fe.FrontendMatrices,
                 cfg: PipelineConfig, precision) -> Features:
    """Single padded signal [max_samples] -> trimmed, masked features."""
    f = cfg.frontend

    if f.feature_type == "lpcc":
        from dsp_asr.ops.lpc import lpcc
        c = lpcc(x, f)                                           # [T, C]
    else:
        c = fe.mfcc(x, f, mats, use_fft=False, precision=precision)
    n_frames = jnp.maximum(0, 1 + (n_samples - f.frame_len) // f.hop_len)

    if cfg.use_vad:
        start, end, _ = jvad.detect_endpoints(x, f, cfg.vad, n_samples)
    else:
        start, end = jnp.asarray(0), n_frames

    return _finalize_window(c, start, end, cfg)


def _finalize_window(c: jax.Array, start: jax.Array, end: jax.Array,
                     cfg: PipelineConfig, t_max: int | None = None) -> Features:
    """Cepstra [T_rec, C] + frame window [start, end) -> masked Features.

    Gathers ``t_max`` (default ``cfg.max_frames``) frames starting at
    ``start`` (clamping the window length to ``t_max``), then applies
    CMN and delta stacking exactly as the isolated path always has.
    Shared by the isolated extractor above, the per-segment connected
    extractor, and the whole-recording extractor (level building), so
    features are bit-identical to what the isolated pipeline would
    produce for the same frame window.
    """
    f = cfg.frontend
    t_max = cfg.max_frames if t_max is None else t_max
    length = jnp.minimum(jnp.maximum(end - start, 1), t_max)
    idx = jnp.clip(start + jnp.arange(t_max), 0, c.shape[0] - 1)
    c = jnp.take(c, idx, axis=0)                              # frames from VAD start
    if f.cmn:
        if f.cmn_mode == "causal":
            # prefix-stable running mean (ops/frontend.causal_cmn) —
            # row t only sees rows <= t, so the gathered window's
            # clamp-duplicated tail rows cannot contaminate valid rows
            c = fe.causal_cmn(c, f.cmn_alpha)
        elif f.cmn_mode == "utterance":
            valid = (jnp.arange(t_max) < length)[:, None].astype(c.dtype)
            mean = (jnp.sum(c * valid, axis=0, keepdims=True)
                    / length.astype(c.dtype))
            c = c - mean
        else:
            raise ValueError(
                f"unknown FrontendConfig.cmn_mode {f.cmn_mode!r}")
    feats = fe.add_deltas(c, f, length)
    feats = jnp.where((jnp.arange(t_max) < length)[:, None], feats, 0.0)
    return Features(feats, length)


@functools.partial(jax.jit, static_argnames=("cfg", "precision"))
def extract_features(signals: jax.Array, n_samples: jax.Array,
                     mats: fe.FrontendMatrices,
                     cfg: PipelineConfig = PipelineConfig(),
                     precision=jax.lax.Precision.HIGHEST) -> Features:
    """Padded signal batch [B, max_samples] + true lengths [B] -> Features."""
    one = functools.partial(_extract_one, mats=mats, cfg=cfg, precision=precision)
    return jax.vmap(one)(signals, n_samples)


def dtw_impl(dtw_cfg, b: int, k: int, t: int, u: int,
             platform: str | None = None) -> str:
    """The DTW implementation :func:`dtw_pairs` runs for B queries [T]
    against K templates [U]: "fused_banded" | "scan".

    ``impl="auto"`` takes the fused banded kernel
    (kernels/dtw_fused_banded.py) on a GPU where it implements the config
    and shape and was measured faster than the scan at this B x K, and
    the XLA row scan otherwise: on the CPU, for the configs the kernel
    leaves to the scan (unbanded, band wider than its registers) and for
    the sizes where the scan is faster.  An explicit
    ``impl="fused_banded"`` that cannot run raises instead of falling
    back.  The kernel never runs in interpret mode here; only tests ask
    for that, by calling it directly.
    """
    from dsp_asr.kernels import dtw_fused_banded as fb

    platform = platform or jax.default_backend()
    impl = dtw_cfg.impl
    if impl == "scan":
        return "scan"
    if impl == "auto":
        return ("fused_banded" if platform == "gpu"
                and fb.supports(dtw_cfg, t, u)
                and fb.faster_than_scan(dtw_cfg, b, k) else "scan")
    if impl == "fused_banded":
        if platform != "gpu":
            raise ValueError("DtwConfig.impl='fused_banded' needs a GPU; "
                             f"the backend is {platform!r}")
        if not fb.supports(dtw_cfg, t, u):
            raise ValueError(f"the fused banded kernel does not implement "
                             f"{dtw_cfg} at T={t}, U={u}")
        return impl
    raise ValueError(f"unknown DtwConfig.impl {impl!r}")


def dtw_pairs(q_feats: jax.Array, q_lens: jax.Array,
              bank_feats: jax.Array, bank_lens: jax.Array,
              dtw_cfg, precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """All-pairs DTW distances [B, K] through :func:`dtw_impl`'s choice.

    Shared by :func:`classify_features` and the bank-sharded classify
    (parallel/sharding.py).  Both implementations compute the windowed
    band (DtwConfig.max_warp_scale) and agree to f32 rounding.
    """
    if dtw_impl(dtw_cfg, q_feats.shape[0], bank_feats.shape[0],
                q_feats.shape[1], bank_feats.shape[1]) == "scan":
        return jdtw.dtw_batch(q_feats, q_lens, bank_feats, bank_lens,
                              dtw_cfg, precision)
    from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded
    return dtw_batch_fused_banded(q_feats, q_lens, bank_feats, bank_lens,
                                  dtw_cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "precision", "k", "n_labels"))
def classify_features(feats: Features, bank: Features, bank_label_ids: jax.Array,
                      n_labels: int | None = None,
                      k: int = 1,
                      cfg: PipelineConfig = PipelineConfig(),
                      precision=jax.lax.Precision.HIGHEST):
    """Features [B] x template bank [K] -> (label_ids [B], distances [B,K]).

    k=1 is plain nearest-template; k>1 does kNN majority vote with
    distance-sum tie-breaking, all on device.
    """
    dists = dtw_pairs(feats.feats, feats.length, bank.feats, bank.length,
                      cfg.dtw, precision)
    if k <= 1:
        best = jnp.argmin(dists, axis=-1)
        ids = jnp.take(bank_label_ids, best)
        # all-dead row (every distance >= 1e20, e.g. slope="itakura" with
        # no admissible length ratio) -> sentinel -1, matching vote_topk
        # so the k=1 path agrees with the k>1 and mesh paths (ADVICE r3).
        return jnp.where(jnp.min(dists, axis=-1) < 1e20, ids, -1), dists
    if n_labels is None:
        raise ValueError("n_labels required for k > 1")
    return knn_vote(dists, bank_label_ids, n_labels, k), dists


def knn_vote(dists: jax.Array, bank_label_ids: jax.Array,
             n_labels: int, k: int) -> jax.Array:
    """kNN majority vote over distances [B, K] -> label ids [B].

    Ties are broken lexicographically — (votes desc, distance-sum asc) —
    by restricting the distance comparison to max-vote labels; an
    epsilon-blend score silently flips the vote order once distance sums
    grow ~1e6x past the vote gap.
    """
    k = min(k, dists.shape[-1])     # lax.top_k rejects k > bank size
    _, top_idx = jax.lax.top_k(-dists, k)                     # [B, k]
    top_labels = jnp.take(bank_label_ids, top_idx)            # [B, k]
    top_d = jnp.take_along_axis(dists, top_idx, axis=1)       # [B, k]
    return vote_topk(top_d, top_labels, n_labels)


def vote_topk(top_d: jax.Array, top_labels: jax.Array,
              n_labels: int) -> jax.Array:
    """Majority vote over already-selected candidates [B, k] -> ids [B].

    Shared by the single-device path above and the mesh path (which
    gathers per-shard top-k candidates instead of full distance rows).

    A row whose candidates are ALL dead (every top_d >= 1e20 — plausible
    under slope="itakura" when the query/template length ratio exceeds 2
    for every template) has no information to vote on; it returns the
    sentinel id -1 instead of silently electing label 0 (ADVICE round 2).
    Model-layer callers map negative ids to a reject label.
    """
    onehot = jax.nn.one_hot(top_labels, n_labels)             # [B, k, L]
    # huge candidates are masked cells and must not cast votes.  The
    # threshold is 1e20, NOT BIG/2: unreachable pairs arrive NORMALIZED
    # (BIG/(la+lb) ~ 2.5e27 — common under slope="itakura"'s length
    # rule), while mesh padding arrives as raw BIG; both sit far above
    # 1e20 and every genuine distance sits far below it
    live = (top_d < 1e20).astype(onehot.dtype)[..., None]
    onehot = onehot * live
    votes = onehot.sum(axis=1)                                # [B, L]
    dist_sum = (onehot * top_d[..., None]).sum(axis=1)        # [B, L]
    tied = votes == jnp.max(votes, axis=-1, keepdims=True)
    ids = jnp.argmin(jnp.where(tied, dist_sum, jnp.inf), axis=-1)
    any_live = jnp.any(live[..., 0] > 0, axis=1)              # [B]
    return jnp.where(any_live, ids, -1)


@functools.partial(jax.jit, static_argnames=("target_len", "precision"))
def classify_features_ltw(feats: Features, bank: Features,
                          bank_label_ids: jax.Array,
                          target_len: int = 64,
                          precision=jax.lax.Precision.HIGHEST):
    """Linear-time-warp matching: resample to ``target_len`` frames, then
    the whole bank comparison is ONE [B, L*F] @ [L*F, K] matmul
    (squared-Euclidean expansion) — the classical fast baseline matcher,
    ~two orders of magnitude cheaper than DTW.
    Returns (label_ids [B], distances [B, K])."""
    from dsp_asr.ops.frontend import time_normalize

    q = jax.vmap(lambda f, l: time_normalize(f, l, target_len))(
        feats.feats, feats.length)                      # [B, L, F]
    t = jax.vmap(lambda f, l: time_normalize(f, l, target_len))(
        bank.feats, bank.length)                        # [K, L, F]
    bsz, l, f = q.shape
    qf = q.reshape(bsz, l * f)
    tf = t.reshape(t.shape[0], l * f)
    cross = jnp.matmul(qf, tf.T, precision=precision)
    d = (jnp.sum(qf * qf, axis=-1, keepdims=True)
         + jnp.sum(tf * tf, axis=-1)[None, :] - 2.0 * cross) / (l * f)
    d = jnp.maximum(d, 0.0)
    return jnp.take(bank_label_ids, jnp.argmin(d, axis=-1)), d


@functools.partial(jax.jit, static_argnames=("shortlist", "k", "n_labels",
                                              "target_len", "cfg", "precision"))
def classify_features_cascade(feats: Features, bank: Features,
                              bank_label_ids: jax.Array,
                              shortlist: int = 8,
                              k: int = 1,
                              n_labels: int | None = None,
                              target_len: int = 64,
                              cfg: PipelineConfig = PipelineConfig(),
                              precision=jax.lax.Precision.HIGHEST):
    """Two-stage matcher: LTW shortlist -> DTW rerank of ``shortlist``
    candidates per query (the classical screening cascade: the cheap
    linear-warp matmul ranks the bank, full DTW only scores the top-M).

    Cost scales with B*M instead of B*K — at M=8 vs a 100-template bank
    that is ~10x less DTW — at the price of exactness: a true nearest
    template outside the LTW top-M is lost (measured containment on the
    synthetic corpus: docs/RESULTS.md).  Returns (label_ids [B],
    dtw distances of the shortlist [B, M], candidate indices [B, M]).
    """
    _, ltw_d = classify_features_ltw(feats, bank, bank_label_ids,
                                     target_len, precision)
    m = min(shortlist, bank.feats.shape[0])
    _, cand = jax.lax.top_k(-ltw_d, m)                        # [B, M]
    cand_feats = jnp.take(bank.feats, cand, axis=0)           # [B, M, U, F]
    cand_lens = jnp.take(bank.length, cand, axis=0)           # [B, M]

    def per_query(q, ql, tf, tl):
        return jax.vmap(lambda t, l: jdtw.dtw_distance(q, t, ql, l, cfg.dtw,
                                                       precision))(tf, tl)

    d = jax.vmap(per_query)(feats.feats, feats.length,
                            cand_feats, cand_lens)            # [B, M]
    cand_labels = jnp.take(bank_label_ids, cand)              # [B, M]
    if k <= 1:
        best = jnp.argmin(d, axis=-1)
        ids = jnp.take_along_axis(cand_labels, best[:, None], axis=1)[:, 0]
        # same all-dead sentinel as classify_features' k=1 branch
        ids = jnp.where(jnp.min(d, axis=-1) < 1e20, ids, -1)
    else:
        if n_labels is None:
            raise ValueError("n_labels required for k > 1")
        kk = min(k, m)
        neg_top, sel = jax.lax.top_k(-d, kk)
        ids = vote_topk(-neg_top, jnp.take_along_axis(cand_labels, sel,
                                                      axis=1), n_labels)
    return ids, d, cand


@functools.partial(jax.jit, static_argnames=("cfg", "precision"))
def recognize_batch(signals: jax.Array, n_samples: jax.Array,
                    mats: fe.FrontendMatrices,
                    bank: Features, bank_label_ids: jax.Array,
                    cfg: PipelineConfig = PipelineConfig(),
                    precision=jax.lax.Precision.HIGHEST):
    """End-to-end on device: padded signals -> (label_ids, distances)."""
    feats = extract_features(signals, n_samples, mats, cfg, precision)
    return classify_features(feats, bank, bank_label_ids, cfg=cfg,
                             precision=precision)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "precision", "max_segments"))
def extract_segments_features(signals: jax.Array, n_samples: jax.Array,
                              mats: fe.FrontendMatrices,
                              cfg: PipelineConfig = PipelineConfig(),
                              max_segments: int = 8,
                              precision=jax.lax.Precision.HIGHEST):
    """Padded recordings [B, N] -> per-segment features (connected words).

    The connected-word front half (SURVEY.md §1a L1: the reference
    detector "splits utterances"): cepstra are computed ONCE over each
    whole recording, the multi-segment VAD (ops/vad.py:detect_segments)
    finds up to ``max_segments`` utterances, and each segment's frame
    window is gathered through :func:`_finalize_window` — so per-segment
    features are bit-identical to the isolated pipeline's for the same
    window.  ``N`` may exceed ``cfg.max_samples`` (long recordings);
    segments longer than ``cfg.max_frames`` are truncated.

    Returns ``(Features [B, S, T, F], starts [B, S], ends [B, S],
    n_segs [B])``; rows past ``n_segs`` hold length-1 dummy features —
    mask with ``n_segs`` downstream.
    """
    f = cfg.frontend

    def one(x, n):
        if f.feature_type == "lpcc":
            from dsp_asr.ops.lpc import lpcc
            c = lpcc(x, f)
        else:
            c = fe.mfcc(x, f, mats, use_fft=False, precision=precision)
        starts, ends, n_segs = jvad.detect_segments(
            x, f, cfg.vad, n, max_segments)
        segs = jax.vmap(lambda s, e: _finalize_window(c, s, e, cfg))(
            starts, ends)
        return segs, starts, ends, n_segs

    return jax.vmap(one)(signals, n_samples)


def recognize_connected_batch(signals: jax.Array, n_samples: jax.Array,
                              mats: fe.FrontendMatrices,
                              bank: Features, bank_label_ids: jax.Array,
                              n_labels: int | None = None, k: int = 1,
                              cfg: PipelineConfig = PipelineConfig(),
                              max_segments: int = 8,
                              precision=jax.lax.Precision.HIGHEST):
    """Padded recordings [B, N] -> per-segment labels (connected words).

    Splits each recording into utterances, classifies every segment
    against the template bank in one flat [B*S] batch (same matcher,
    kernels and kNN vote as the isolated path), and masks absent
    segments to label id -1.

    Returns ``(label_ids [B, S], n_segs [B], starts [B, S], ends [B, S])``.
    """
    segs, starts, ends, n_segs = extract_segments_features(
        signals, n_samples, mats, cfg, max_segments, precision)
    b, s = segs.length.shape
    flat = Features(segs.feats.reshape(b * s, *segs.feats.shape[2:]),
                    segs.length.reshape(b * s))
    label_ids, _ = classify_features(flat, bank, bank_label_ids,
                                     n_labels, k, cfg, precision)
    label_ids = label_ids.reshape(b, s)
    live = jnp.arange(s)[None, :] < n_segs[:, None]
    return jnp.where(live, label_ids, -1), n_segs, starts, ends


def group_by_padded_len(signals, quantum: int) -> dict:
    """Group signal indices by quantised padded length.

    Recordings grouped by ``ceil(len / quantum) * quantum`` so compile
    shapes stay quantised; within a group one jit call serves all
    members.  Stable order.  Shared by the level-decode driver and the
    keyword spotter.
    """
    order = np.argsort([len(np.asarray(s)) for s in signals], kind="stable")
    groups: dict = {}
    for i in order:
        n_len = max(1, len(np.asarray(signals[i])))
        pad_len = quantum * -(-n_len // quantum)
        groups.setdefault(pad_len, []).append(i)
    return groups


def segments_flat(signals, mats: fe.FrontendMatrices,
                  cfg: PipelineConfig = PipelineConfig(),
                  max_segments: int = 8,
                  precision=jax.lax.Precision.HIGHEST):
    """Host list of connected recordings -> flat per-segment Features.

    The family-independent half of connected-word decoding: pads the
    recordings to a whole multiple of ``cfg.max_samples`` (quantised
    compile shapes), splits each into utterances and returns
    ``(Features [B*S, T, F], n_segs [B], starts [B, S], ends [B, S])``
    ready for any family's feature scorer (kNN-DTW distances, HMM
    Viterbi log-liks, VQ distortions).  Rows past ``n_segs`` are
    length-1 dummies — mask scores with ``n_segs``.
    """
    quantum = cfg.max_samples
    n_max = max(1, max(len(np.asarray(s)) for s in signals))
    pad_len = quantum * -(-n_max // quantum)
    x, n = pad_signals(signals, pad_len)
    segs, starts, ends, n_segs = extract_segments_features(
        x, n, mats, cfg, max_segments, precision)
    b, s = segs.length.shape
    flat = Features(segs.feats.reshape(b * s, *segs.feats.shape[2:]),
                    segs.length.reshape(b * s))
    return flat, np.asarray(n_segs), np.asarray(starts), np.asarray(ends)


def decode_connected(signals, mats: fe.FrontendMatrices,
                     cfg: PipelineConfig, max_segments: int,
                     score_flat, ids_to_labels,
                     precision=jax.lax.Precision.HIGHEST):
    """Family-independent connected-word decode over host recordings.

    Shared by every family's ``classify_connected`` (kNN-DTW, GMM-HMM,
    VQ): handles empty input, recording-level chunking (at most ~256
    flat segments per device program so the family's scoring
    intermediate stays bounded, like the isolated classify paths; the
    last chunk is padded with repeats and trimmed), the
    :func:`segments_flat` split, and dummy-row masking.

    ``score_flat(Features [B*S]) -> [B*S] label ids`` is the family's
    scorer; ``ids_to_labels(1-D ids) -> [str]`` its label mapping (the
    kNN voter can emit -1 for all-dead rows).  Returns
    ``(label_lists, starts, ends, n_segs)``.

    The trailing partial chunk pads to the next POWER OF TWO, not the
    full chunk: a single-recording serve request used to dispatch the
    64-recording program (64x the work — measured 6.2 s vs ~0.1 s/call
    on the CPU smoke), and power-of-two bucketing bounds the program
    count at log2(chunk) while keeping every result bit-identical.
    """
    if not len(signals):
        z = np.zeros((0, max_segments), np.int32)
        return [], z, z.copy(), np.zeros((0,), np.int32)
    chunk = max(1, 256 // max_segments)
    outs, sts, ens, nss = [], [], [], []
    for lo in range(0, len(signals), chunk):
        part = list(signals[lo:lo + chunk])
        n_real = len(part)
        size = min(chunk, 1 << max(0, n_real - 1).bit_length())
        part += [part[-1]] * (size - n_real)      # pad, bucketed shapes
        flat, n_segs, starts, ends = segments_flat(
            part, mats, cfg, max_segments, precision)
        ids = np.asarray(score_flat(flat)).reshape(len(part), max_segments)
        outs.extend(ids_to_labels(ids[b, : int(n_segs[b])])
                    for b in range(n_real))
        sts.append(starts[:n_real])
        ens.append(ends[:n_real])
        nss.append(n_segs[:n_real])
    return (outs, np.concatenate(sts), np.concatenate(ens),
            np.concatenate(nss))


@functools.partial(jax.jit, static_argnames=("cfg", "t_max", "precision"))
def extract_recording_features(signals: jax.Array, n_samples: jax.Array,
                               mats: fe.FrontendMatrices,
                               cfg: PipelineConfig,
                               t_max: int,
                               precision=jax.lax.Precision.HIGHEST
                               ) -> Features:
    """Padded recordings [B, N] -> WHOLE-recording features [B, t_max, F].

    The level-building front half: unlike :func:`extract_segments_features`
    there is no splitting — one global VAD window (first onset to last
    offset) per recording, CMN over that whole window, deltas as always.
    ``t_max`` must cover the recording's frame count (the caller derives
    it from the padded length).
    """
    f = cfg.frontend

    def one(x, n):
        if f.feature_type == "lpcc":
            from dsp_asr.ops.lpc import lpcc
            c = lpcc(x, f)
        else:
            c = fe.mfcc(x, f, mats, use_fft=False, precision=precision)
        n_frames = jnp.maximum(0, 1 + (n - f.frame_len) // f.hop_len)
        if cfg.use_vad:
            start, end, _ = jvad.detect_endpoints(x, f, cfg.vad, n)
        else:
            start, end = jnp.asarray(0), n_frames
        return _finalize_window(c, start, end, cfg, t_max=t_max)

    return jax.vmap(one)(signals, n_samples)


def decode_connected_level(signals, mats: fe.FrontendMatrices,
                           cfg: PipelineConfig,
                           bank: Features, bank_label_ids,
                           max_levels: int = 8,
                           word_penalty: float = 0.0,
                           precision=jax.lax.Precision.HIGHEST,
                           mesh=None, bank_valid=None,
                           grammar_masks=None):
    """Level-building connected decode over host recordings (GAPLESS ok).

    The algorithmic alternative to :func:`decode_connected`'s VAD
    splitter (ops/level_building.py): word boundaries come out of the
    joint DP, not an energy detector, so coarticulated/gapless speech
    decodes correctly.  Template-bank families only (the DP aligns
    query frames against templates).

    With ``mesh`` the DP runs bank-sharded over a ('data','bank') mesh
    (parallel/sharding.py:level_build_sharded — per-level [T]-vector
    reductions between devices); ``bank`` must then already be padded to the
    bank-axis multiple with ``bank_valid`` marking real rows, and the
    recording batch is padded to the data-axis multiple with repeats.

    ``grammar_masks`` — UNIT-level ``(start [K], pairs [K, K], end [K])``
    boolean arrays (ops/grammar.py:Grammar.unit_masks) switch the DP to
    the syntax-constrained variant (level_build_grammar): which
    templates may begin/end the utterance and which may follow which.
    With ``mesh`` the grammar DP runs bank-sharded too
    (parallel/sharding.py:level_build_grammar_sharded — the per-level
    reduction grows from three [T] vectors to the [T, K] planes the
    grammar needs); the masks arrive sized to the REAL bank and are
    padded False here to the mesh's padded bank (``bank_valid``), so
    dead rows stay unenterable.

    Returns ``(label_id_lists, costs)``: per recording the decoded
    template LABEL ids (empty when nothing is reachable) and the raw DP
    cost.  The local cost follows ``cfg.dtw.squared``; ``word_penalty``
    biases the word-count choice (0 = pure distance).
    """
    if grammar_masks is not None:
        from dsp_asr.ops.level_building import (backtrack_grammar,
                                                level_build_grammar)

        start_m, pair_m, end_m = (np.asarray(m, bool)
                                  for m in grammar_masks)
        if mesh is not None and bank_valid is not None:
            valid = np.asarray(bank_valid, bool)
            kp = valid.shape[0]
            if start_m.shape[0] < kp:        # pad masks to the padded bank
                grow = kp - start_m.shape[0]
                start_m = np.pad(start_m, (0, grow))
                end_m = np.pad(end_m, (0, grow))
                pair_m = np.pad(pair_m, ((0, grow), (0, grow)))
            start_m = start_m & valid
            end_m = end_m & valid
            pair_m = pair_m & np.outer(valid, valid)

        def dp_fn(feats):
            if mesh is not None:
                from dsp_asr.parallel.sharding import \
                    level_build_grammar_sharded

                return level_build_grammar_sharded(
                    mesh, feats.feats, feats.length, bank.feats,
                    bank.length, bank_valid, jnp.asarray(start_m),
                    jnp.asarray(pair_m), max_levels=max_levels,
                    word_penalty=word_penalty, squared=cfg.dtw.squared,
                    precision=precision)
            return level_build_grammar(
                feats.feats, feats.length, bank.feats, bank.length,
                jnp.asarray(start_m), jnp.asarray(pair_m),
                max_levels=max_levels, word_penalty=word_penalty,
                squared=cfg.dtw.squared, precision=precision)

        def backtrack_fn(costs, starts, t_valid):
            return backtrack_grammar(costs, starts, pair_m, end_m, t_valid)

        return decode_level_generic(signals, mats, cfg, dp_fn,
                                    bank_label_ids, precision, mesh=mesh,
                                    backtrack_fn=backtrack_fn)

    def dp_fn(feats):
        if mesh is not None:
            from dsp_asr.parallel.sharding import level_build_sharded

            return level_build_sharded(
                mesh, feats.feats, feats.length, bank.feats, bank.length,
                bank_valid, max_levels=max_levels,
                word_penalty=word_penalty, squared=cfg.dtw.squared,
                precision=precision)
        from dsp_asr.ops.level_building import level_build

        return level_build(
            feats.feats, feats.length, bank.feats, bank.length,
            max_levels=max_levels, word_penalty=word_penalty,
            squared=cfg.dtw.squared, precision=precision)

    return decode_level_generic(signals, mats, cfg, dp_fn, bank_label_ids,
                                precision, mesh=mesh)


def decode_level_generic(signals, mats: fe.FrontendMatrices,
                         cfg: PipelineConfig, dp_fn, word_ids,
                         precision=jax.lax.Precision.HIGHEST, mesh=None,
                         backtrack_fn=None):
    """Shared driver for LEVEL-style connected decoders.

    Handles length grouping (compile shapes stay quantised multiples of
    ``cfg.max_samples``), whole-recording extraction, optional mesh
    data-axis padding, and the host backtrace.  ``dp_fn(Features)`` is
    the family's joint DP in the MIN convention of
    ops/level_building.py (HMM callers negate their log-liks — NEG_INF
    maps onto BIG exactly), returning a tuple of per-recording planes;
    ``backtrack_fn(*planes_row, t_valid) -> (unit ids, cost)`` reads
    one recording's planes back out (default:
    ops/level_building.backtrack on (costs, words, starts) [L, T];
    grammar callers pass backtrack_grammar over [L, T, K] planes).
    ``word_ids`` maps DP word indices to label ids.
    """
    from dsp_asr.ops.level_building import backtrack

    if backtrack_fn is None:
        backtrack_fn = backtrack
    if not len(signals):
        return [], np.zeros((0,), np.float32)
    quantum = cfg.max_samples
    f = cfg.frontend
    ids_np = np.asarray(word_ids)
    out_ids, out_costs = [], []
    groups = group_by_padded_len(signals, quantum)
    results: dict = {}
    for pad_len, idxs in groups.items():
        t_max = max(1, 1 + (pad_len - f.frame_len) // f.hop_len)
        x, n = pad_signals([signals[i] for i in idxs], pad_len)
        b_orig = x.shape[0]
        if mesh is not None:
            from dsp_asr import parallel as par

            nd = mesh.shape[par.DATA_AXIS]
            x, b_orig = par.pad_axis_to_multiple(np.asarray(x), nd)
            n, _ = par.pad_axis_to_multiple(np.asarray(n), nd)
            x = jnp.asarray(x)
            n = jnp.asarray(np.maximum(n, 1))
        feats = extract_recording_features(x, n, mats, cfg, t_max, precision)
        planes = [np.asarray(p)[:b_orig] for p in dp_fn(feats)]
        lens = np.asarray(feats.length)[:b_orig]
        for row, i in enumerate(idxs):
            seq, cost = backtrack_fn(*(p[row] for p in planes),
                                     int(lens[row]))
            results[i] = ([int(ids_np[v]) for v in seq], cost)
    for i in range(len(signals)):
        ids, cost = results[i]
        out_ids.append(ids)
        out_costs.append(cost)
    return out_ids, np.asarray(out_costs, np.float32)


def extract_signals(signals, mats: fe.FrontendMatrices,
                    cfg: PipelineConfig,
                    precision=jax.lax.Precision.HIGHEST) -> Features:
    """Host list of 1-D signals -> device Features (pad + one jit call).

    The shared `extract` of every recognizer family."""
    x, n = pad_signals(signals, cfg.max_samples)
    return extract_features(x, n, mats, cfg, precision)


def nbest_from_scores(scores, labels, n: int = 3,
                      higher_better: bool = False):
    """Per-row top-n hypotheses: ``[B, n_labels] -> [[(label, score,
    weight)]]`` sorted best-first.

    The shared readout behind every family's ``classify_nbest``.
    ``scores`` stay in the family's NATIVE orientation (DTW distance /
    VQ distortion: lower better; HMM log-lik: higher better — set
    ``higher_better``); ``weight`` is a softmax over the row's z-scored
    scores (oriented higher=better): a scale-free RELATIVE confidence
    usable for rejection thresholds and hypothesis ranking — NOT a
    calibrated posterior (synthetic-corpus calibration would not
    transfer anyway).  Dead entries (|score| >= 1e20: the vote/mesh
    BIG sentinel, e.g. a label unreachable under slope='itakura') are
    dropped, so rows may carry fewer than ``n`` hypotheses — an
    all-dead row returns [].
    """
    scores = np.asarray(scores, np.float64)
    out = []
    for row in scores:
        live = np.abs(row) < 1e20
        k = int(live.sum())
        if k == 0:
            out.append([])
            continue
        s = row[live] if higher_better else -row[live]
        std = s.std()
        z = (s - s.mean()) / (std if std > 0 else 1.0)
        w = np.exp(z - z.max())
        w /= w.sum()
        idx_live = np.flatnonzero(live)
        order = np.argsort(-s, kind="stable")[: min(n, k)]
        out.append([(labels[int(idx_live[j])], float(row[idx_live[j]]),
                     float(w[j])) for j in order])
    return out


def edit_distance(a, b) -> int:
    """Levenshtein distance between two label sequences (host metric).

    The word-error numerator for connected-word evaluation
    (scripts/connected_eval.py, CLI evaluate-connected)."""
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1,
                                   prev + (x != y))
    return int(d[len(b)])


def evaluate_corpus(classify_batch, corpus: dict) -> dict:
    """{label: [signals]} -> accuracy + per-label confusion counts.

    Shared by every recognizer family's ``evaluate``; ``classify_batch``
    is the family's list-of-signals -> list-of-labels callable."""
    sigs, want = [], []
    for lab, xs in corpus.items():
        sigs.extend(xs)
        want.extend([lab] * len(xs))
    got = classify_batch(sigs)
    correct = sum(g == w for g, w in zip(got, want))
    confusion: dict = {}
    for g, w in zip(got, want):
        confusion.setdefault(w, {}).setdefault(g, 0)
        confusion[w][g] += 1
    return {"accuracy": correct / max(len(want), 1),
            "n": len(want), "confusion": confusion}


def classify_features_bucketed(feats: Features, bank: Features,
                               bank_label_ids: jax.Array,
                               n_labels: int | None = None, k: int = 1,
                               cfg: PipelineConfig = PipelineConfig(),
                               precision=jax.lax.Precision.HIGHEST,
                               pad_to: int = 64):
    """classify_features with host-side length bucketing.

    Queries are grouped into static query-length buckets
    (t_max, t_max/2, t_max/4) and each bucket runs `classify_features`
    on features SLICED to the bucket length, so short utterances pay a
    proportionally smaller DTW (the kernel's row count is its static
    t_pad).  Exactness: rows beyond the true length are never harvested
    (padding-invariance, tests/test_properties.py) and `plan_window`'s
    schedule depends on the template length axis, which is unchanged —
    so bucket results equal the unbucketed ones bit-for-bit per pair
    (tests/test_bucketed.py).  The in-kernel length-adaptive variant of
    this idea measured WORSE (docs/PERF.md dead ends) — bucketing
    above the kernel is the right altitude.

    OPT-IN (KnnDtwRecognizer(bucketed=True)): each bucket is an extra
    kernel launch + fetch round-trip, so it pays off only for large
    batches with genuinely mixed lengths.

    Bucket batches are padded to multiples of ``pad_to`` (by repeating
    the last row) to bound the number of compiled program shapes.
    Returns host numpy (label_ids [B], distances [B, K]).
    """
    t_max = feats.feats.shape[1]
    # Exactness precondition (ADVICE round 2): plan_window's band radius
    # is band_frac*max(t, u), which is only invariant under query-axis
    # slicing while the bank's U dominates every bucket length.  Holds
    # for all in-repo callers (queries and bank both pad to
    # cfg.max_frames) — enforced so a shorter bank cannot silently
    # diverge from the unbucketed path.
    if bank.feats.shape[1] < t_max:
        raise ValueError(
            f"bucketed classify requires bank U ({bank.feats.shape[1]}) >= "
            f"query t_max ({t_max}); use classify_features instead")
    lens = np.asarray(feats.length)
    b = len(lens)
    buckets = sorted({t_max, max(t_max // 2, 1), max(t_max // 4, 1)})
    out_ids = np.zeros(b, np.int64)
    out_d = np.zeros((b, bank.feats.shape[0]), np.float32)
    assigned = np.full(b, t_max, np.int64)
    for tb in buckets:
        assigned = np.where(lens <= tb, np.minimum(assigned, tb), assigned)
    for tb in buckets:
        sel = np.where(assigned == tb)[0]
        if sel.size == 0:
            continue
        bsz = -(-sel.size // pad_to) * pad_to
        idx = np.concatenate([sel, np.full(bsz - sel.size, sel[-1])])
        fb = Features(feats.feats[idx, :tb], feats.length[idx])
        lid, d = classify_features(fb, bank, bank_label_ids,
                                   n_labels=n_labels, k=k, cfg=cfg,
                                   precision=precision)
        out_ids[sel] = np.asarray(lid)[: sel.size]
        out_d[sel] = np.asarray(d)[: sel.size]
    return out_ids, out_d
