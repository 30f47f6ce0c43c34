"""Vectorized endpoint detection (VAD) in JAX.

Implements exactly the spec of the golden oracle (dsp_asr/golden/vad.py)
but with *no sequential state machine at all*: every run-length quantity
is computed with a `cummax` trick, so the whole detector is a handful of
vector ops — cheap elementwise work and trivially batchable with vmap.

Run-length trick: for a boolean flag sequence f[t],

    run_end[t]   = t - cummax_t( where(!f, t, -1) )

is the length of the consecutive-True run *ending* at t (0 if f[t] is
False).  Reversing gives runs *starting* at t.  First/last qualifying
positions then come from argmax over booleans (argmax returns the first
True), which replaces the double-threshold state machine.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dsp_asr.config import FrontendConfig, VadConfig
from dsp_asr.golden.vad import ZCR_ABS_FLOOR
from dsp_asr.ops import frontend as fe


def short_time_energy(frames: jax.Array) -> jax.Array:
    return jnp.sum(frames * frames, axis=-1)


def zero_crossing_rate(frames: jax.Array) -> jax.Array:
    s = jnp.where(frames >= 0.0, 1.0, -1.0)
    return jnp.sum((s[..., 1:] != s[..., :-1]).astype(frames.dtype), axis=-1)


def _run_ending_at(flag: jax.Array) -> jax.Array:
    """Length of consecutive-True run ending at each position (inclusive)."""
    t = flag.shape[-1]
    idx = jnp.arange(t)
    last_false = jax.lax.cummax(jnp.where(flag, -1, idx), axis=flag.ndim - 1)
    return idx - last_false


def _run_starting_at(flag: jax.Array) -> jax.Array:
    return _run_ending_at(flag[..., ::-1])[..., ::-1]


def _noise_thresholds(e: jax.Array, z: jax.Array, length: jax.Array,
                      vcfg: VadConfig):
    """Shared threshold computation -> (th, tl, zt, valid, idx).

    Mirrors golden/vad.py:thresholds exactly, incl. the ``two_pass``
    mode's integer-percent rank arithmetic (config.py:VadConfig)."""
    t = e.shape[-1]
    idx = jnp.arange(t)
    valid = idx < length

    n_init = jnp.minimum(vcfg.n_init, length)
    init_mask = (idx < n_init).astype(e.dtype)
    denom = jnp.maximum(jnp.sum(init_mask), 1.0)
    e_noise = jnp.sum(e * init_mask) / denom + vcfg.e_abs_floor
    z_noise = jnp.sum(z * init_mask) / denom
    th = e_noise * vcfg.e_high_mult
    tl = e_noise * vcfg.e_low_mult
    zt = z_noise * vcfg.zcr_mult + ZCR_ABS_FLOOR
    if vcfg.threshold_mode == "two_pass":
        fp = round(vcfg.tp_floor_frac * 100)
        cq = round(vcfg.tp_ceil_q * 100)
        e_sorted = jnp.sort(jnp.where(valid, e, jnp.inf))    # valid first
        k = jnp.maximum(1, (fp * length + 99) // 100)        # ceil(frac*n)
        floor = (jnp.sum(jnp.where(idx < k, e_sorted, 0.0))
                 / k.astype(e.dtype)) + vcfg.e_abs_floor
        ceil = e_sorted[(cq * (length - 1)) // 100]
        use = ceil >= vcfg.tp_min_contrast * floor
        th = jnp.where(use, floor + vcfg.tp_high * (ceil - floor), th)
        tl = jnp.where(use, floor + vcfg.tp_low * (ceil - floor), tl)
    elif vcfg.threshold_mode != "noise_mult":
        raise ValueError(
            f"unknown VadConfig.threshold_mode {vcfg.threshold_mode!r}")
    return th, tl, zt, valid, idx


def detect_endpoints_frames(
    e: jax.Array,
    z: jax.Array,
    length: jax.Array | None = None,
    vcfg: VadConfig = VadConfig(),
):
    """Core detector on per-frame energy/ZCR vectors [T].

    ``length`` (traced) is the count of valid frames; frames beyond it are
    ignored.  Returns (start, end_exclusive, found) as traced scalars.
    Matches dsp_asr.golden.vad.detect_endpoints frame-for-frame.
    """
    t = e.shape[-1]
    if length is None:
        length = jnp.asarray(t)
    th, tl, zt, valid, idx = _noise_thresholds(e, z, length, vcfg)

    high = (e > th) & valid
    runs = _run_ending_at(high)
    qual = runs >= vcfg.min_speech_frames
    found = jnp.any(qual)
    t_first = jnp.argmax(qual)                       # first qualifying end
    start_core = t_first - vcfg.min_speech_frames + 1
    t_last = t - 1 - jnp.argmax(qual[::-1])          # last qualifying end
    end_core = t_last

    audible = ((e > tl) | (z > zt)) & valid
    back = _run_ending_at(audible)                   # run ending at t
    fwd = _run_starting_at(audible)                  # run starting at t
    start = jnp.where(
        start_core > 0,
        start_core - back[jnp.maximum(start_core - 1, 0)],
        0,
    )
    end = jnp.where(
        end_core + 1 < length,
        end_core + fwd[jnp.minimum(end_core + 1, t - 1)],
        end_core,
    )
    end_excl = jnp.minimum(length, end + 1 + vcfg.hangover_frames)

    start = jnp.where(found, start, 0)
    end_excl = jnp.where(found, end_excl, length)
    return start, end_excl, found


def detect_endpoints(
    x: jax.Array,
    fcfg: FrontendConfig = FrontendConfig(),
    vcfg: VadConfig = VadConfig(),
    length_samples: jax.Array | None = None,
):
    """Signal [N] -> (start_frame, end_frame_exclusive, found).

    Frames the RAW signal (no pre-emphasis) on the standard grid, like the
    golden spec.  ``length_samples`` masks padded signal tails.
    """
    frames = fe.frame(x, fcfg.frame_len, fcfg.hop_len)
    e = short_time_energy(frames)
    z = zero_crossing_rate(frames)
    if length_samples is None:
        n_frames = None
    else:
        n_frames = jnp.maximum(
            0, 1 + (length_samples - fcfg.frame_len) // fcfg.hop_len
        )
    return detect_endpoints_frames(e, z, n_frames, vcfg)


def detect_segments_frames(
    e: jax.Array,
    z: jax.Array,
    length: jax.Array | None = None,
    vcfg: VadConfig = VadConfig(),
    max_segments: int = 8,
):
    """Connected-word splitter on per-frame energy/ZCR vectors [T].

    Matches ``dsp_asr.golden.vad.detect_segments`` frame-for-frame but
    with zero sequential state: every step of the spec (core runs,
    audible extension, gap bridging, hangover, short-segment drop) is a
    run-length computation on boolean masks via the cummax trick, so the
    whole splitter is ~30 vector ops.  1-D inputs; ``jax.vmap`` for
    batches.

    Returns ``(starts [S], ends_exclusive [S], n_segs)`` with
    ``S = max_segments`` (static); rows past ``n_segs`` are zeroed.  If
    the recording contains more than ``max_segments`` utterances the
    first ``max_segments`` (in time order) are returned.
    """
    t = e.shape[-1]
    if length is None:
        length = jnp.asarray(t)
    th, tl, zt, valid, idx = _noise_thresholds(e, z, length, vcfg)

    high = (e > th) & valid
    audible = ((e > tl) | (z > zt)) & valid

    # 1. core: frame sits inside a run of >= min_speech_frames highs
    run_total = _run_ending_at(high) + _run_starting_at(high) - 1
    core = high & (run_total >= vcfg.min_speech_frames)

    # 2. regions: maximal (audible|core)-runs containing a core frame
    conn = audible | core
    run_start = idx - _run_ending_at(conn) + 1
    run_end = idx + _run_starting_at(conn) - 1
    last_core = jax.lax.cummax(jnp.where(core, idx, -1))
    ncr = jax.lax.cummax(jnp.where(core[::-1], idx, -1))
    next_core = t - 1 - ncr[::-1]          # == t when no core at/after idx
    region = conn & ((last_core >= run_start) | (next_core <= run_end))

    # 3. bridge interior silence gaps shorter than max_silence_frames
    gap = ~region
    g_start = idx - _run_ending_at(gap) + 1
    g_end = idx + _run_starting_at(gap) - 1
    bridge = (gap & (g_end - g_start + 1 < vcfg.max_silence_frames)
              & (g_start > 0) & (g_end <= length - 2))
    merged = region | bridge

    # 4. hangover after each region end (touching regions merge)
    prev_m = jax.lax.cummax(jnp.where(merged, idx, -(1 << 30)))
    final = merged | ((idx - prev_m <= vcfg.hangover_frames) & valid)

    # 5. drop regions shorter than min_utterance_frames
    f_len = _run_ending_at(final) + _run_starting_at(final) - 1
    keep = final & (f_len >= vcfg.min_utterance_frames)

    prev = jnp.concatenate([jnp.zeros(1, bool), keep[:-1]])
    nxt = jnp.concatenate([keep[1:], jnp.zeros(1, bool)])
    rising = keep & ~prev
    falling = keep & ~nxt
    starts = jnp.nonzero(rising, size=max_segments, fill_value=0)[0]
    ends = jnp.nonzero(falling, size=max_segments, fill_value=-1)[0] + 1
    n_segs = jnp.minimum(jnp.sum(rising), max_segments)
    live = jnp.arange(max_segments) < n_segs
    return jnp.where(live, starts, 0), jnp.where(live, ends, 0), n_segs


def detect_segments(
    x: jax.Array,
    fcfg: FrontendConfig = FrontendConfig(),
    vcfg: VadConfig = VadConfig(),
    length_samples: jax.Array | None = None,
    max_segments: int = 8,
):
    """Signal [N] -> (starts [S], ends_exclusive [S], n_segs) in frames.

    The connected-word counterpart of :func:`detect_endpoints`
    (SURVEY.md §1a L1: the reference detector "splits utterances").
    """
    frames = fe.frame(x, fcfg.frame_len, fcfg.hop_len)
    e = short_time_energy(frames)
    z = zero_crossing_rate(frames)
    if length_samples is None:
        n_frames = None
    else:
        n_frames = jnp.maximum(
            0, 1 + (length_samples - fcfg.frame_len) // fcfg.hop_len
        )
    return detect_segments_frames(e, z, n_frames, vcfg, max_segments)
