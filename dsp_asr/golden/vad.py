"""Golden numpy endpoint detection (VAD).

Classic energy + zero-crossing-rate double-threshold endpoint detector
(SURVEY.md L1; the reference's "endpoint detection" per BASELINE.json).
The exact algorithm is *specified here* (no reference checkout exists —
SURVEY.md §0); the JAX scan implementation in dsp_asr/ops/vad.py must
match this loop version exactly (integer frame indices, bit-for-bit).

Spec (offline, isolated word):

1. Frame the RAW signal (no pre-emphasis) with the front-end's
   frame/hop; compute per-frame energy E[t] = sum(frame^2) and
   zero-crossing count Z[t] (sign(0) := +1).
2. Noise statistics from the first ``n_init`` frames:
   e_noise = mean(E[:n_init]) + e_abs_floor,  z_noise = mean(Z[:n_init]).
   Thresholds: TH = e_noise * e_high_mult, TL = e_noise * e_low_mult,
   ZT = z_noise * zcr_mult + 5.0.
3. A *core* region runs from the first frame of the first run of
   ``min_speech_frames`` consecutive frames with E > TH, to the last
   frame of the last such run.
4. The start is extended backwards while (E > TL or Z > ZT) holds on the
   preceding frame; the end symmetrically forwards; then
   ``hangover_frames`` extra frames are appended to the end.
5. If no core run exists the whole signal is returned with found=False.

Returns (start_frame, end_frame_exclusive, found).
"""

from __future__ import annotations

import numpy as np

from dsp_asr.config import FrontendConfig, VadConfig
from dsp_asr.golden.frontend import frame_signal

ZCR_ABS_FLOOR = 5.0


def short_time_energy(frames: np.ndarray) -> np.ndarray:
    """Per-frame sum of squares -> [n_frames]."""
    return np.sum(np.asarray(frames, dtype=np.float64) ** 2, axis=-1)


def zero_crossing_rate(frames: np.ndarray) -> np.ndarray:
    """Per-frame count of sign changes (sign(0) := +1) -> [n_frames]."""
    frames = np.asarray(frames, dtype=np.float64)
    s = np.where(frames >= 0.0, 1.0, -1.0)
    return np.sum(s[..., 1:] != s[..., :-1], axis=-1).astype(np.float64)


def thresholds(e: np.ndarray, z: np.ndarray, vcfg: VadConfig):
    """(TH, TL, ZT) shared by both detectors — the loop spec of
    ops/vad.py:_noise_thresholds.

    ``noise_mult``: the classical head-frame rule (module docstring
    step 2).  ``two_pass`` (round 5, the hostile-0dB remedy — see
    config.py:VadConfig): floor = mean of the lowest ``tp_floor_frac``
    fraction of frame energies over the WHOLE utterance, ceil = the
    ``tp_ceil_q`` energy quantile (nearest-rank on the sorted array,
    index floor(q*(n-1))); TH/TL interpolate between them, falling back
    to noise_mult when ceil < tp_min_contrast * floor (no speech-like
    contrast — pure stationary noise reads ~1.2x).
    """
    n = len(e)
    n_init = min(vcfg.n_init, n)
    e_noise = float(np.mean(e[:n_init])) + vcfg.e_abs_floor
    z_noise = float(np.mean(z[:n_init]))
    th = e_noise * vcfg.e_high_mult
    tl = e_noise * vcfg.e_low_mult
    zt = z_noise * vcfg.zcr_mult + ZCR_ABS_FLOOR
    if vcfg.threshold_mode == "two_pass":
        e_sorted = np.sort(e)
        # rank indices in integer-percent arithmetic so the traced JAX
        # mirror (f32 scalars) lands on the SAME frame bit-for-bit
        fp = round(vcfg.tp_floor_frac * 100)
        cq = round(vcfg.tp_ceil_q * 100)
        k = max(1, (fp * n + 99) // 100)             # ceil(frac * n)
        floor = float(np.mean(e_sorted[:k])) + vcfg.e_abs_floor
        ceil = float(e_sorted[(cq * (n - 1)) // 100])
        if ceil >= vcfg.tp_min_contrast * floor:
            th = floor + vcfg.tp_high * (ceil - floor)
            tl = floor + vcfg.tp_low * (ceil - floor)
    elif vcfg.threshold_mode != "noise_mult":
        raise ValueError(
            f"unknown VadConfig.threshold_mode {vcfg.threshold_mode!r}")
    return th, tl, zt


def detect_endpoints(
    x: np.ndarray,
    fcfg: FrontendConfig = FrontendConfig(),
    vcfg: VadConfig = VadConfig(),
):
    """Detect the speech region of an isolated-word signal.

    Returns (start_frame, end_frame_exclusive, found); frame indices are
    on the standard framing grid of ``fcfg``.
    """
    frames = frame_signal(x, fcfg.frame_len, fcfg.hop_len)
    n = frames.shape[0]
    if n == 0:
        return 0, 0, False
    e = short_time_energy(frames)
    z = zero_crossing_rate(frames)
    th, tl, zt = thresholds(e, z, vcfg)

    high = e > th
    # first / last run of min_speech_frames consecutive high frames
    start_core = -1
    end_core = -1
    run = 0
    for t in range(n):
        run = run + 1 if high[t] else 0
        if run >= vcfg.min_speech_frames:
            if start_core < 0:
                start_core = t - vcfg.min_speech_frames + 1
            end_core = t
    if start_core < 0:
        return 0, n, False

    audible = (e > tl) | (z > zt)
    start = start_core
    while start > 0 and audible[start - 1]:
        start -= 1
    end = end_core
    while end + 1 < n and audible[end + 1]:
        end += 1
    end_excl = min(n, end + 1 + vcfg.hangover_frames)
    return int(start), int(end_excl), True


def detect_segments(
    x: np.ndarray,
    fcfg: FrontendConfig = FrontendConfig(),
    vcfg: VadConfig = VadConfig(),
):
    """Split a recording into speech segments (connected-word detector).

    The reference's endpoint detector both trims silence and *splits
    utterances* (SURVEY.md §1a L1: ``detect_endpoints(x) -> (start, end)
    or list of segments``).  This is the splitting variant; like the
    isolated detector above it is *specified here* — no reference
    checkout exists (SURVEY.md §0) — and the JAX implementation in
    dsp_asr/ops/vad.py must match it frame-for-frame.

    Spec (offline, multi-utterance; thresholds as in detect_endpoints):

    1. *Core* frames are frames belonging to any run of
       ``min_speech_frames`` consecutive frames with E > TH.
    2. Each maximal run of ``audible | core`` frames containing at least
       one core frame is a *region* (identical to extending every core
       run backwards/forwards through audible frames).
    3. A silence gap strictly between two regions merges them iff it is
       shorter than ``max_silence_frames`` (the same constant that ends
       an utterance in the streaming detector, ops/streaming.py).
    4. Every region's end then gains ``hangover_frames``; regions that
       touch or overlap after hangover merge.
    5. Regions shorter than ``min_utterance_frames`` are dropped.

    Returns a list of (start_frame, end_frame_exclusive) tuples in time
    order (empty if no core run exists).
    """
    frames = frame_signal(x, fcfg.frame_len, fcfg.hop_len)
    if frames.shape[0] == 0:
        return []
    return detect_segments_frames(short_time_energy(frames),
                                  zero_crossing_rate(frames), vcfg)


def detect_segments_frames(
    e: np.ndarray,
    z: np.ndarray,
    vcfg: VadConfig = VadConfig(),
):
    """The splitter's loop spec on per-frame energy/ZCR vectors [T].

    Exposed separately so the JAX mirror can be validated by exhaustive
    enumeration over small silent/audible/high frame patterns
    (tests/test_vad_segments.py), the same way the Itakura recurrence is
    pinned.
    """
    n = len(e)
    if n == 0:
        return []

    th, tl, zt = thresholds(e, z, vcfg)

    high = e > th
    audible = (e > tl) | (z > zt)

    # 1. core mask: frames inside any qualifying run of high frames
    core = np.zeros(n, dtype=bool)
    run = 0
    for t in range(n):
        run = run + 1 if high[t] else 0
        if run >= vcfg.min_speech_frames:
            core[t - vcfg.min_speech_frames + 1 : t + 1] = True
    if not core.any():
        return []

    # 2. regions = maximal (audible|core)-runs containing a core frame
    conn = audible | core
    region = np.zeros(n, dtype=bool)
    t = 0
    while t < n:
        if conn[t]:
            u = t
            while u + 1 < n and conn[u + 1]:
                u += 1
            if core[t : u + 1].any():
                region[t : u + 1] = True
            t = u + 1
        else:
            t += 1

    # 3. bridge short interior gaps
    merged = region.copy()
    t = 0
    while t < n:
        if not region[t]:
            u = t
            while u + 1 < n and not region[u + 1]:
                u += 1
            interior = t > 0 and u < n - 1
            if interior and (u - t + 1) < vcfg.max_silence_frames:
                merged[t : u + 1] = True
            t = u + 1
        else:
            t += 1

    # 4. hangover (mask formulation merges touching regions naturally)
    final = merged.copy()
    last = -10**9
    for t in range(n):
        if merged[t]:
            last = t
        elif t - last <= vcfg.hangover_frames:
            final[t] = True

    # 5. extract + drop short regions
    out = []
    t = 0
    while t < n:
        if final[t]:
            u = t
            while u + 1 < n and final[u + 1]:
                u += 1
            if (u - t + 1) >= vcfg.min_utterance_frames:
                out.append((int(t), int(u + 1)))
            t = u + 1
        else:
            t += 1
    return out
