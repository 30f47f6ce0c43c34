"""Golden end-to-end feature pipeline (oracle for dsp_asr/pipeline.py).

Canonical contract (what "recognize(wav)" means in this framework, the
same chain as the reference's SURVEY.md §3.1 call stack):

    1. VAD on the raw signal -> frame range [start_f, end_f) on the
       standard framing grid (whole signal if nothing found).
    2. MFCC over the full pre-emphasised signal; keep the VAD frames.
    3. Deltas computed on the *trimmed* coefficient sequence.
"""

from __future__ import annotations

import numpy as np

from dsp_asr.config import PipelineConfig
from dsp_asr.golden.frontend import mfcc, deltas
from dsp_asr.golden.vad import detect_endpoints
from dsp_asr.golden.dtw import classify as dtw_classify


def extract_features(x: np.ndarray, pcfg: PipelineConfig = PipelineConfig()):
    """Signal -> (features [T', n_feats], T')."""
    if pcfg.frontend.feature_type == "lpcc":
        from dsp_asr.golden.lpc import lpcc
        c = lpcc(x, pcfg.frontend)
    else:
        c = mfcc(x, pcfg.frontend)
    if pcfg.use_vad:
        s, e, _ = detect_endpoints(x, pcfg.frontend, pcfg.vad)
        c = c[s:e]
    if pcfg.frontend.cmn and c.shape[0] > 0:
        if pcfg.frontend.cmn_mode == "causal":
            from dsp_asr.golden.frontend import causal_cmn
            c = causal_cmn(c, pcfg.frontend.cmn_alpha)
        else:
            c = c - c.mean(axis=0, keepdims=True)
    if pcfg.frontend.add_deltas:
        d1 = deltas(c, pcfg.frontend.delta_width)
        d2 = deltas(d1, pcfg.frontend.delta_width)
        c = np.concatenate([c, d1, d2], axis=-1)
    return c, c.shape[0]


def recognize(x: np.ndarray, bank, pcfg: PipelineConfig = PipelineConfig(),
              dtw_cfg=None):
    """Signal + [(label, template feats)] bank -> (label, distances).

    The banded window schedule is planned on the device pipeline's padded
    problem shape (max_frames x max_frames) so distances match the padded
    jax implementations exactly even for extreme-warp pairs.
    """
    feats, _ = extract_features(x, pcfg)
    return dtw_classify(feats, bank, dtw_cfg or pcfg.dtw,
                        plan_shape=(pcfg.max_frames, pcfg.max_frames))
