"""JAX op library: MFCC front-end, VAD, DTW, HMM lattices (SURVEY.md N3)."""

from dsp_asr.ops.frontend import (
    FrontendMatrices,
    make_matrices,
    preemphasis,
    frame,
    mfcc,
    mfcc_from_frames,
    deltas,
    masked_deltas,
    add_deltas,
)
from dsp_asr.ops.vad import detect_endpoints, detect_endpoints_frames
from dsp_asr.ops.dtw import dtw_distance, dtw_batch, masked_cost, dtw_from_cost
from dsp_asr.ops.viterbi import viterbi_score, viterbi_decode, forward_score

__all__ = [
    "FrontendMatrices", "make_matrices", "preemphasis", "frame", "mfcc",
    "mfcc_from_frames", "deltas", "masked_deltas", "add_deltas",
    "detect_endpoints", "detect_endpoints_frames",
    "dtw_distance", "dtw_batch", "masked_cost", "dtw_from_cost",
    "viterbi_score", "viterbi_decode", "forward_score",
]

from dsp_asr.ops.align import dtw_alignment, dba_average, medoid  # noqa: E402

__all__ += ["dtw_alignment", "dba_average", "medoid"]

from dsp_asr.ops.dtw import dtw_batch_bidi, dtw_distance_bidi  # noqa: E402
from dsp_asr.ops.dtw_banded import dtw_batch_windowed, window_for_band  # noqa: E402
from dsp_asr.ops.frontend import time_normalize  # noqa: E402
from dsp_asr.ops.lpc import lpcc  # noqa: E402

__all__ += ["dtw_batch_bidi", "dtw_distance_bidi", "dtw_batch_windowed",
            "window_for_band", "time_normalize", "lpcc"]

from dsp_asr.ops.grammar import Grammar  # noqa: E402

__all__ += ["Grammar"]
