"""Golden CPU oracle for the dsp_asr framework.

An independent, loop-level-clear numpy implementation of the classical
isolated-word pipeline (pre-emphasis ... MFCC ... DTW ... Viterbi).

Because the reference checkout (AuCson/DSP-Speech-Recognition) was EMPTY
at survey time (SURVEY.md §0), this package *is* the parity target
that stands in for "matching the CPU reference to float tolerance"
(BASELINE.json north_star).  Every JAX op and every Pallas kernel in the
framework is tested against these functions.

Nothing here is performance-relevant; clarity over speed.
"""

from dsp_asr.golden.frontend import (
    preemphasis,
    frame_signal,
    hamming,
    power_spectrum,
    mel_filterbank,
    dct_matrix,
    lifter_coeffs,
    mfcc,
    deltas,
    mfcc_with_deltas,
)
from dsp_asr.golden.vad import short_time_energy, zero_crossing_rate, detect_endpoints
from dsp_asr.golden.dtw import dtw_distance, classify
from dsp_asr.golden.hmm import viterbi_log, forward_log

__all__ = [
    "preemphasis",
    "frame_signal",
    "hamming",
    "power_spectrum",
    "mel_filterbank",
    "dct_matrix",
    "lifter_coeffs",
    "mfcc",
    "deltas",
    "mfcc_with_deltas",
    "short_time_energy",
    "zero_crossing_rate",
    "detect_endpoints",
    "dtw_distance",
    "classify",
    "viterbi_log",
    "forward_log",
]

from dsp_asr.golden.lpc import lpcc as lpcc_golden  # noqa: E402
from dsp_asr.golden import lpc  # noqa: E402

__all__ += ["lpcc_golden", "lpc"]
