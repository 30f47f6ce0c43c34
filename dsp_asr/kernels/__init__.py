"""Hand-written GPU kernels (Pallas, Triton route): fused banded DTW."""

from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded

__all__ = ["dtw_batch_fused_banded"]
