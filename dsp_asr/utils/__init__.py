"""Utilities: logging/metrics, profiling, the persistent compile cache."""

from dsp_asr.utils.logging import RunMetrics, get_logger
from dsp_asr.utils.profiling import StageTimer, stage, trace

__all__ = ["get_logger", "RunMetrics", "trace", "stage", "StageTimer"]
