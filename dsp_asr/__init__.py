"""dsp_asr — an isolated-word speech recognition framework in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capability surface of
AuCson/DSP-Speech-Recognition (classical DSP recognizer: energy/ZCR VAD,
MFCC front-end, DTW template matching, optional GMM-HMM/Viterbi), built
for an accelerator: matmul front-end, min-plus-scan DTW with a fused
Pallas kernel on the GPU, mesh-sharded template banks.  See SURVEY.md for the layer
map; dsp_asr/golden is the CPU parity oracle.

Quick start::

    from dsp_asr import KnnDtwRecognizer
    rec = KnnDtwRecognizer()
    rec.enroll("yes", [signal1, signal2])
    rec.enroll("no", [signal3])
    label = rec.recognize(test_signal)
"""

from dsp_asr.config import (
    DtwConfig,
    FrontendConfig,
    HmmConfig,
    PipelineConfig,
    VadConfig,
    VqConfig,
)
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
from dsp_asr.models.streaming import StreamingRecognizer
from dsp_asr.models.vq import VqRecognizer
from dsp_asr.pipeline import (
    Features,
    classify_features,
    extract_features,
    recognize_batch,
    recognize_connected_batch,
)

__version__ = "0.1.0"


def extract_mfcc(x, cfg: PipelineConfig = PipelineConfig()):
    """Convenience: one host signal -> numpy MFCC(+deltas) features.

    Mirrors the reference's ``mfcc(x, sr) -> [T, C]`` public surface
    (SURVEY.md L2) including VAD trimming.
    """
    import numpy as np
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer as _R

    rec = _R(cfg)
    feats = rec.extract([x])
    length = int(np.asarray(feats.length)[0])
    return np.asarray(feats.feats)[0, :length]


__all__ = [
    "FrontendConfig", "VadConfig", "DtwConfig", "HmmConfig", "VqConfig",
    "PipelineConfig",
    "KnnDtwRecognizer", "GmmHmmRecognizer", "StreamingRecognizer",
    "VqRecognizer", "Features",
    "extract_features", "classify_features", "recognize_batch",
    "recognize_connected_batch", "extract_mfcc",
    "__version__",
]
