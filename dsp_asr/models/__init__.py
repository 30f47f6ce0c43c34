"""Recognizer model families: kNN-DTW (primary) and GMM-HMM (statistical)."""

from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.gmm_hmm import GmmHmmRecognizer, HmmParams, fit_word, score_words

__all__ = ["KnnDtwRecognizer", "GmmHmmRecognizer", "HmmParams", "fit_word", "score_words"]

from dsp_asr.models.streaming import StreamingRecognizer  # noqa: E402

__all__.append("StreamingRecognizer")

from dsp_asr.models.spotter import (KeywordSpotter, StreamingSpotter,  # noqa: E402
                                    HmmSpotter, CascadeSpotter,
                                    StreamingHmmSpotter,
                                    StreamingCascadeSpotter)

__all__ += ["KeywordSpotter", "StreamingSpotter", "HmmSpotter",
            "CascadeSpotter", "StreamingHmmSpotter",
            "StreamingCascadeSpotter"]
