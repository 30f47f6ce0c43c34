"""Capability results matrix: every recognizer x accuracy + throughput.

Evaluates all model families / matchers on a common synthetic corpus
(10 words, 5 enrollment + 10 test utterances each) on the current
device and prints a markdown table (docs/RESULTS.md is generated from
this).  Run:  python scripts/results_matrix.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    from dsp_asr.config import DtwConfig, FrontendConfig, HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import DIGITS, make_corpus
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    train = make_corpus(DIGITS, n_per_word=5, seed=0)
    test = make_corpus(DIGITS, n_per_word=10, seed=5000)
    n_test = sum(len(v) for v in test.values())
    rows = []

    def timed_eval(rec):
        rec.evaluate(test)                 # warm: compiles the full batch
        t0 = time.perf_counter()
        res = rec.evaluate(test)
        dt = time.perf_counter() - t0
        return res["accuracy"], n_test / dt

    def knn(label, **kw):
        rec = KnnDtwRecognizer(**kw)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        acc, rate = timed_eval(rec)
        rows.append((label, acc, rate, rec.n_templates))

    knn("kNN-DTW (default: banded 0.17)", cfg=PipelineConfig())
    knn("kNN-DTW (k=3)", cfg=PipelineConfig(), k=3)
    knn("kNN-DTW (banded 0.2)",
        cfg=PipelineConfig(dtw=DtwConfig(band_frac=0.2)))
    knn("kNN-DTW (unbanded)",
        cfg=PipelineConfig(dtw=DtwConfig(band_frac=None)))
    knn("kNN-DTW (Itakura slope)",
        cfg=PipelineConfig(dtw=DtwConfig(slope="itakura")))
    knn("kNN-LTW (fast matcher)", cfg=PipelineConfig(), matcher="ltw")
    knn("cascade (LTW shortlist + DTW rerank)",
        cfg=PipelineConfig(), matcher="cascade")
    knn("kNN-DTW (LPCC features)",
        cfg=PipelineConfig(frontend=FrontendConfig(feature_type="lpcc")))
    knn("kNN-DTW (CMN)",
        cfg=PipelineConfig(frontend=FrontendConfig(cmn=True)))

    # condensed bank (DBA)
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    rec.condense("dba", n_iter=3)
    acc, rate = timed_eval(rec)
    rows.append(("kNN-DTW (DBA-condensed bank)", acc, rate, rec.n_templates))

    from dsp_asr.config import VqConfig
    from dsp_asr.models.vq import VqRecognizer
    vrec = VqRecognizer(PipelineConfig(), VqConfig())
    vrec.fit(train)
    acc, rate = timed_eval(vrec)
    rows.append(("VQ codebook (64 codes)", acc, rate,
                 f"{len(vrec.labels)}x64"))

    for mode in ("viterbi", "baum_welch"):
        hrec = GmmHmmRecognizer(PipelineConfig(),
                                HmmConfig(n_states=5, n_mix=2, n_iter=6,
                                          train_mode=mode))
        hrec.fit(train)
        hrec.evaluate(test)                # warm
        t0 = time.perf_counter()
        res = hrec.evaluate(test)
        dt = time.perf_counter() - t0
        rows.append((f"GMM-HMM ({mode})", res["accuracy"], n_test / dt, "-"))

    dev = jax.devices()[0]
    print(f"device: {dev}")
    print()
    print("| recognizer | accuracy | utterances/s | bank size |")
    print("|---|---|---|---|")
    for label, acc, rate, k in rows:
        print(f"| {label} | {acc:.3f} | {rate:,.0f} | {k} |")


if __name__ == "__main__":
    main()
