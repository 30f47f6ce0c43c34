"""Noise and channel robustness study (appends evidence to docs/RESULTS.md).

Two sweeps on the synthetic 10-word corpus:
  1. additive white noise at several SNRs -> accuracy per matcher;
  2. a test-time channel gain mismatch (x0.25 amplitude) -> accuracy
     with and without cepstral mean normalization (CMN removes the
     c0-shift a constant gain causes, so this is CMN's home turf).

Run:  python scripts/robustness.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def add_noise_snr(x, snr_db, rng):
    p_sig = float(np.mean(np.square(x)))
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return (x + rng.standard_normal(len(x)) * np.sqrt(p_noise)).astype(np.float32)


def main():
    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    from dsp_asr.config import FrontendConfig, PipelineConfig
    from dsp_asr.io.dataset import DIGITS, make_corpus
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    train = make_corpus(DIGITS, n_per_word=5, seed=0)
    test = make_corpus(DIGITS, n_per_word=5, seed=9000)
    rng = np.random.default_rng(0)

    def build(matcher="dtw", cmn=False):
        cfg = PipelineConfig(frontend=FrontendConfig(cmn=cmn))
        rec = KnnDtwRecognizer(cfg, matcher=matcher)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        return rec

    recs = {"kNN-DTW": build(), "kNN-LTW": build(matcher="ltw")}

    print("| SNR (dB) | " + " | ".join(recs) + " |")
    print("|---|" + "---|" * len(recs))
    for snr in (30, 20, 10, 5, 0):
        noisy = {lab: [add_noise_snr(x, snr, rng) for x in sigs]
                 for lab, sigs in test.items()}
        accs = [f"{rec.evaluate(noisy)['accuracy']:.2f}"
                for rec in recs.values()]
        print(f"| {snr} | " + " | ".join(accs) + " |")

    # channel gain mismatch: train at unit gain, test at 0.25x
    quiet = {lab: [(0.25 * x).astype(np.float32) for x in sigs]
             for lab, sigs in test.items()}
    plain = recs["kNN-DTW"].evaluate(quiet)["accuracy"]   # cmn=False default
    cmn = build(cmn=True).evaluate(quiet)["accuracy"]
    print()
    print("| test condition | no CMN | with CMN |")
    print("|---|---|---|")
    print(f"| 0.25x channel gain | {plain:.2f} | {cmn:.2f} |")


if __name__ == "__main__":
    main()
