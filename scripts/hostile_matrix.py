"""Hostile-benchmark matrix: conditions x configurations (round-2 verdict).

Evaluates kNN-DTW configurations on the hostile corpus
(dsp_asr/io/hostile.py: 35 confusable classes, held-out speakers,
noise / channel-tilt / reverb conditions) and prints a markdown matrix
for docs/RESULTS.md.  Unlike the default corpus, the defaults do NOT
score 1.000 here — the matrix is the evidence base for tuning/defending
band_frac, CMN, denoise and slope.  Run:

    python scripts/hostile_matrix.py          # full matrix (minutes on the GPU)
    python scripts/hostile_matrix.py --quick  # 1 test speaker, 4 conditions
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    plat = os.environ.get("DSP_ASR_PLATFORM", "")
    if plat:
        # pin the platform before first backend use
        import jax
        jax.config.update("jax_platforms", plat)
    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    from dsp_asr.config import (DtwConfig, FrontendConfig, PipelineConfig,
                                VadConfig)
    from dsp_asr.io.hostile import hostile_vocab, make_hostile_corpus
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    quick = "--quick" in sys.argv

    def _listed(flag):
        # --conditions a,b,c / --configs n1,n2: subset the matrix (a full
        # run is 11 configs x 8 conditions; a targeted re-measure, e.g.
        # the round-5 2pass/causal-cmn columns, needs only a slice)
        if flag in sys.argv:
            return tuple(sys.argv[sys.argv.index(flag) + 1].split(","))
        return None

    vocab = hostile_vocab()
    train_speakers = (0, 1, 2)
    test_speakers = (4,) if quick else (4, 5)
    n_train_per, n_test_per = 2, 2
    conditions = (("clean", "snr10", "snr0", "tilt") if quick else
                  ("clean", "snr20", "snr10", "snr5", "snr0",
                   "tilt", "reverb", "tilt+snr10"))
    conditions = _listed("--conditions") or conditions
    only_configs = _listed("--configs")

    def fcfg(**kw):
        return FrontendConfig(**kw)

    configs = [
        ("default", PipelineConfig(), {}),
        ("cmn", PipelineConfig(frontend=fcfg(cmn=True)), {}),
        ("denoise", PipelineConfig(
            frontend=fcfg(denoise="spectral_subtraction")), {}),
        ("band .10", PipelineConfig(dtw=DtwConfig(band_frac=0.10)), {}),
        ("band .25", PipelineConfig(dtw=DtwConfig(band_frac=0.25)), {}),
        ("itakura", PipelineConfig(dtw=DtwConfig(slope="itakura")), {}),
        ("k=3", PipelineConfig(), {"k": 3}),
        ("cmn+denoise", PipelineConfig(
            frontend=fcfg(cmn=True, denoise="spectral_subtraction")), {}),
        # round 5 (VERDICT r4 #5): SNR-adaptive two-pass VAD thresholds
        # — the structural noise_mult failure at ~0 dB is TH = 4x noise
        # never firing; two_pass interpolates floor..ceiling instead
        ("2pass", PipelineConfig(
            vad=VadConfig(threshold_mode="two_pass")), {}),
        ("2pass+dn", PipelineConfig(
            vad=VadConfig(threshold_mode="two_pass"),
            frontend=fcfg(denoise="spectral_subtraction")), {}),
        # round 5 (VERDICT r4 #6): causal CMN — quantify the streaming
        # mode's divergence from offline utterance CMN on clean/tilt
        ("causal-cmn", PipelineConfig(
            frontend=fcfg(cmn=True, cmn_mode="causal")), {}),
    ]
    if only_configs:
        configs = [c for c in configs if c[0] in only_configs]

    train = make_hostile_corpus(vocab, speakers=train_speakers,
                                n_per=n_train_per)
    recs = []
    for name, cfg, kw in configs:
        rec = KnnDtwRecognizer(cfg, **kw)
        for lab, sigs in train.items():
            rec.enroll(lab, sigs)
        recs.append((name, rec))

    results = {}          # condition -> {config: accuracy}
    t0 = time.perf_counter()
    for cond in conditions:
        test = make_hostile_corpus(vocab, speakers=test_speakers,
                                   n_per=n_test_per, seed=9, condition=cond)
        row = {}
        for name, rec in recs:
            row[name] = rec.evaluate(test)["accuracy"]
        results[cond] = row
        print(f"# {cond}: " + "  ".join(f"{k}={v:.3f}" for k, v in row.items()),
              file=sys.stderr, flush=True)
    dt = time.perf_counter() - t0

    n_q = len(vocab) * len(test_speakers) * n_test_per
    dev = jax.devices()[0]
    print(f"device: {dev}; bank {len(vocab) * len(train_speakers) * n_train_per}"
          f" templates, {n_q} queries/condition, {dt:.0f}s total")
    print()
    names = [n for n, _, _ in configs]
    print("| condition | " + " | ".join(names) + " |")
    print("|---" * (len(names) + 1) + "|")
    for cond in conditions:
        row = results[cond]
        best = max(row.values())
        cells = [f"**{row[n]:.3f}**" if row[n] == best else f"{row[n]:.3f}"
                 for n in names]
        print(f"| {cond} | " + " | ".join(cells) + " |")
    print()
    print(json.dumps({"results": results, "n_queries": n_q}))


if __name__ == "__main__":
    main()
