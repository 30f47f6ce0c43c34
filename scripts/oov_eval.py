"""OOV-rejection operating points on the hostile corpus.

Enrolls a SUBSET of the 35-class hostile vocabulary, calibrates the
per-bank rejection thresholds (knn: models/knn_dtw.py
calibrate_rejection; GMM-HMM: the UBM-LLR calibration in
models/gmm_hmm.py), and measures on HELD-OUT speakers the three
utterance-verification rates the threshold trades off:

* in-vocab accuracy  — accepted AND correct / in-vocab queries
* false-reject rate  — in-vocab queries rejected
* false-accept rate  — OOV queries (the un-enrolled classes) accepted

at the calibrated threshold plus a sweep around it (multiplicative for
DTW distances, additive for the HMM's per-frame LLR).  The sweep is
post-hoc over fetched score arrays, so each condition costs one
classify pass per family.

Usage: python scripts/oov_eval.py [--quick] [--conditions clean,snr5]
                                  [--enrolled 25] [--platform cpu]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    if "--platform" in sys.argv:
        plat = sys.argv[sys.argv.index("--platform") + 1]
        import jax
        jax.config.update("jax_platforms", plat)
    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import numpy as np

    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.hostile import hostile_vocab, make_hostile_corpus
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer, score_words
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    quick = "--quick" in sys.argv

    def _arg(flag, default):
        if flag in sys.argv:
            return sys.argv[sys.argv.index(flag) + 1]
        return default

    vocab = hostile_vocab()
    n_enrolled = int(_arg("--enrolled", "25"))
    in_vocab, oov = vocab[:n_enrolled], vocab[n_enrolled:]
    n_oov = _arg("--oov", "")           # cap OOV classes (CPU smokes)
    if n_oov:
        oov = oov[: int(n_oov)]
    conditions = _arg("--conditions", "clean" if quick else
                      "clean,snr10,snr5").split(",")
    train_speakers, test_speakers = (0, 1, 2), ((4,) if quick else (4, 5))
    n_train_per, n_test_per = 2, 2
    cfg = PipelineConfig()

    train = make_hostile_corpus(in_vocab, speakers=train_speakers,
                                n_per=n_train_per)
    rec = KnnDtwRecognizer(cfg)
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    thr = rec.calibrate_rejection()
    hmm = GmmHmmRecognizer(cfg, HmmConfig())
    hmm.fit(train)
    hthr = hmm.calibrate_rejection(train)
    print(f"# enrolled {len(in_vocab)} classes "
          f"({rec.n_templates} templates), {len(oov)} OOV classes; "
          f"knn threshold {thr:.2f}, hmm LLR threshold {hthr:.2f}",
          file=sys.stderr, flush=True)

    ids = np.asarray(rec._bank_label_ids)

    def knn_rates(d_in, want_ids, d_out, t):
        """Post-hoc rates at threshold t from [B, K] distance fields."""
        bd_in, bd_out = d_in.min(axis=1), d_out.min(axis=1)
        pred = ids[d_in.argmin(axis=1)]            # 1-NN label ids
        acc = float(np.mean((pred == want_ids) & (bd_in < t)))
        fr = float(np.mean(bd_in >= t))
        fa = float(np.mean(bd_out < t))
        return acc, fr, fa

    def hmm_llr(signals):
        feats = hmm.extract(signals)
        scores = np.asarray(score_words(feats.feats, feats.length,
                                        hmm.params))
        return scores.argmax(axis=1), hmm._utterance_llr(
            feats, scores, hmm.ubm)

    t0 = time.perf_counter()
    for cond in conditions:
        test_in = make_hostile_corpus(in_vocab, speakers=test_speakers,
                                      n_per=n_test_per, seed=9,
                                      condition=cond)
        test_oov = make_hostile_corpus(oov, speakers=test_speakers,
                                       n_per=n_test_per, seed=9,
                                       condition=cond)
        sig_in, want = [], []
        for lab, xs in test_in.items():
            sig_in.extend(xs)
            want.extend([rec.labels.index(lab)] * len(xs))
        want = np.asarray(want)
        sig_out = [x for xs in test_oov.values() for x in xs]

        _, d_in = rec.classify_batch(sig_in, return_distances=True)
        _, d_out = rec.classify_batch(sig_out, return_distances=True)
        print(f"\n== {cond}: {len(sig_in)} in-vocab + {len(sig_out)} OOV "
              f"queries ==")
        print("knn-dtw   thr      acc     FR      FA")
        for mult in (0.8, 0.9, 1.0, 1.1, 1.2):
            t = thr * mult
            acc, fr, fa = knn_rates(np.asarray(d_in), want,
                                    np.asarray(d_out), t)
            star = " <- calibrated" if mult == 1.0 else ""
            print(f"  x{mult:<4} {t:7.2f}  {acc:.3f}  {fr:.3f}  "
                  f"{fa:.3f}{star}")

        hpred_in, hllr_in = hmm_llr(sig_in)
        hwant = np.asarray([hmm.labels.index(rec.labels[i]) for i in want])
        _, hllr_out = hmm_llr(sig_out)
        print("gmm-hmm   thr      acc     FR      FA")
        for off in (-6.0, -3.0, 0.0, 3.0, 6.0):
            t = hthr + off
            acc = float(np.mean((hpred_in == hwant) & (hllr_in >= t)))
            fr = float(np.mean(hllr_in < t))
            fa = float(np.mean(hllr_out >= t))
            star = " <- calibrated" if off == 0.0 else ""
            print(f"  {off:+4.0f} {t:7.2f}  {acc:.3f}  {fr:.3f}  "
                  f"{fa:.3f}{star}")

    print(f"\n# device {jax.devices()[0]}; "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
