"""End-to-end cascade vs full-DTW spotting wall clock (docs/PERF.md).

The cascade's compute claim measured honestly: SAME keyword set, SAME
streams, warm programs, host work (event extraction, window cutting)
included.  The scenario where the cascade's cheap parametric front
matters is a LARGE vocabulary: `--keywords 35 --templates 3` gives the
DTW spotter a 105-template subsequence scan over every stream frame,
while cascade stage 1 scans 35 HMMs (4 states x 2 mix) and stage 2
reranks only candidate windows.

    python scripts/cascade_timing.py                 # chip (or CPU)
    python scripts/cascade_timing.py --keywords 10

Reports seconds of audio processed per wall-clock second for each
spotter, per pass (median of --passes), plus the cascade's candidate
window count (its data-dependent cost driver).  Accuracy is reported
alongside so the speed comparison cannot hide a quality cliff.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--keywords", type=int, default=35)
    ap.add_argument("--templates", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--words-per-stream", type=int, default=12)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--noise", type=float, default=0.003)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="fixed threshold 40 instead of the enroll-time "
                         "bank calibration (the pre-round-5 default)")
    ap.add_argument("--distractor-weight", type=int, default=1,
                    help="replicate the distractor classes N times in "
                         "the draw vocabulary: higher = sparser "
                         "keywords (the cascade's favorable regime)")
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import make_corpus, synth_spotting_stream, \
        synth_word
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.spotter import CascadeSpotter, KeywordSpotter

    cfg = PipelineConfig()
    # distinct synthetic classes beyond the 10 digits: the same w%02d
    # vocabulary bench_all's 35-class config uses
    keywords = [f"w{i:02d}" for i in range(args.keywords)]
    distract = [f"d{i:02d}" for i in range(5)]

    brec = KnnDtwRecognizer(cfg)
    for lab in keywords:
        brec.enroll(lab, [synth_word(lab, i) for i in range(args.templates)])
    hrec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2, n_iter=4))
    hrec.fit(make_corpus(keywords, n_per_word=args.templates + 2, seed=0))

    if not args.no_calibrate:
        # mirror the CLI `enroll` default (round 5): per-bank calibrated
        # threshold stored on the recognizer, both spotters resolve it
        brec.spot_threshold = KeywordSpotter(
            brec, threshold=0.0).calibrate_threshold()
        print(f"# bank-calibrated threshold: {brec.spot_threshold:.1f} "
              f"(--no-calibrate for the fixed default "
              f"{KeywordSpotter(brec, threshold=40.0).threshold:.0f})")
    dtw = KeywordSpotter(brec)
    casc = CascadeSpotter(hrec, brec)

    vocab = keywords + distract * args.distractor_weight
    sigs, truths = [], []
    for i in range(args.streams):
        sig, truth = synth_spotting_stream(
            keywords, vocab, seed=7000 + i,
            n_words=args.words_per_stream, noise=args.noise)
        sigs.append(sig)
        truths.append(truth)
    audio_s = sum(len(s) for s in sigs) / cfg.frontend.sample_rate
    hop = cfg.frontend.hop_len

    def f1_of(events_per_stream):
        tp = fa = n_truth = 0
        for evs, truth in zip(events_per_stream, truths):
            unmatched = [(l, s // hop, e // hop) for l, s, e in truth]
            n_truth += len(unmatched)
            for lab, s, e, _ in evs:
                hit = None
                for k, (tl, ts, te) in enumerate(unmatched):
                    ov = min(e, te) - max(s, ts) + 1
                    if tl == lab and ov >= 0.5 * (te - ts + 1):
                        hit = k
                        break
                if hit is None:
                    fa += 1
                else:
                    tp += 1
                    unmatched.pop(hit)
        p = tp / max(tp + fa, 1)
        r = tp / max(n_truth, 1)
        return 2 * p * r / max(p + r, 1e-9)

    def run(name, spot_fn):
        spot_fn(sigs[:1])                      # warm compile, excluded
        times, last = [], None
        for _ in range(args.passes):
            t0 = time.monotonic()
            last = spot_fn(sigs)
            times.append(time.monotonic() - t0)
        med = sorted(times)[len(times) // 2]
        print(f"{name:>8}: {audio_s / med:8.1f} audio-s/s  "
              f"(median of {args.passes}: {med:.2f} s for {audio_s:.0f} "
              f"audio-s; min {min(times):.2f} max {max(times):.2f})  "
              f"F1 {f1_of(last):.2f}")
        return med

    print(f"# {args.keywords} keywords x {args.templates} templates "
          f"({args.keywords * args.templates}-template DTW bank vs "
          f"{args.keywords}-HMM scan), {args.streams} streams x "
          f"{args.words_per_stream} words, noise {args.noise:g}, "
          f"backend {jax.default_backend()}")
    run("dtw", lambda ss: dtw.spot(ss))
    n_cand = sum(len(evs) for evs
                 in casc.stage1.spot(sigs, threshold=casc.hmm_threshold))
    run("cascade", lambda ss: casc.spot(ss))
    print(f"# cascade stage-1 candidates: {n_cand} windows over "
          f"{args.streams} streams "
          f"({n_cand / max(args.streams, 1):.1f}/stream)")


if __name__ == "__main__":
    main()
