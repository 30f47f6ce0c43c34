"""Keyword-spotting accuracy matrix (docs/RESULTS.md).

Enrolls a keyword bank from the standard synthetic corpus, then sweeps
detection thresholds over continuous keyword+distractor streams
(io/dataset.py:synth_spotting_stream) at several additive-noise levels,
reporting precision / recall / F1 per (threshold, noise) cell — the
operating-curve table behind the `spot --threshold` default.  A spotted
event is a true positive when its frame span covers >= 50% of a
same-label planted keyword (one match per plant); with --family hmm
the hit rule is the standard KWS span-midpoint-inside-truth (the HMM
LLR peaks on a word's high-contrast core — landmark spans).  Accuracy
is backend-independent; run anywhere:

    JAX_PLATFORMS=cpu python scripts/spot_eval.py [--streams 20]
    JAX_PLATFORMS=cpu python scripts/spot_eval.py --family hmm \
        --thresholds=-60,-45,-30,-15,0
    JAX_PLATFORMS=cpu python scripts/spot_eval.py --family cascade

--family cascade: HMM landmarks propose, exact DTW reranks
(models/spotter.py:CascadeSpotter); events carry full-word DTW spans,
so the hit rule and threshold units are the DTW family's.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def score(events_per_stream, truths_per_stream, hop, midpoint=False):
    tp = fa = n_truth = 0
    for evs, truth in zip(events_per_stream, truths_per_stream):
        unmatched = [(lab, s // hop, e // hop) for lab, s, e in truth]
        n_truth += len(unmatched)
        for lab, s, e, _ in evs:
            hit = None
            for i, (tl, ts, te) in enumerate(unmatched):
                if midpoint:
                    good = ts <= (s + e) / 2.0 <= te
                else:
                    ov = min(e, te) - max(s, ts) + 1
                    good = ov >= 0.5 * (te - ts + 1)
                if tl == lab and good:
                    hit = i
                    break
            if hit is None:
                fa += 1
            else:
                tp += 1
                unmatched.pop(hit)
    prec = tp / max(tp + fa, 1)
    rec = tp / max(n_truth, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return prec, rec, f1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=20)
    ap.add_argument("--words-per-stream", type=int, default=8)
    ap.add_argument("--thresholds", default="20,25,30,40,50,60")
    ap.add_argument("--noises", default="0.003,0.02,0.05")
    ap.add_argument("--family", choices=["dtw", "hmm", "cascade"],
                    default="dtw")
    ap.add_argument("--hmm-threshold", type=float, default=-45.0,
                    help="cascade stage-1 candidate LLR floor")
    ap.add_argument("--cand-min-gap", type=int, default=25,
                    help="cascade stage-1 landmark suppression margin")
    ap.add_argument("--noise-adapt", action="store_true",
                    help="hmm family: PMC-adapt the word HMMs AND the "
                         "UBM filler to each batch's estimated noise "
                         "floor (models/spotter.py:HmmSpotter)")
    args = ap.parse_args()

    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, synth_spotting_stream, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.spotter import KeywordSpotter

    cfg = PipelineConfig()
    keywords = DIGITS[:5]
    distract = DIGITS[5:]
    if args.family in ("hmm", "cascade"):
        from dsp_asr.config import HmmConfig
        from dsp_asr.io.dataset import make_corpus
        from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
        from dsp_asr.models.spotter import HmmSpotter
        hrec = GmmHmmRecognizer(cfg, HmmConfig(n_states=4, n_mix=2,
                                               n_iter=4))
        hrec.fit(make_corpus(keywords, n_per_word=5, seed=0))
        hrec.noise_adapt = args.noise_adapt
        spotter = HmmSpotter(hrec)
        rec = hrec
        higher_better = True
        if args.family == "cascade":
            from dsp_asr.models.spotter import CascadeSpotter
            brec = KnnDtwRecognizer(cfg)
            for lab in keywords:
                brec.enroll(lab, [synth_word(lab, i) for i in range(3)])
            spotter = CascadeSpotter(
                hrec, brec, hmm_threshold=args.hmm_threshold,
                cand_min_gap=args.cand_min_gap)
            higher_better = False          # DTW-score events, full spans
    else:
        rec = KnnDtwRecognizer(cfg)
        for lab in keywords:
            rec.enroll(lab, [synth_word(lab, i) for i in range(3)])
        spotter = KeywordSpotter(rec)
        higher_better = False

    thresholds = [float(t) for t in args.thresholds.split(",")]
    noises = [float(n) for n in args.noises.split(",")]
    hop = cfg.frontend.hop_len

    print(f"# family={args.family}"
          + (" (noise-adapt)" if getattr(args, "noise_adapt", False)
             else ""))
    print(f"# spotting matrix: {args.streams} streams x "
          f"{args.words_per_stream} words, {len(keywords)} keywords + "
          f"{len(distract)} distractors, 3 templates/keyword")
    print("| noise sigma | " + " | ".join(f"thr {t:g}" for t in thresholds)
          + " |")
    print("|---" * (len(thresholds) + 1) + "|")
    for noise in noises:
        sigs, truths = [], []
        for i in range(args.streams):
            sig, truth = synth_spotting_stream(
                keywords, keywords + distract, seed=5000 + i,
                n_words=args.words_per_stream, noise=noise)
            sigs.append(sig)
            truths.append(truth)
        fields = (spotter.rescored(sigs) if args.family == "cascade"
                  else spotter.scores(sigs))
        cells = []
        for thr in thresholds:
            from dsp_asr.ops.spot import extract_events
            evs = []
            if args.family == "cascade":
                evs = [spotter.suppress([ev for ev in r if ev[3] < thr])
                       for r in fields]
            elif higher_better:
                for llr, start in fields:
                    raw = extract_events(-llr, start, -thr,
                                         min_gap=spotter.min_gap)
                    evs.append([(rec.labels[r_], s, e, -neg)
                                for r_, s, e, neg in raw])
            else:
                ids = np.asarray(rec.device_bank()[1])
                for norm, start in fields:
                    raw = extract_events(norm, start, thr, labels=ids)
                    evs.append([(rec.labels[l], s, e, sc)
                                for l, s, e, sc in raw])
            p, r, f1 = score(evs, truths, hop, midpoint=higher_better)
            cells.append(f"P{p:.2f}/R{r:.2f}/F{f1:.2f}")
        print(f"| {noise:g} | " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
