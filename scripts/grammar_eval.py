"""Does a word grammar buy accuracy? (docs/RESULTS.md)

Samples connected GAPLESS digit strings WITHOUT immediate repetition
(a constructive walk over the no-repeat pair graph), then decodes them
with and without telling the decoder that grammar (ops/grammar.py,
no_repeat) at increasing noise.  Both joint decoders are measured:
level building (kNN template bank) and connected Viterbi (GMM-HMM).
The grammar is honest side information — every truth satisfies it — so
any WER gap is the value of syntactic constraints under noise, the
Rabiner & Juang "level building with syntactic constraints" argument.
Accuracy is backend-independent; run anywhere:

    python scripts/grammar_eval.py [--clips 40] [--noise 0.01,0.05] \
        [--platform cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips", type=int, default=40)
    ap.add_argument("--noise", default="0.01,0.03,0.05",
                    help="comma list of additive-noise sigmas")
    ap.add_argument("--train-noise", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=300)
    ap.add_argument("--word-penalty", type=float, default=0.0)
    ap.add_argument("--platform", default="",
                    help="jax platform override, e.g. cpu")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, make_corpus, synth_connected
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.pipeline import edit_distance

    cfg = PipelineConfig()
    corpus = make_corpus(n_per_word=3, seed=0, noise=args.train_noise)
    grammar = {"no_repeat": True}

    knn = KnnDtwRecognizer(cfg, k=1)
    for lab, xs in corpus.items():
        knn.enroll(lab, xs)
    hmm = GmmHmmRecognizer(cfg)
    hmm.fit(corpus)
    # PMC-adapted twin: isolates the grammar's contribution from the
    # known clean-trained emission collapse (docs/RESULTS.md) at high
    # noise — grammar constrains the decode, PMC fixes the emissions
    hmm_adapt = GmmHmmRecognizer(cfg, noise_adapt=True)
    hmm_adapt.labels, hmm_adapt.params = hmm.labels, hmm.params

    rng = np.random.default_rng(args.seed)
    truths = []
    for _ in range(args.clips):
        n = int(rng.integers(2, 6))
        labs = [DIGITS[int(rng.integers(10))]]
        for _ in range(n - 1):
            step = int(rng.integers(9))   # walk avoiding self-loops
            cur = DIGITS.index(labs[-1])
            labs.append(DIGITS[(cur + 1 + step) % 10])
        truths.append(labs)
    n_words = sum(len(t) for t in truths)

    print(f"# grammar eval: {args.clips} gapless clips, {n_words} words, "
          f"truths repeat-free; grammar = no_repeat; "
          f"train-noise={args.train_noise}")
    print("| decoder | noise | WER plain | WER grammar | exact plain | "
          "exact grammar |")
    print("|---|---|---|---|---|---|")
    for sigma in [float(x) for x in args.noise.split(",")]:
        clips = [synth_connected(t, args.seed + 7000 + i, noise=sigma,
                                 gap_ms=(0.0, 1.0))
                 for i, t in enumerate(truths)]
        for name, fam in (("kNN level building", knn),
                          ("GMM-HMM connected Viterbi", hmm),
                          ("GMM-HMM +noise-adapt", hmm_adapt)):
            cells = []
            for g in (None, grammar):
                got = fam.classify_connected(
                    clips, method="level", word_penalty=args.word_penalty,
                    grammar=g)
                errs = sum(edit_distance(a, t) for a, t in zip(got, truths))
                exact = sum(a == t for a, t in zip(got, truths))
                cells.append((errs / n_words, exact / args.clips))
            print(f"| {name} | {sigma} | {cells[0][0]:.3f} | "
                  f"{cells[1][0]:.3f} | {cells[0][1]:.3f} | "
                  f"{cells[1][1]:.3f} |", flush=True)


if __name__ == "__main__":
    main()
