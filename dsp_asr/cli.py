"""Command-line interface (the reference's L4 app/driver layer).

Subcommands mirror the reference's scripts (SURVEY.md §3: enroll,
recognize, evaluate, live demo) plus training/eval for the GMM-HMM path
and corpus synthesis for users without recordings:

    python -m dsp_asr make-corpus --out data/ --n 5
    python -m dsp_asr enroll      --corpus data/train --bank bank.npz
    python -m dsp_asr recognize   --bank bank.npz one.wav two.wav
    python -m dsp_asr evaluate    --corpus data/test --bank bank.npz
    python -m dsp_asr train-hmm   --corpus data/train --model hmm.npz
    python -m dsp_asr evaluate-hmm --corpus data/test --model hmm.npz
    python -m dsp_asr demo        --bank bank.npz [--wav stream.wav]

Every flag maps 1:1 onto a config dataclass field; defaults are the
classical values (16 kHz, 25 ms/10 ms, 13 MFCC, lifter 22).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from dsp_asr.config import (DtwConfig, FrontendConfig, HmmConfig,
                            PipelineConfig, VadConfig)
from dsp_asr.utils.logging import RunMetrics, get_logger

log = get_logger("dsp_asr.cli")


def _pipeline_cfg(args) -> PipelineConfig:
    fe = FrontendConfig(
        sample_rate=args.sr,
        n_mfcc=args.n_mfcc,
        n_mels=args.n_mels,
        add_deltas=not args.no_deltas,
        use_energy=args.use_energy,
        cmn=args.cmn,
        cmn_mode=args.cmn_mode,
        cmn_alpha=args.cmn_alpha,
        feature_type=args.features,
        lpc_order=args.lpc_order,
        denoise=None if args.denoise == "none" else args.denoise,
    )
    band = None if args.band is not None and args.band <= 0 else args.band
    slope = None if args.slope == "none" else args.slope
    dtw = DtwConfig(band_frac=band, impl=args.dtw_impl, slope=slope)
    return PipelineConfig(
        frontend=fe, dtw=dtw,
        vad=VadConfig(threshold_mode=args.vad_mode),
        max_samples=args.max_samples,
        use_vad=not args.no_vad,
    )


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--n-mfcc", type=int, default=13)
    p.add_argument("--n-mels", type=int, default=26)
    p.add_argument("--max-samples", type=int, default=32000)
    p.add_argument("--no-deltas", action="store_true")
    p.add_argument("--use-energy", action="store_true")
    p.add_argument("--cmn", action="store_true",
                   help="per-utterance cepstral mean normalization")
    p.add_argument("--cmn-mode", choices=["utterance", "causal"],
                   default=FrontendConfig.cmn_mode,
                   help="'utterance' = exact mean over the utterance "
                        "(offline only); 'causal' = bias-corrected "
                        "exponential running mean — prefix-stable, so "
                        "the streaming surfaces accept it")
    p.add_argument("--cmn-alpha", type=float,
                   default=FrontendConfig.cmn_alpha,
                   help="causal-cmn forgetting factor (~2 s horizon at "
                        "the default frame rate)")
    p.add_argument("--features", choices=["mfcc", "lpcc"], default="mfcc")
    p.add_argument("--denoise", choices=["none", "spectral_subtraction"],
                   default="none",
                   help="power-spectrum noise suppression before the mel "
                        "filterbank (noise PSD from the lowest-energy "
                        "frames)")
    p.add_argument("--lpc-order", type=int, default=12)
    p.add_argument("--no-vad", action="store_true")
    p.add_argument("--vad-mode", choices=["noise_mult", "two_pass"],
                   default=VadConfig.threshold_mode,
                   help="endpoint threshold rule: 'noise_mult' = "
                        "head-frame noise estimate x multiplier (the "
                        "classical rule); 'two_pass' = whole-utterance "
                        "floor/ceiling interpolation — SNR-adaptive, "
                        "recovers speech at ~0 dB where TH=4x noise "
                        "never fires (offline only)")
    p.add_argument("--band", type=float, default=DtwConfig.band_frac,
                   help="Sakoe-Chiba band fraction (0 or negative = "
                        f"unbanded; default {DtwConfig.band_frac})")
    p.add_argument("--dtw-impl",
                   choices=["auto", "scan", "fused_banded"],
                   default=DtwConfig.impl,
                   help="auto = fused banded kernel on a GPU, XLA row "
                        "scan elsewhere (pipeline.dtw_impl)")
    p.add_argument("--slope", choices=["none", "itakura"], default="none",
                   help="DTW local slope constraint (itakura: steps "
                        "{(1,0),(1,1),(1,2)}, no repeated (1,0); length "
                        "ratios > 2 become unreachable)")
    # k / matcher / shortlist default to None sentinels so "flag passed"
    # is distinguishable from "default": evaluate/recognize/serve only
    # override a checkpoint's ENROLLED values when the user actually
    # asked (previously the argparse defaults silently clobbered them)
    p.add_argument("--k", type=int, default=None, help="kNN votes "
                   "(default: the checkpoint's enrolled value, else 1)")
    p.add_argument("--matcher", choices=["dtw", "ltw", "cascade"],
                   default=None,
                   help="cascade = LTW shortlist -> DTW rerank (faster on "
                        "large banks, near-exact); default: the "
                        "checkpoint's enrolled value, else dtw")
    p.add_argument("--shortlist", type=int, default=None,
                   help="cascade: DTW-rerank candidates per query "
                        "(default: enrolled value, else 8)")
    p.add_argument("--metrics-out", default=None,
                   help="write run metrics JSON to this path")
    p.add_argument("--mesh", action="store_true",
                   help="shard the template bank over all local devices")


def _maybe_mesh(args):
    """--mesh -> a device mesh when >1 device is visible, else None."""
    if not getattr(args, "mesh", False):
        return None
    import jax

    from dsp_asr import parallel as par
    if len(jax.devices()) <= 1:
        return None
    mesh = par.make_mesh()
    log.info("using a %s mesh", dict(mesh.shape))
    return mesh


def _load_corpus(path: str, sr: int):
    from dsp_asr.io import native
    from dsp_asr.io.dataset import load_corpus_dir
    if native.available():
        corpus = native.load_corpus_dir_native(path, target_sr=sr)
    else:
        corpus = load_corpus_dir(path, target_sr=sr)
    if not corpus:
        raise SystemExit(f"no <label>/*.wav found under {path}")
    return corpus


def _apply_matcher_flags(rec, args):
    """Apply --k/--matcher/--shortlist ONLY when explicitly passed
    (None sentinels keep the checkpoint's enrolled configuration)."""
    if getattr(args, "k", None) is not None:
        rec.k = args.k
    if getattr(args, "matcher", None) is not None:
        rec.matcher = args.matcher
    if getattr(args, "shortlist", None) is not None:
        rec.shortlist = args.shortlist


def cmd_make_corpus(args):
    from dsp_asr.io.dataset import DIGITS, make_corpus
    from dsp_asr.io.wav import write_wav
    if args.words is None:
        # unset --words tracks the corpus family: the hostile corpus is
        # DEFINED by its full 35-class confusable vocabulary (ADVICE
        # round 3: inheriting the digit default of 10 silently shrank it)
        args.words = 35 if getattr(args, "hostile", False) else 10
    if getattr(args, "hostile", False):
        if args.connected > 0:
            raise SystemExit("make-corpus: --connected is built from the "
                             "digit vocabulary and does not combine with "
                             "--hostile (run two make-corpus invocations)")
        # adversarial corpus (io/hostile.py): confusable 35-class vocab,
        # disjoint train/test speakers, optional degradation condition
        from dsp_asr.io.hostile import hostile_vocab, make_hostile_corpus
        vocab = hostile_vocab()[: args.words] if args.words < 35 \
            else hostile_vocab()
        splits = (("train", (0, 1, 2), 0, "clean"),
                  ("test", (4, 5), 9, args.condition))
        for split, speakers, seed, cond in splits:
            corpus = make_hostile_corpus(vocab, speakers=speakers,
                                         n_per=args.n, seed=seed,
                                         condition=cond)
            for lab, sigs in corpus.items():
                d = os.path.join(args.out, split, lab)
                os.makedirs(d, exist_ok=True)
                for i, x in enumerate(sigs):
                    write_wav(os.path.join(d, f"{lab}_{i:03d}.wav"), 16000, x)
        log.info("wrote hostile corpus (test condition=%s) to %s",
                 args.condition, args.out)
        return
    for split, seed in (("train", 0), ("test", 1000)):
        corpus = make_corpus(DIGITS[: args.words], n_per_word=args.n, seed=seed)
        for lab, sigs in corpus.items():
            d = os.path.join(args.out, split, lab)
            os.makedirs(d, exist_ok=True)
            for i, x in enumerate(sigs):
                write_wav(os.path.join(d, f"{lab}_{i:03d}.wav"), 16000, x)
    log.info("wrote synthetic corpus to %s", args.out)
    if args.connected > 0:
        # connected split: multi-word recordings + a labels.tsv manifest
        # (file<TAB>space-joined words), consumed by evaluate-connected
        import numpy as np

        from dsp_asr.io.dataset import synth_connected
        d = os.path.join(args.out, "connected")
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(2000)
        vocab = DIGITS[: max(1, args.words)]    # same clamp as the splits
        gap_ms = (0.0, 1.0) if args.gapless else (250.0, 600.0)
        lines = []
        for i in range(args.connected):
            labs = [vocab[int(rng.integers(len(vocab)))]
                    for _ in range(int(rng.integers(1, 6)))]
            name = f"clip_{i:03d}.wav"
            write_wav(os.path.join(d, name), 16000,
                      synth_connected(labs, 2000 + i, gap_ms=gap_ms))
            lines.append(f"{name}\t{' '.join(labs)}")
        with open(os.path.join(d, "labels.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log.info("wrote %d connected clips to %s", args.connected, d)
    if args.spotting > 0:
        # spotting split: continuous streams of keyword + distractor
        # words with an events.tsv ground truth (file<TAB>
        # label:start_sample:end_sample ...), consumed by evaluate-spot.
        # Keywords = the corpus vocabulary (what `enroll` builds a bank
        # for); distractors come from the REST of the digit vocabulary.
        from dsp_asr.io.dataset import synth_spotting_stream
        keywords = DIGITS[: args.words]
        # distractors: remaining digits, or out-of-vocabulary words when
        # the whole digit set is enrolled (synth_word is procedural in
        # the label string, so any word has a deterministic sound)
        distract = ([w for w in DIGITS if w not in keywords]
                    or ["alpha", "bravo", "charlie"])
        vocab = keywords + distract
        d = os.path.join(args.out, "spotting")
        os.makedirs(d, exist_ok=True)
        lines = []
        for i in range(args.spotting):
            sig, events = synth_spotting_stream(keywords, vocab, 3000 + i)
            name = f"stream_{i:03d}.wav"
            write_wav(os.path.join(d, name), 16000, sig)
            cells = " ".join(f"{lab}:{s}:{e}" for lab, s, e in events)
            lines.append(f"{name}\t{cells}")
        with open(os.path.join(d, "events.tsv"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log.info("wrote %d spotting streams to %s", args.spotting, d)


def cmd_enroll(args):
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    cfg = _pipeline_cfg(args)
    rec = KnnDtwRecognizer(cfg, k=args.k or 1,
                           matcher=args.matcher or "dtw",
                           shortlist=args.shortlist or 8)
    corpus = _load_corpus(args.corpus, args.sr)
    for lab, sigs in sorted(corpus.items()):
        rec.enroll(lab, sigs)
        log.info("enrolled %-8s (%d templates)", lab, len(sigs))
    if not getattr(args, "no_spot_calibration", False):
        # per-bank spotting threshold, stored in the checkpoint so
        # `spot` is vocabulary-robust by default (VERDICT r4 #4: the
        # fixed 40 silently decays at 35 keywords, F1 0.80 vs 0.91)
        from dsp_asr.models.spotter import KeywordSpotter
        try:
            rec.spot_threshold = KeywordSpotter(
                rec, threshold=0.0).calibrate_threshold()
            log.info("spotting threshold calibrated: %.1f (stored in "
                     "bank; spot uses it when --threshold is unset)",
                     rec.spot_threshold)
        except ValueError as e:
            log.info("spotting threshold not calibrated (%s); spot "
                     "falls back to the fixed default", e)
    if not getattr(args, "no_reject_calibration", False):
        # per-bank OOV-rejection threshold (utterance verification),
        # stored in the checkpoint so `recognize --reject` works out of
        # the box without the user hand-tuning a distance cutoff
        try:
            rec.calibrate_rejection()
            log.info("rejection threshold calibrated: %.3f (stored in "
                     "bank; recognize --reject uses it)",
                     rec.reject_threshold)
        except ValueError as e:
            log.info("rejection threshold not calibrated (%s); "
                     "--reject will need an explicit threshold", e)
    rec.save(args.bank)
    log.info("bank: %d templates, %d labels -> %s",
             rec.n_templates, len(rec.labels), args.bank)


def cmd_recognize(args):
    from dsp_asr.io.wav import read_wav
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    cfg = _pipeline_cfg(args)
    rec = KnnDtwRecognizer.load(args.bank, cfg)
    _apply_matcher_flags(rec, args)
    reject = _reject_arg(args)
    if reject is not None and (getattr(args, "connected", False)
                               or getattr(args, "nbest", 0) > 1):
        # fail loudly rather than silently ignore the flag (the ADVICE
        # round-4 --calibrate-threshold/--stream lesson)
        raise SystemExit("--reject applies to plain classification only "
                         "(not --connected / --nbest: the connected DP "
                         "has no per-word accept statistic and nbest "
                         "already exposes confidence weights)")
    sigs = [read_wav(p, cfg.frontend.sample_rate)[1] for p in args.wavs]
    if getattr(args, "connected", False):
        seqs = rec.classify_connected(
            sigs, max_segments=args.max_segments,
            method=getattr(args, "connected_method", "vad"),
            word_penalty=getattr(args, "word_penalty", 0.0),
            grammar=getattr(args, "grammar", None))
        for path, seq in zip(args.wavs, seqs):
            print(f"{path}\t{' '.join(seq)}")
        return
    if getattr(args, "nbest", 0) > 1:
        hyps = rec.classify_nbest(sigs, n=args.nbest)
        for path, hy in zip(args.wavs, hyps):
            cells = " ".join(f"{lab}:{d:.3f}:{w:.3f}" for lab, d, w in hy)
            print(f"{path}\t{cells}")
        return
    labels = rec.classify_batch(sigs, reject=reject)
    for path, lab in zip(args.wavs, labels):
        print(f"{path}\t{lab}")


def cmd_evaluate(args):
    cfg = _pipeline_cfg(args)
    corpus = _load_corpus(args.corpus, args.sr)   # host-side IO, no jax
    metrics = RunMetrics("evaluate")
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    rec = KnnDtwRecognizer.load(args.bank, cfg)
    rec.mesh = _maybe_mesh(args)
    _apply_matcher_flags(rec, args)
    result = rec.evaluate(corpus, reject=_reject_arg(args))
    metrics.record(accuracy=result["accuracy"], n=result["n"],
                   bank_size=rec.n_templates, config=cfg)
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        metrics.dump(args.metrics_out)


def cmd_evaluate_connected(args):
    """WER of any model family on connected multi-word recordings."""
    from dsp_asr.io.wav import read_wav
    from dsp_asr.pipeline import edit_distance

    cfg = _pipeline_cfg(args)
    given = [x for x in (args.bank, args.hmm, args.vq) if x]
    if len(given) != 1:
        raise SystemExit("evaluate-connected: give exactly one of "
                         "--bank / --hmm / --vq")
    if args.bank:
        from dsp_asr.models.knn_dtw import KnnDtwRecognizer
        rec = KnnDtwRecognizer.load(args.bank, cfg)
        _apply_matcher_flags(rec, args)
    elif args.hmm:
        from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
        rec = GmmHmmRecognizer.load(args.hmm, cfg)
        rec.noise_adapt = getattr(args, "noise_adapt", False)
    else:
        from dsp_asr.models.vq import VqRecognizer
        rec = VqRecognizer.load(args.vq, cfg)
    truths, sigs = [], []
    with open(os.path.join(args.corpus, "labels.tsv")) as f:
        for line in f:
            if not line.strip():
                continue
            name, labstr = line.rstrip("\n").split("\t")
            truths.append(labstr.split(" "))
            sigs.append(read_wav(os.path.join(args.corpus, name),
                                 cfg.frontend.sample_rate)[1])
    method = getattr(args, "connected_method", "vad")
    if method != "vad" and args.vq:
        raise SystemExit("--connected-method level supports --bank (level "
                         "building) and --hmm (connected Viterbi); the VQ "
                         "family has no frame-synchronous joint decoder")
    grammar = getattr(args, "grammar", None)
    if grammar and method == "vad":
        raise SystemExit("--grammar requires --connected-method level "
                         "(the splitter has no joint sequence to "
                         "constrain)")
    if method != "vad":
        got = rec.classify_connected(
            sigs, max_segments=args.max_segments, method=method,
            word_penalty=getattr(args, "word_penalty", 0.0),
            grammar=grammar)
    else:
        got = rec.classify_connected(sigs, max_segments=args.max_segments)
    n_words = sum(len(t) for t in truths)
    errs = sum(edit_distance(g, t) for g, t in zip(got, truths))
    exact = sum(g == t for g, t in zip(got, truths))
    wer = errs / max(n_words, 1)
    exact_acc = exact / max(len(truths), 1)
    print(f"wer: {wer:.4f} ({n_words} words)")
    print(f"exact-sequence accuracy: {exact_acc:.4f} "
          f"({len(truths)} clips)")
    if args.metrics_out:
        m = RunMetrics("evaluate-connected")
        m.record(wer=wer, exact_sequence_accuracy=exact_acc,
                 n_words=n_words, n_clips=len(truths), config=cfg)
        m.dump(args.metrics_out)


def _load_spotter(args, cfg):
    """--bank -> DTW KeywordSpotter; --hmm -> HmmSpotter (UBM filler);
    BOTH -> CascadeSpotter (HMM landmarks propose, DTW reranks)."""
    if not args.bank and not getattr(args, "hmm", None):
        raise SystemExit("spot: give --bank, --hmm, or both (cascade)")
    if getattr(args, "calibrate_threshold", False) and getattr(args, "hmm",
                                                               None):
        # the HMM/cascade thresholds are LLR-scaled, not DTW-distance
        # scaled; silently handing back the fixed default would let a
        # user believe a calibrated threshold is in force
        raise SystemExit("--calibrate-threshold applies to the DTW "
                         "spotter only (--bank without --hmm)")
    if args.bank and getattr(args, "hmm", None):
        from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
        from dsp_asr.models.knn_dtw import KnnDtwRecognizer
        from dsp_asr.models.spotter import CascadeSpotter
        hrec = GmmHmmRecognizer.load(args.hmm, cfg)
        brec = KnnDtwRecognizer.load(args.bank, cfg)
        hthr = getattr(args, "hmm_threshold", None)
        sp = CascadeSpotter(
            hrec, brec, threshold=args.threshold,
            **({} if hthr is None else {"hmm_threshold": hthr}))
        log.info("cascade stage-2 threshold %.1f (%s)", sp.threshold,
                 sp.threshold_source)
        return sp, brec
    if getattr(args, "hmm", None):
        from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
        from dsp_asr.models.spotter import HmmSpotter
        rec = GmmHmmRecognizer.load(args.hmm, cfg)
        thr = args.threshold if args.threshold is not None else 0.0
        return HmmSpotter(rec, threshold=thr), rec
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.spotter import KeywordSpotter
    rec = KnnDtwRecognizer.load(args.bank, cfg)
    rec.mesh = _maybe_mesh(args)     # --mesh: bank-sharded spot_sharded
    spotter = KeywordSpotter(rec, threshold=args.threshold)
    if getattr(args, "calibrate_threshold", False):
        # eager recalculation (e.g. an old bank saved without one)
        if args.threshold is not None:
            raise SystemExit("give --threshold or --calibrate-threshold,"
                             " not both")
        spotter.threshold = spotter.calibrate_threshold()
        spotter.threshold_source = "recalibrated"
    log.info("spotting threshold %.1f (%s)", spotter.threshold,
             spotter.threshold_source)
    return spotter, rec


def cmd_spot(args):
    """Keyword search in unsegmented WAVs (models/spotter.py)."""
    from dsp_asr.io.wav import read_wav
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.spotter import StreamingSpotter
    cfg = _pipeline_cfg(args)
    sigs = [read_wav(p, cfg.frontend.sample_rate)[1] for p in args.wavs]
    if args.stream:
        if getattr(args, "calibrate_threshold", False):
            raise SystemExit("--calibrate-threshold is not wired into "
                             "--stream; enroll with calibration (the "
                             "bank stores it) or pass --threshold")
        if getattr(args, "hmm", None) and args.bank:
            # round 5: the streaming cascade — online HMM landmarks,
            # device rerank on confirmation, bounded-lag events
            from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
            from dsp_asr.models.spotter import StreamingCascadeSpotter
            hrec = GmmHmmRecognizer.load(args.hmm, cfg)
            brec = KnnDtwRecognizer.load(args.bank, cfg)
            hthr = getattr(args, "hmm_threshold", None)
            rec = brec
            mk = lambda thr: StreamingCascadeSpotter(
                hrec, brec, threshold=thr,
                **({} if hthr is None else {"hmm_threshold": hthr}))
            thr = args.threshold     # None -> bank-calibrated or default
        elif getattr(args, "hmm", None):
            from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
            from dsp_asr.models.spotter import StreamingHmmSpotter
            rec = GmmHmmRecognizer.load(args.hmm, cfg)
            mk = lambda thr: StreamingHmmSpotter(rec, threshold=thr)
            thr = args.threshold if args.threshold is not None else 0.0
        else:
            rec = KnnDtwRecognizer.load(args.bank, cfg)
            mk = lambda thr: StreamingSpotter(rec, threshold=thr)
            thr = args.threshold     # None -> bank-calibrated or default
        # online path: feed fixed chunks, emit events as confirmed;
        # the final short chunk goes through flush(tail) so results
        # match the offline spotter on the unpadded signal
        for path, sig in zip(args.wavs, sigs):
            ss = mk(thr)
            n_full = len(sig) // ss.chunk_len * ss.chunk_len
            events = []
            for lo in range(0, n_full, ss.chunk_len):
                events += ss.feed(sig[lo:lo + ss.chunk_len])
            events += ss.flush(sig[n_full:])
            _print_spot_events(path, events, rec.cfg)
        return
    spotter, _ = _load_spotter(args, cfg)
    for path, events in zip(args.wavs, spotter.spot(sigs)):
        _print_spot_events(path, events, cfg)


def _print_spot_events(path, events, cfg):
    f = cfg.frontend
    for lab, s, e, sc in events:
        print(f"{path}\t{lab}\t{s * f.hop_len / f.sample_rate:.2f}"
              f"\t{e * f.hop_len / f.sample_rate:.2f}\t{sc:.3f}")
    if not events:
        print(f"{path}\t-")


def cmd_evaluate_spot(args):
    """Precision/recall/F1 of keyword spotting on a spotting corpus
    (make-corpus --spotting).  One match per ground-truth event;
    everything else a spotter emits is a false alarm (hit rules per
    family — see the inline comment)."""
    from dsp_asr.io.wav import read_wav
    cfg = _pipeline_cfg(args)
    spotter, rec = _load_spotter(args, cfg)
    hop = cfg.frontend.hop_len
    names, sigs, truths = [], [], []
    with open(os.path.join(args.corpus, "events.tsv")) as f:
        for line in f:
            if not line.strip():
                continue
            name, _, cellstr = line.rstrip("\n").partition("\t")
            names.append(name)
            sigs.append(read_wav(os.path.join(args.corpus, name),
                                 cfg.frontend.sample_rate)[1])
            evs = []
            for cell in cellstr.split():
                lab, s, e = cell.rsplit(":", 2)
                evs.append((lab, int(s) // hop, int(e) // hop))
            truths.append(evs)
    got = spotter.spot(sigs)
    # hit rule: 50%-span-overlap for the DTW spotter (tight spans);
    # span-midpoint-inside-truth for the HMM spotter (its LLR peaks on
    # a word's high-contrast CORE — landmark spans, the standard KWS
    # midpoint criterion)
    midpoint = bool(getattr(args, "hmm", None)) and not bool(args.bank)
    tp = fa = 0
    n_truth = sum(len(t) for t in truths)
    for evs, truth in zip(got, truths):
        unmatched = list(truth)
        for lab, s, e, _ in evs:
            best = None
            for i, (tl, ts, te) in enumerate(unmatched):
                if midpoint:
                    good = ts <= (s + e) / 2.0 <= te
                else:
                    ov = min(e, te) - max(s, ts) + 1
                    # inclusive span length on both sides: a 1-frame
                    # truth (ts==te) needs real overlap, not adjacency
                    good = ov >= 0.5 * (te - ts + 1)
                if tl == lab and good:
                    best = i
                    break
            if best is None:
                fa += 1
            else:
                tp += 1
                unmatched.pop(best)
    prec = tp / max(tp + fa, 1)
    rec_ = tp / max(n_truth, 1)
    f1 = 2 * prec * rec_ / max(prec + rec_, 1e-9)
    print(f"precision: {prec:.4f} ({tp}/{tp + fa} events)")
    print(f"recall: {rec_:.4f} ({tp}/{n_truth} keywords)")
    print(f"f1: {f1:.4f}  threshold: {spotter.threshold}")
    if args.metrics_out:
        m = RunMetrics("evaluate-spot")
        m.record(precision=prec, recall=rec_, f1=f1, tp=tp,
                 false_alarms=fa, n_truth=n_truth,
                 threshold=spotter.threshold, config=cfg)
        m.dump(args.metrics_out)


def cmd_serve(args):
    """Long-lived recognition loop: one WAV path per stdin line -> one
    tab-separated result line (path, label(s), milliseconds).

    A minimal deployment surface for scripted/piped serving: the process
    stays resident (persistent compile cache + device bank), so after
    the first request every call costs only the warm classify dispatch.
    Prefix a line with ``connected `` to decode a multi-word recording
    via the segment splitter, with ``level `` to decode it with the
    level-building DP (gapless speech — ops/level_building.py;
    ``--grammar`` constrains these), or with ``nbest `` to get the top
    ``--nbest`` isolated-word hypotheses as label:distance:weight
    triplets (rejection thresholds ride the weight), or with ``spot ``
    to keyword-search an unsegmented stream (events as
    label:start_s:end_s:score cells, ``--spot-threshold``).  EOF ends
    the loop.
    """
    import sys
    import time as _time

    from dsp_asr.io.wav import read_wav
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    cfg = _pipeline_cfg(args)
    rec = KnnDtwRecognizer.load(args.bank, cfg)
    _apply_matcher_flags(rec, args)
    spotter = None                 # built lazily on the first `spot ` line
    grammar = getattr(args, "grammar", None)
    if grammar:
        # validate once at startup (fail fast, not on the first
        # `level ` request); applies to level-mode lines only
        from dsp_asr.ops.grammar import Grammar
        g = Grammar.load(grammar, rec.labels)
        log.info("serve: %s", g.describe())
    print("ready", flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        mode = "single"
        path = line
        for prefix, m in (("connected ", "vad"), ("level ", "level"),
                          ("nbest ", "nbest"), ("spot ", "spot")):
            if line.startswith(prefix):
                mode, path = m, line[len(prefix):]
                break
        t0 = _time.perf_counter()
        try:
            x = read_wav(path, cfg.frontend.sample_rate)[1]
            if mode == "spot":
                from dsp_asr.models.spotter import KeywordSpotter
                if spotter is None:
                    spotter = KeywordSpotter(
                        rec, threshold=args.spot_threshold)
                fr = cfg.frontend
                label = " ".join(
                    f"{lab}:{s0 * fr.hop_len / fr.sample_rate:.2f}"
                    f":{e0 * fr.hop_len / fr.sample_rate:.2f}:{sc:.2f}"
                    for lab, s0, e0, sc in spotter.spot([x])[0]) or "-"
            elif mode == "nbest":
                label = " ".join(
                    f"{lab}:{d:.3f}:{w:.3f}" for lab, d, w in
                    rec.classify_nbest([x], n=args.nbest)[0])
            elif mode != "single":
                label = " ".join(rec.classify_connected(
                    [x], max_segments=args.max_segments, method=mode
                    if mode == "level" else "vad",
                    grammar=grammar if mode == "level" else None)[0])
            else:
                label = rec.recognize(x)
            ms = (_time.perf_counter() - t0) * 1e3
            print(f"{path}\t{label}\t{ms:.1f}", flush=True)
        except Exception as e:
            print(f"{path}\tERROR {type(e).__name__}: {e}", flush=True)


def cmd_train_hmm(args):
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    cfg = _pipeline_cfg(args)
    hmm = HmmConfig(n_states=args.states, n_mix=args.mix, n_iter=args.iters,
                    train_mode=args.train_mode, map_tau=args.map_tau)
    rec = GmmHmmRecognizer(cfg, hmm)
    corpus = _load_corpus(args.corpus, args.sr)
    rec.fit(corpus)
    if not getattr(args, "no_reject_calibration", False):
        # OOV-verification LLR threshold from the training corpus,
        # stored in the checkpoint (evaluate-hmm --reject uses it)
        try:
            rec.calibrate_rejection(corpus)
            log.info("rejection LLR threshold calibrated: %.3f "
                     "(stored in model)", rec.reject_threshold)
        except ValueError as e:
            log.info("rejection threshold not calibrated (%s)", e)
    rec.save(args.model)
    log.info("trained %d word HMMs -> %s", len(rec.labels), args.model)


def cmd_evaluate_hmm(args):
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    cfg = _pipeline_cfg(args)
    hmm = HmmConfig(n_states=args.states, n_mix=args.mix, n_iter=args.iters)
    rec = GmmHmmRecognizer.load(args.model, cfg, hmm)
    rec.mesh = _maybe_mesh(args)
    rec.noise_adapt = getattr(args, "noise_adapt", False)
    result = rec.evaluate(_load_corpus(args.corpus, args.sr),
                          reject=_reject_arg(args))
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        m = RunMetrics("evaluate-hmm")
        m.record(**result)
        m.dump(args.metrics_out)


def cmd_train_vq(args):
    from dsp_asr.config import VqConfig
    from dsp_asr.models.vq import VqRecognizer
    cfg = _pipeline_cfg(args)
    rec = VqRecognizer(cfg, VqConfig(n_codes=args.codes, n_iter=args.iters))
    rec.fit(_load_corpus(args.corpus, args.sr))
    rec.save(args.model)
    log.info("trained %d word codebooks -> %s", len(rec.labels), args.model)


def cmd_evaluate_vq(args):
    from dsp_asr.models.vq import VqRecognizer
    cfg = _pipeline_cfg(args)
    rec = VqRecognizer.load(args.model, cfg)
    rec.mesh = _maybe_mesh(args)
    result = rec.evaluate(_load_corpus(args.corpus, args.sr))
    print(json.dumps(result["confusion"], indent=2, sort_keys=True))
    print(f"accuracy: {result['accuracy']:.4f} ({result['n']} utterances)")
    if args.metrics_out:
        m = RunMetrics("evaluate-vq")
        m.record(**result)
        m.dump(args.metrics_out)


def cmd_warm(args):
    """Pre-compile the serving programs into the persistent XLA cache.

    A deployment pays the cold compile once, out of band:

        python -m dsp_asr warm --bank bank.npz --batches 1,256

    This drives the REAL ``classify_batch`` path on synthetic utterances
    — so exactly the programs serving will execute get compiled, with no
    shape/dispatch drift — in this process; everything it compiles lands
    in the persistent cache (``utils/cache.py``) shared with every later
    process.  Without ``--bank`` a dummy bank of ``--bank-size``
    synthetic templates is enrolled: compilation only depends on shapes
    and config, not data.
    """
    import time as _time

    from dsp_asr.io.dataset import DIGITS, synth_word

    cfg = _pipeline_cfg(args)
    batches = sorted({int(b) for b in args.batches.split(",") if b.strip()})
    t0 = _time.perf_counter()
    for b in batches:
        sigs = [synth_word(DIGITS[i % len(DIGITS)], 7000 + i,
                           max_samples=cfg.max_samples) for i in range(b)]
        t1 = _time.perf_counter()
        n_templates, matcher, k = _warm_batch(
            args.bank, cfg, args.bank_size, args.k, args.matcher,
            args.shortlist, sigs)
        print(f"warm: batch={b} bank={n_templates} matcher={matcher} "
              f"k={k} ({_time.perf_counter() - t1:.1f}s)", flush=True)
    for mult in sorted({int(m) for m in
                        getattr(args, "connected", "").split(",")
                        if m.strip()}):
        t1 = _time.perf_counter()
        _warm_connected(args.bank, cfg, args.bank_size, args.k,
                        args.max_segments, mult,
                        getattr(args, "grammar", None))
        print(f"warm: connected+spot len={mult}x max_samples "
              f"({_time.perf_counter() - t1:.1f}s)", flush=True)
    print(f"warm: done in {_time.perf_counter() - t0:.1f}s — runs at these "
          f"shapes now hit the persistent compilation cache")


def _warm_connected(bank_path, cfg, bank_size, k, max_segments, mult,
                    grammar):
    """cmd_warm's connected path: compile the splitter AND
    the level-building decode (plus the grammar DP when a spec is
    given) at one recording-length multiple — the programs `serve`'s
    'connected '/'level ' request prefixes dispatch."""
    import numpy as np

    from dsp_asr.io.dataset import DIGITS, synth_connected, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    if bank_path:
        rec = KnnDtwRecognizer.load(bank_path, cfg)
    else:
        rec = KnnDtwRecognizer(cfg, k=k or 1)
        per = max(1, -(-bank_size // len(DIGITS)))
        for lab in DIGITS:
            rec.enroll(lab, [synth_word(lab, i, max_samples=cfg.max_samples)
                             for i in range(per)])
    sig = synth_connected(rec.labels[:3] or ["zero"], seed=1)
    n = mult * cfg.max_samples
    sig = np.pad(sig[:n], (0, max(0, n - sig.shape[0])))
    rec.classify_connected([sig], max_segments=max_segments)
    rec.classify_connected([sig], max_segments=max_segments,
                           method="level")
    if grammar:
        rec.classify_connected([sig], max_segments=max_segments,
                               method="level", grammar=grammar)
    # the spot program at the same recording length (serve's `spot `
    # request prefix dispatches exactly this shape)
    from dsp_asr.models.spotter import KeywordSpotter
    KeywordSpotter(rec).scores([sig])


def _warm_batch(bank_path, cfg, bank_size, k, matcher, shortlist, sigs):
    """cmd_warm's batch path: bank construction (incl. enrollment
    extraction compiles) + the real classify."""
    from dsp_asr.io.dataset import DIGITS, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    if bank_path:
        rec = KnnDtwRecognizer.load(bank_path, cfg)
    else:
        rec = KnnDtwRecognizer(cfg, k=k or 1, matcher=matcher or "dtw",
                               shortlist=shortlist or 8)
        per = max(1, -(-bank_size // len(DIGITS)))
        for lab in DIGITS:
            rec.enroll(lab, [synth_word(lab, i, max_samples=cfg.max_samples)
                             for i in range(per)])
    rec.classify_batch(sigs)
    return rec.n_templates, rec.matcher, rec.k


def cmd_evaluate_sc2(args):
    """Speech Commands v2 35-class kNN-DTW over a sharded bank (config 4)."""
    import jax
    import jax.numpy as jnp

    from dsp_asr import parallel as par
    from dsp_asr import pipeline as pl
    from dsp_asr.io.speech_commands import load_split
    from dsp_asr.ops import frontend as fe_ops

    args.max_samples = min(args.max_samples, 16000)   # SC2 clips are <= 1 s
    cfg = _pipeline_cfg(args)
    k = args.k or 1
    if args.matcher not in (None, "dtw"):
        raise SystemExit("evaluate-sc2 implements the full banded DTW "
                         "only; --matcher ltw/cascade is not supported "
                         "here (use `evaluate` on a corpus directory)")
    mats = fe_ops.make_matrices(cfg.frontend)
    metrics = RunMetrics("evaluate-sc2")

    log.info("loading templates (train split, %d per word)", args.templates)
    tr_sigs, tr_lens, tr_ids, labels = load_split(
        args.root, "train", per_word=args.templates,
        max_samples=cfg.max_samples, seed=0)
    bank = pl.extract_features(jnp.asarray(tr_sigs), jnp.asarray(tr_lens),
                               mats, cfg)

    log.info("loading test split%s", f" (cap {args.limit})" if args.limit else "")
    te_sigs, te_lens, te_ids, te_labels = load_split(
        args.root, args.split, per_word=args.limit,
        max_samples=cfg.max_samples, seed=1)
    assert te_labels == labels

    n_dev = len(jax.devices())
    use_mesh = n_dev > 1 and not args.no_mesh
    if use_mesh:
        mesh = par.make_mesh(1, n_dev)
        bank_f, _ = par.pad_axis_to_multiple(np.asarray(bank.feats), n_dev)
        bank_l, k_orig = par.pad_axis_to_multiple(np.asarray(bank.length), n_dev)
        bank_ids, _ = par.pad_axis_to_multiple(tr_ids, n_dev)
        bank_l = np.maximum(bank_l, 1)
        valid = np.arange(len(bank_l)) < k_orig
        bf = par.shard_bank(mesh, bank_f)
        bl = par.shard_bank(mesh, bank_l)
        bv = par.shard_bank(mesh, valid)
        idsd = par.replicate(mesh, bank_ids)
        log.info("bank sharded over %d devices (%d templates)", n_dev, k_orig)

    import time
    correct = total = 0
    t0 = time.perf_counter()
    bs = args.batch
    for lo in range(0, len(te_sigs), bs):
        sl = slice(lo, min(lo + bs, len(te_sigs)))
        sigs = np.zeros((bs, cfg.max_samples), np.float32)
        lens = np.ones(bs, np.int32)
        n_real = sl.stop - sl.start
        sigs[:n_real] = te_sigs[sl]
        lens[:n_real] = te_lens[sl]
        if use_mesh:
            qd, qld = par.shard_queries(mesh, sigs, lens)
            got, _ = par.recognize_sharded(mesh, qd, qld, mats, bf, bl, idsd,
                                           bv, cfg=cfg, k=k,
                                           n_labels=len(labels))
        elif k > 1:
            feats = pl.extract_features(jnp.asarray(sigs),
                                        jnp.asarray(lens), mats, cfg)
            got, _ = pl.classify_features(feats, bank, jnp.asarray(tr_ids),
                                          n_labels=len(labels), k=k,
                                          cfg=cfg)
        else:
            got, _ = pl.recognize_batch(jnp.asarray(sigs), jnp.asarray(lens),
                                        mats, bank, jnp.asarray(tr_ids), cfg)
        got = np.asarray(got)[:n_real]
        correct += int((got == te_ids[sl]).sum())
        total += n_real
        log.info("  %d/%d acc=%.4f", total, len(te_sigs), correct / total)
    dt = time.perf_counter() - t0
    acc = correct / max(total, 1)
    aligns = total * bank.feats.shape[0]
    print(f"accuracy: {acc:.4f} ({total} clips, {len(labels)} classes)")
    print(f"throughput: {aligns / dt:,.0f} alignments/s")
    metrics.record(accuracy=acc, n=total, classes=len(labels),
                   templates=int(bank.feats.shape[0]),
                   alignments_per_sec=aligns / dt, devices=n_dev)
    if args.metrics_out:
        metrics.dump(args.metrics_out)


def cmd_plot(args):
    """Render the pipeline view of one WAV (or synthetic word) to PNG."""
    from dsp_asr.viz import plot_pipeline
    cfg = _pipeline_cfg(args)
    if args.wav:
        from dsp_asr.io.wav import read_wav
        _, x = read_wav(args.wav, cfg.frontend.sample_rate)
        title = args.wav
    else:
        from dsp_asr.io.dataset import synth_word
        x = synth_word(args.word, 0, max_samples=cfg.max_samples)
        title = f"synthetic '{args.word}'"
    rec = None
    if args.bank:
        from dsp_asr.models.knn_dtw import KnnDtwRecognizer
        rec = KnnDtwRecognizer.load(args.bank, cfg)
    plot_pipeline(x, args.out, cfg, rec, title)
    log.info("wrote %s", args.out)


def cmd_demo(args):
    """Streaming demo: a WAV (or synthetic stream) fed chunk by chunk."""
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.streaming import StreamingRecognizer
    cfg = _pipeline_cfg(args)
    period = cfg.frontend.hop_len / cfg.frontend.sample_rate
    rec = KnnDtwRecognizer.load(args.bank, cfg)
    stream = StreamingRecognizer(rec, chunk_len=args.chunk)

    if args.wav:
        from dsp_asr.io.wav import read_wav
        _, sig = read_wav(args.wav, cfg.frontend.sample_rate)
    elif args.mic:
        _demo_mic(stream, args)
        return
    else:
        sig = _synth_stream(rec.labels)
    n = len(sig) // args.chunk
    for c in range(n):
        for lab, s, e in stream.feed(sig[c * args.chunk:(c + 1) * args.chunk]):
            t0, t1 = s * period, e * period
            print(f"[{t0:7.2f}s - {t1:7.2f}s] {lab}")
    for lab, s, e in stream.flush():
        print(f"[{s * period:7.2f}s - {e * period:7.2f}s] {lab} (flush)")


def _synth_stream(labels, n_words: int = 5, seed: int = 7):
    from dsp_asr.io.dataset import synth_word
    rng = np.random.default_rng(seed)
    sig = 0.002 * rng.standard_normal(16000 * (3 * n_words + 1))
    pos = 8000
    spoken = []
    for i in range(n_words):
        lab = labels[rng.integers(len(labels))]
        w = synth_word(lab, 500 + i, max_samples=24000)
        end = min(pos + len(w), len(sig))
        sig[pos:end] += w[: end - pos]
        spoken.append(lab)
        pos = end + int(rng.integers(12000, 20000))
        if pos + 8000 >= len(sig):
            break
    log.info("synthetic stream says: %s", " ".join(spoken))
    return sig.astype(np.float32)


def _demo_mic(stream, args):
    period = (stream.cfg.frontend.hop_len
              / stream.cfg.frontend.sample_rate)
    try:
        import pyaudio  # noqa: F401  (not in this image; gated like the ref's recorder)
    except ImportError:
        raise SystemExit(
            "PyAudio is not installed in this environment; microphone "
            "capture is gated. Use --wav FILE or the synthetic stream.")
    # (reference-parity mic loop; executed only where pyaudio exists)
    pa = pyaudio.PyAudio()
    sr = stream.cfg.frontend.sample_rate
    h = pa.open(format=pyaudio.paInt16, channels=1, rate=sr, input=True,
                frames_per_buffer=args.chunk)
    print("listening (ctrl-c to stop)...")
    try:
        while True:
            raw = h.read(args.chunk)
            x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            for lab, s, e in stream.feed(x):
                print(f"[{s * period:7.2f}s - {e * period:7.2f}s] {lab}")
    except KeyboardInterrupt:
        pass
    finally:
        h.close()
        pa.terminate()


def _add_noise_adapt(p):
    p.add_argument("--noise-adapt", action="store_true", dest="noise_adapt",
                   help="GMM-HMM only: estimate the test noise floor from "
                        "VAD-rejected frames and log-add-PMC the Gaussian "
                        "means before scoring (the automatic form of the "
                        "--train-noise refit remedy; ops/noise_adapt.py)")


def _add_connected_method(p):
    p.add_argument("--connected-method", choices=("vad", "level"),
                   default="vad", dest="connected_method",
                   help="connected decoder: 'vad' = silence-gap splitter "
                        "(default); 'level' = joint frame-synchronous DP "
                        "— handles GAPLESS/coarticulated speech (template "
                        "level building for --bank, connected Viterbi "
                        "for --hmm)")
    p.add_argument("--grammar", metavar="JSON",
                   help="finite-state word-grammar spec file constraining "
                        "the connected decode (method 'level' only): "
                        "allowed start/end words and word pairs — "
                        "ops/grammar.py docstring for the format")
    p.add_argument("--word-penalty", type=float, default=0.0,
                   help="level-building per-word cost bias (0 = pure "
                        "distance; raise to discourage over-segmentation)")


def _add_reject(p):
    p.add_argument("--reject", action="store_true",
                   help="utterance verification: queries whose best bank "
                        "distance fails the rejection threshold come "
                        "back '<reject>' instead of the nearest enrolled "
                        "word (OOV/garbage input).  Uses the per-bank "
                        "threshold enroll calibrated and stored; "
                        "override with --reject-threshold")
    p.add_argument("--reject-threshold", type=float, default=None,
                   metavar="D",
                   help="explicit rejection threshold in the matcher's "
                        "score units (implies --reject)")


def _reject_arg(args):
    """argparse flags -> classify_batch's reject parameter."""
    thr = getattr(args, "reject_threshold", None)
    if thr is not None:
        return thr
    return True if getattr(args, "reject", False) else None


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dsp_asr", description=__doc__)
    ap.add_argument("--platform", choices=("auto", "cpu", "gpu"),
                    default="auto",
                    help="force the jax backend before first use "
                         "(auto = jax's own choice: the GPU when one is "
                         "present)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("make-corpus", help="write a synthetic WAV corpus")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=5, help="utterances per word/split")
    p.add_argument("--words", type=int, default=None,
                   help="vocabulary size (default: 10 digits; the full "
                        "35-class confusable vocabulary with --hostile)")
    p.add_argument("--connected", type=int, default=0, metavar="N",
                   help="also write N connected multi-word recordings + "
                        "labels.tsv manifest (for evaluate-connected)")
    p.add_argument("--gapless", action="store_true",
                   help="butt the connected words together with NO "
                        "silence gaps (decode with --connected-method "
                        "level; the VAD splitter cannot segment these)")
    p.add_argument("--spotting", type=int, default=0, metavar="N",
                   help="also write N continuous keyword-spotting "
                        "streams (keywords + out-of-vocabulary "
                        "distractor words, short gaps) + events.tsv "
                        "ground truth (for evaluate-spot)")
    p.add_argument("--hostile", action="store_true",
                   help="adversarial corpus: 35 confusable classes, "
                        "held-out test speakers (io/hostile.py)")
    p.add_argument("--condition", default="clean",
                   help="test-split degradation (hostile only): clean | "
                        "snr20|snr10|snr5|snr0 | tilt | reverb | 'a+b'")
    p.set_defaults(fn=cmd_make_corpus)

    p = sub.add_parser("enroll", help="build a template bank from a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--bank", required=True)
    p.add_argument("--no-spot-calibration", action="store_true",
                   help="skip the per-bank spotting-threshold "
                        "calibration normally stored in the bank "
                        "(a K x K subsequence-DTW scan at enroll time)")
    p.add_argument("--no-reject-calibration", action="store_true",
                   help="skip the per-bank OOV-rejection-threshold "
                        "calibration normally stored in the bank "
                        "(a K x K classification DTW at enroll time; "
                        "recognize --reject uses the stored value)")
    _add_common(p)
    p.set_defaults(fn=cmd_enroll)

    p = sub.add_parser("recognize", help="classify WAV files")
    p.add_argument("--bank", required=True)
    p.add_argument("--connected", action="store_true",
                   help="treat each WAV as a recording of SEVERAL words: "
                        "the multi-segment VAD splits it and every "
                        "segment is classified (prints space-joined "
                        "labels per file)")
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment capacity per recording (--connected)")
    p.add_argument("--nbest", type=int, default=1, metavar="N",
                   help="> 1: print the top-N hypotheses per file as "
                        "label:distance:weight triplets (weight = "
                        "relative confidence, pipeline.nbest_from_scores)")
    _add_reject(p)
    _add_connected_method(p)
    p.add_argument("wavs", nargs="+")
    _add_common(p)
    p.set_defaults(fn=cmd_recognize)

    p = sub.add_parser("evaluate", help="accuracy of a bank on a corpus")
    p.add_argument("--corpus", required=True)
    p.add_argument("--bank", required=True)
    _add_reject(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("evaluate-connected",
                       help="WER of any family on connected recordings")
    p.add_argument("--corpus", required=True,
                   help="dir with labels.tsv + WAVs (make-corpus --connected)")
    p.add_argument("--bank", help="kNN-DTW template bank checkpoint")
    p.add_argument("--hmm", help="GMM-HMM model checkpoint")
    p.add_argument("--vq", help="VQ codebook checkpoint")
    p.add_argument("--max-segments", type=int, default=8)
    _add_connected_method(p)
    _add_noise_adapt(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_connected)

    p = sub.add_parser("spot", help="keyword search in unsegmented WAVs")
    p.add_argument("--bank",
                   help="template bank of the KEYWORDS to spot "
                        "(subsequence-DTW spotter)")
    p.add_argument("--hmm",
                   help="GMM-HMM checkpoint: open-endpoint Viterbi vs "
                        "the stored UBM filler (per-frame LLR scores, "
                        "default threshold 0; offline only).  With "
                        "--bank AS WELL this becomes the CASCADE "
                        "spotter: HMM landmarks propose candidate "
                        "windows, exact subsequence DTW against the "
                        "bank relabels/re-spans them (full-word spans, "
                        "DTW score units)")
    p.add_argument("--hmm-threshold", type=float, default=None,
                   help="cascade only: stage-1 candidate LLR floor "
                        "(default -45, permissive — stage 2 restores "
                        "precision)")
    p.add_argument("--threshold", type=float, default=None,
                   help="span-normalised DTW score below which a match "
                        "is an event (same units as classify "
                        "distances).  Default 40 measured P=R=F1=1.0 "
                        "at EVERY noise level of the spotting matrix "
                        "(scripts/spot_eval.py, docs/RESULTS.md: "
                        "additive noise raises the score floor, so "
                        "lower thresholds lose recall in noise while "
                        ">=50 starts passing distractor fragments); "
                        "calibrate per deployment with evaluate-spot")
    p.add_argument("--stream", action="store_true",
                   help="online decode (events confirmed chunk-by-"
                        "chunk) instead of the offline batch: SPRING "
                        "DP with --bank, the keyword/filler column "
                        "update with --hmm, the bounded-lag streaming "
                        "cascade with both")
    p.add_argument("--calibrate-threshold", action="store_true",
                   help="DTW spotter only: derive the threshold from "
                        "the bank itself (genuine/impostor score "
                        "midpoint — vocabulary-robust where the fixed "
                        "40 decays; docs/RESULTS.md)")
    p.add_argument("wavs", nargs="+")
    _add_common(p)
    p.set_defaults(fn=cmd_spot)

    p = sub.add_parser("evaluate-spot",
                       help="precision/recall/F1 of keyword spotting")
    p.add_argument("--corpus", required=True,
                   help="dir with events.tsv + WAVs (make-corpus "
                        "--spotting)")
    p.add_argument("--bank", help="DTW spotter (50%%-overlap hit rule)")
    p.add_argument("--hmm", help="HMM spotter (midpoint hit rule); "
                                 "with --bank as well: cascade spotter "
                                 "(50%%-overlap rule — full-word spans)")
    p.add_argument("--hmm-threshold", type=float, default=None,
                   help="cascade stage-1 candidate LLR floor")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--calibrate-threshold", action="store_true",
                   help="DTW spotter only: per-bank threshold (see "
                        "`spot --calibrate-threshold`)")
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_spot)

    p = sub.add_parser("serve",
                       help="resident recognition loop (stdin WAV paths "
                            "-> stdout label lines)")
    p.add_argument("--bank", required=True)
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment capacity for 'connected <path>' lines")
    p.add_argument("--grammar", metavar="JSON",
                   help="word-grammar spec applied to 'level <path>' "
                        "requests (ops/grammar.py docstring format)")
    p.add_argument("--nbest", type=int, default=3,
                   help="hypothesis count for 'nbest <path>' lines")
    p.add_argument("--spot-threshold", type=float, default=None,
                   help="detection threshold for 'spot <path>' lines; "
                        "default = the bank's stored calibration, else "
                        "40 (see `spot --threshold`)")
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("train-hmm", help="train per-word GMM-HMMs")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--states", type=int, default=5)
    p.add_argument("--mix", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--map-tau", type=float, default=0.0,
                   help="> 0: MAP-adapt word HMMs from a universal "
                        "background GMM (few-shot regulariser)")
    p.add_argument("--train-mode", choices=["viterbi", "baum_welch"],
                   default="viterbi")
    p.add_argument("--no-reject-calibration", action="store_true",
                   help="skip the OOV-rejection LLR calibration on the "
                        "training corpus normally stored in the model")
    _add_common(p)
    p.set_defaults(fn=cmd_train_hmm)

    p = sub.add_parser("evaluate-hmm", help="accuracy of a GMM-HMM model")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--states", type=int, default=5)
    p.add_argument("--mix", type=int, default=3)
    p.add_argument("--iters", type=int, default=10)
    _add_noise_adapt(p)
    _add_reject(p)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_hmm)

    p = sub.add_parser("train-vq", help="train per-word VQ codebooks")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--codes", type=int, default=64, help="codebook size")
    p.add_argument("--iters", type=int, default=10, help="k-means iters")
    _add_common(p)
    p.set_defaults(fn=cmd_train_vq)

    p = sub.add_parser("evaluate-vq", help="accuracy of a VQ model")
    p.add_argument("--corpus", required=True)
    p.add_argument("--model", required=True)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_vq)

    p = sub.add_parser("bench", help="run the headline throughput benchmark")
    p.set_defaults(fn=lambda a: __import__("bench").main())

    p = sub.add_parser(
        "warm", help="pre-compile serving programs into the persistent "
                     "XLA cache (run once per deployment)")
    p.add_argument("--bank", default=None,
                   help="existing bank .npz (its size/matcher/k define the "
                        "programs); omit to use a synthetic bank")
    p.add_argument("--bank-size", type=int, default=100,
                   help="synthetic bank templates when no --bank")
    p.add_argument("--batches", default="1,256",
                   help="comma-separated query batch sizes to compile "
                        "(classify_batch chunks at 256)")
    p.add_argument("--connected", default="", metavar="M1,M2",
                   help="also compile the connected decoders (VAD split + "
                        "level building; + the grammar DP with --grammar) "
                        "at these recording-length multiples of "
                        "max_samples — the programs serve's 'connected '/"
                        "'level ' prefixes dispatch")
    p.add_argument("--max-segments", type=int, default=8,
                   help="segment/level capacity for --connected warming "
                        "(must match serving)")
    p.add_argument("--grammar", metavar="JSON",
                   help="grammar spec to warm the constrained DP with "
                        "(--connected only)")
    _add_common(p)
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser("evaluate-sc2",
                       help="Speech Commands v2 kNN-DTW eval (local dataset)")
    p.add_argument("--root", required=True,
                   help="extracted speech_commands_v2 directory")
    p.add_argument("--split", choices=["test", "validation"], default="test")
    p.add_argument("--templates", type=int, default=10,
                   help="templates enrolled per word")
    p.add_argument("--limit", type=int, default=None,
                   help="cap test clips per word")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--no-mesh", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate_sc2)

    p = sub.add_parser("plot", help="render pipeline internals to PNG")
    p.add_argument("--wav", default=None)
    p.add_argument("--word", default="three", help="synthetic word if no --wav")
    p.add_argument("--bank", default=None, help="optional bank for distances")
    p.add_argument("--out", default="pipeline.png")
    _add_common(p)
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser("demo", help="streaming recognition demo")
    p.add_argument("--bank", required=True)
    p.add_argument("--wav", default=None)
    p.add_argument("--mic", action="store_true")
    p.add_argument("--chunk", type=int, default=1600)
    _add_common(p)
    p.set_defaults(fn=cmd_demo)

    args = ap.parse_args(argv)
    if args.platform != "auto":
        # must land before any backend init
        import jax
        jax.config.update("jax_platforms", args.platform)
    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
