"""Hostile benchmark corpus (dsp_asr/io/hostile.py; round-2 verdict:
break the accuracy circularity of the designed-separable default corpus)."""

import numpy as np

from dsp_asr.config import PipelineConfig
from dsp_asr.io.hostile import (CONDITIONS, hostile_vocab,
                                make_hostile_corpus, speaker_params,
                                synth_hostile)
from dsp_asr.models.knn_dtw import KnnDtwRecognizer


def test_vocab_is_35_unique_minimal_pairs():
    v = hostile_vocab()
    assert len(v) == 35
    assert len(set(v)) == 35
    bases = {lab[1] for lab in v}
    assert len(bases) == 7


def test_synthesis_deterministic():
    a = synth_hostile("w31", speaker=2, seed=7, condition="snr10")
    b = synth_hostile("w31", speaker=2, seed=7, condition="snr10")
    np.testing.assert_array_equal(a, b)
    c = synth_hostile("w31", speaker=2, seed=8, condition="snr10")
    assert not np.array_equal(a, c)


def test_conditions_degrade_the_same_clean_utterance():
    """The condition must be EXCLUDED from the clean waveform's seed so a
    condition sweep is a controlled comparison (regression: an early
    version drew different utterances per condition and snr10 scored
    ABOVE clean)."""
    clean = synth_hostile("w05", speaker=1, seed=3, condition="clean")
    noisy = synth_hostile("w05", speaker=1, seed=3, condition="snr20")
    # same underlying speech -> strong sample correlation despite noise
    corr = np.corrcoef(clean, noisy)[0, 1]
    assert corr > 0.9, corr
    assert not np.array_equal(clean, noisy)


def test_all_conditions_synthesize():
    for cond in CONDITIONS:
        x = synth_hostile("w12", speaker=0, seed=1, condition=cond)
        assert x.shape == (32000,)
        assert np.all(np.isfinite(x))


def test_speakers_are_distinct_and_deterministic():
    ps = [speaker_params(s) for s in range(6)]
    assert len({p[0] for p in ps}) == 6
    assert speaker_params(3) == speaker_params(3)


def test_held_out_speaker_above_chance_below_perfect():
    """10-class subset: defaults must beat chance comfortably on clean
    held-out speakers, while the full 35-class matrix shows headroom
    (docs/RESULTS.md) — this bound is deliberately loose, the corpus is
    built to be HARD."""
    vocab = hostile_vocab()[:10]     # bases 0-1, all 5 variants each
    rec = KnnDtwRecognizer(PipelineConfig())
    train = make_hostile_corpus(vocab, speakers=(0, 1), n_per=1)
    for lab, xs in train.items():
        rec.enroll(lab, xs)
    test = make_hostile_corpus(vocab, speakers=(4,), n_per=1, seed=9)
    acc = rec.evaluate(test)["accuracy"]
    assert acc > 0.35, acc           # chance = 0.1


def test_cli_make_corpus_hostile(tmp_path):
    import subprocess
    import sys

    out = tmp_path / "hc"
    r = subprocess.run(
        [sys.executable, "-m", "dsp_asr", "make-corpus", "--out", str(out),
         "--hostile", "--words", "5", "--n", "1", "--condition", "snr10"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import os
    train_labels = sorted(os.listdir(out / "train"))
    assert train_labels == ["w00", "w01", "w02", "w03", "w04"]
    # train: 3 speakers x 1 rep; test: 2 held-out speakers x 1 rep
    assert len(os.listdir(out / "train" / "w00")) == 3
    assert len(os.listdir(out / "test" / "w00")) == 2
