"""Native C++ batch WAV loader vs the pure-Python loader (exact parity)."""

import os

import numpy as np
import pytest

from dsp_asr.io import native
from dsp_asr.io.dataset import synth_word
from dsp_asr.io.wav import read_wav, write_wav

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, lab in enumerate(["one", "two", "three"]):
        x = synth_word(lab, i, max_samples=24000)
        p = str(d / f"{lab}.wav")
        write_wav(p, 16000, x)
        paths.append(p)
    return paths


def test_single_decode_matches_python(wav_dir):
    for p in wav_dir:
        sr, want = read_wav(p)
        got, n = native.read_wav_native(p, target_sr=16000, max_samples=32000)
        assert n == len(want)
        np.testing.assert_allclose(got[:n], want, atol=1e-7)
        assert (got[n:] == 0).all()


def test_batch_decode_threaded(wav_dir):
    out, lens, failures = native.read_wav_batch(wav_dir, 16000, 32000,
                                                n_threads=3)
    assert failures == 0
    for i, p in enumerate(wav_dir):
        _, want = read_wav(p)
        assert lens[i] == len(want)
        np.testing.assert_allclose(out[i, : lens[i]], want, atol=1e-7)


def test_resample_matches_python(tmp_path):
    x = synth_word("five", 9, max_samples=16000)
    p = str(tmp_path / "f.wav")
    write_wav(p, 16000, x)
    sr, want = read_wav(p, target_sr=8000)
    got, n = native.read_wav_native(p, target_sr=8000, max_samples=16000)
    assert n == len(want)
    np.testing.assert_allclose(got[:n], want, atol=1e-5)


def test_bad_file_reports_failure(tmp_path, wav_dir):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    out, lens, failures = native.read_wav_batch([wav_dir[0], bad], 16000, 32000)
    assert failures == 1
    assert lens[0] > 0 and lens[1] == 0


def test_corpus_dir_native(tmp_path):
    for lab in ["a", "b"]:
        os.makedirs(tmp_path / lab)
        for i in range(2):
            write_wav(str(tmp_path / lab / f"{i}.wav"), 16000,
                      synth_word(lab, i, max_samples=16000))
    corpus = native.load_corpus_dir_native(str(tmp_path), 16000, 32000)
    assert sorted(corpus) == ["a", "b"]
    assert all(len(v) == 2 for v in corpus.values())
