"""Robustness depth (round-1 review item 9).

 * fuzz the native C++ RIFF parser with malformed inputs — truncated
   chunks, zero channels, odd bit depths, random bytes — asserting clean
   error codes, never crashes or garbage-accepts;
 * assert accuracy floors at fixed SNRs on the synthetic corpus
   (promotes scripts/robustness.py's sweep into CI).
"""

import os
import struct

import numpy as np
import pytest

from dsp_asr.config import PipelineConfig
from dsp_asr.io import native
from dsp_asr.io.dataset import DIGITS, make_corpus
from dsp_asr.models.knn_dtw import KnnDtwRecognizer

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native wavio unavailable")


def _wav_bytes(n=64, sr=16000, channels=1, bits=16, fmt=1, data=None,
               riff_size=None, data_size=None):
    if data is None:
        data = struct.pack(f"<{n}h", *([100] * n))
    fmt_body = struct.pack("<HHIIHH", fmt, channels, sr,
                           sr * channels * bits // 8,
                           channels * bits // 8, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    chunks += b"data" + struct.pack(
        "<I", len(data) if data_size is None else data_size) + data
    riff = len(chunks) + 4 if riff_size is None else riff_size
    return b"RIFF" + struct.pack("<I", riff) + b"WAVE" + chunks


def _decode(tmp_path, blob, name="f.wav"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return native.read_wav_native(p)


@needs_native
def test_wellformed_roundtrip(tmp_path):
    x, n = _decode(tmp_path, _wav_bytes())
    assert n == 64
    np.testing.assert_allclose(x[:n], 100 / 32768.0, atol=1e-6)


@needs_native
@pytest.mark.parametrize("blob,tag", [
    (b"", "empty"),
    (b"RIFF", "truncated header"),
    (b"RIFX" + b"\x00" * 40, "wrong magic"),
    (b"RIFF\x24\x00\x00\x00WAVE", "no chunks"),
    (_wav_bytes(channels=0), "zero channels"),
    (_wav_bytes(bits=24), "24-bit unsupported"),
    (_wav_bytes(bits=0), "zero bits"),
    (_wav_bytes(fmt=85), "mp3-in-wav fmt tag"),
    (_wav_bytes(sr=0), "zero sample rate"),
    (_wav_bytes()[:30], "truncated mid-fmt"),
], ids=lambda v: v if isinstance(v, str) else "blob")
def test_malformed_wavs_fail_cleanly(tmp_path, blob, tag):
    with pytest.raises(IOError):
        _decode(tmp_path, blob)


@needs_native
def test_data_size_lie_truncates_not_overreads(tmp_path):
    """A data chunk claiming more bytes than the file has must clamp."""
    blob = _wav_bytes(n=32, data_size=4096)
    x, n = _decode(tmp_path, blob)
    assert 0 < n <= 32


@needs_native
def test_random_byte_fuzz_never_crashes(tmp_path):
    rng = np.random.default_rng(0)
    ok = bad = 0
    for i in range(200):
        size = int(rng.integers(0, 400))
        blob = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
        if i % 3 == 0 and size >= 12:
            blob = b"RIFF" + blob[4:8] + b"WAVE" + blob[12:]  # valid magic
        try:
            _decode(tmp_path, blob, name=f"fz{i}.wav")
            ok += 1
        except IOError:
            bad += 1
    assert ok + bad == 200      # no crash, every case returned


@needs_native
def test_batch_decode_reports_failures_and_survives(tmp_path):
    good = str(tmp_path / "good.wav")
    with open(good, "wb") as f:
        f.write(_wav_bytes())
    evil = str(tmp_path / "evil.wav")
    with open(evil, "wb") as f:
        f.write(_wav_bytes(channels=0))
    out, lens, failures = native.read_wav_batch(
        [good, evil, good], target_sr=16000, max_samples=128)
    assert failures == 1
    assert lens[0] == 64 and lens[2] == 64 and lens[1] == 0


def _accuracy_at_snr(rec, test_corpus, snr_db, rng):
    def noisy(x):
        p = float(np.mean(np.square(x)))
        pn = p / (10.0 ** (snr_db / 10.0))
        return (x + rng.standard_normal(len(x)) * np.sqrt(pn)).astype(np.float32)

    corpus = {lab: [noisy(x) for x in xs] for lab, xs in test_corpus.items()}
    return rec.evaluate(corpus)["accuracy"]


def test_accuracy_floors_under_noise():
    """Asserted SNR floors on the synthetic corpus (scripts/robustness.py
    measured 1.00/1.00/0.98 at 30/20/10 dB in round 1)."""
    train = make_corpus(DIGITS[:5], n_per_word=3, seed=0)
    test = make_corpus(DIGITS[:5], n_per_word=2, seed=9000)
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab, sigs in train.items():
        rec.enroll(lab, sigs)
    rng = np.random.default_rng(1)
    # the 15% band costs ~one utterance at 20 dB vs unbanded (noise
    # shifts VAD boundaries -> length mismatch clips a true warp)
    assert _accuracy_at_snr(rec, test, 30, rng) >= 0.95
    assert _accuracy_at_snr(rec, test, 20, rng) >= 0.85
    assert _accuracy_at_snr(rec, test, 10, rng) >= 0.80
