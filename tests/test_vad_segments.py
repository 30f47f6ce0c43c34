"""Multi-segment VAD (connected words): golden/JAX parity + e2e.

The reference's endpoint detector both trims and *splits* utterances
(SURVEY.md §1a L1).  These tests pin the JAX splitter
(ops/vad.py:detect_segments) frame-for-frame to the golden loop spec
(golden/vad.py:detect_segments) and drive the connected-word
classification path end to end.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dsp_asr.config import FrontendConfig, PipelineConfig, VadConfig
from dsp_asr.golden import vad as gvad
from dsp_asr.io.dataset import DIGITS, make_corpus, synth_connected, synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.ops import vad as jvad

FCFG = FrontendConfig()
VCFG = VadConfig()
SR = 16000


def _jax_segments(x, max_segments=8, length=None):
    s, e, n = jvad.detect_segments(
        jnp.asarray(x), FCFG, VCFG,
        None if length is None else jnp.asarray(length),
        max_segments)
    return [(int(s[i]), int(e[i])) for i in range(int(n))]


def _tone_silence_signal(blocks, noise=0.002, seed=0):
    """[(kind, ms)] with kind in {'tone','sil'} -> float32 signal."""
    rng = np.random.default_rng(seed)
    pieces = []
    for kind, ms in blocks:
        n = int(ms / 1000.0 * SR)
        t = np.arange(n) / SR
        pieces.append(0.5 * np.sin(2 * np.pi * 440.0 * t)
                      if kind == "tone" else np.zeros(n))
    x = np.concatenate(pieces)
    return (x + noise * rng.standard_normal(len(x))).astype(np.float32)


class TestGoldenParity:
    def test_random_connected_clips(self):
        rng = np.random.default_rng(42)
        for trial in range(12):
            labs = [DIGITS[int(rng.integers(10))]
                    for _ in range(int(rng.integers(1, 5)))]
            x = synth_connected(labs, trial)
            want = gvad.detect_segments(x, FCFG, VCFG)
            assert _jax_segments(x) == want[:8], f"trial {trial}"

    def test_tone_block_patterns(self):
        for blocks in [
            [("sil", 200), ("tone", 300), ("sil", 400), ("tone", 250),
             ("sil", 300)],
            [("sil", 150), ("tone", 120), ("sil", 80), ("tone", 120),
             ("sil", 200)],                    # short gap: should merge
            [("sil", 120), ("tone", 1200), ("sil", 120)],
            [("tone", 400), ("sil", 500), ("tone", 60), ("sil", 400)],
        ]:
            x = _tone_silence_signal(blocks)
            want = gvad.detect_segments(x, FCFG, VCFG)
            assert _jax_segments(x) == want[:8], blocks

    def test_all_silence_yields_no_segments(self):
        x = (0.001 * np.random.default_rng(0)
             .standard_normal(SR)).astype(np.float32)
        assert gvad.detect_segments(x, FCFG, VCFG) == []
        assert _jax_segments(x) == []


class TestExhaustive:
    def test_all_small_frame_patterns(self):
        """EVERY silent/audible-only/high pattern over 8 frames (3^8 =
        6561), with tight thresholds so core runs, audible extension,
        gap merging, hangover and the min-utterance drop all trigger
        within the window: the vmapped JAX splitter must equal the
        golden loop spec case-for-case (the same exhaustive-enumeration
        style that pins the Itakura recurrence)."""
        import jax
        import jax.numpy as jnp

        vcfg = VadConfig(n_init=2, min_speech_frames=2,
                         max_silence_frames=3, hangover_frames=1,
                         min_utterance_frames=2)
        t = 8
        levels = np.array([0.5, 2.0, 8.0])   # vs th=4.0, tl=1.5 (noise=1)
        pats = np.stack(np.meshgrid(*([np.arange(3)] * t),
                                    indexing="ij"), -1).reshape(-1, t)
        e_all = np.concatenate(
            [np.full((len(pats), vcfg.n_init), 1.0), levels[pats]],
            axis=1).astype(np.float64)
        z_all = np.zeros_like(e_all)

        fn = jax.jit(jax.vmap(
            lambda e, z: jvad.detect_segments_frames(e, z, None, vcfg, 4)))
        s, en, ns = map(np.asarray, fn(jnp.asarray(e_all),
                                       jnp.asarray(z_all)))
        for i in range(len(pats)):
            want = gvad.detect_segments_frames(e_all[i], z_all[i], vcfg)
            got = [(int(s[i, j]), int(en[i, j])) for j in range(ns[i])]
            assert got == want[:4], (i, pats[i].tolist(), got, want)


class TestSpecProperties:
    def test_short_gap_merges_long_gap_splits(self):
        hop_ms = 1000.0 * FCFG.hop_len / SR
        short = (VCFG.max_silence_frames - 6) * hop_ms
        long = (VCFG.max_silence_frames + 15) * hop_ms
        merged = _jax_segments(_tone_silence_signal(
            [("sil", 200), ("tone", 300), ("sil", short), ("tone", 300),
             ("sil", 300)]))
        split = _jax_segments(_tone_silence_signal(
            [("sil", 200), ("tone", 300), ("sil", long), ("tone", 300),
             ("sil", 300)]))
        assert len(merged) == 1
        assert len(split) == 2

    def test_padding_invariance(self):
        x = synth_connected(["two", "eight"], 3)
        plain = _jax_segments(x)
        padded = np.concatenate([x, np.zeros(24000, np.float32)])
        assert _jax_segments(padded, length=len(x)) == plain

    def test_max_segments_truncates_in_time_order(self):
        labs = ["one", "two", "three", "four", "five"]
        x = synth_connected(labs, 9)
        full = _jax_segments(x, max_segments=8)
        first3 = _jax_segments(x, max_segments=3)
        assert len(full) == 5
        assert first3 == full[:3]

    def test_single_word_yields_one_segment(self):
        for seed in range(4):
            x = synth_word("five", seed)
            segs = _jax_segments(x)
            assert len(segs) == 1


class TestConnectedRecognition:
    @pytest.fixture(scope="class")
    def recognizer(self):
        rec = KnnDtwRecognizer(PipelineConfig(), k=1)
        for lab, xs in make_corpus(n_per_word=2, seed=0).items():
            rec.enroll(lab, xs)
        return rec

    def test_connected_labels(self, recognizer):
        clips = [synth_connected(["three", "seven", "zero"], 5),
                 synth_connected(["one"], 6),
                 synth_connected(["nine", "four"], 7)]
        got = recognizer.classify_connected(clips)
        assert got == [["three", "seven", "zero"], ["one"],
                       ["nine", "four"]]

    def test_single_word_matches_isolated_path(self, recognizer):
        clip = synth_connected(["six"], 8)
        iso = recognizer.recognize(clip)
        conn = recognizer.classify_connected([clip])
        assert conn == [[iso]]

    def test_hmm_and_vq_families_decode_connected(self):
        from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
        from dsp_asr.models.vq import VqRecognizer

        corpus = make_corpus(n_per_word=3, seed=0)
        clips = [synth_connected(["three", "seven", "zero"], 5),
                 synth_connected(["one"], 6)]
        want = [["three", "seven", "zero"], ["one"]]
        vq = VqRecognizer(PipelineConfig())
        vq.fit(corpus)
        assert vq.classify_connected(clips) == want
        hmm = GmmHmmRecognizer(PipelineConfig())
        hmm.fit(corpus)
        assert hmm.classify_connected(clips) == want

    def test_streaming_agrees_with_offline_splitter(self, recognizer):
        """The causal streaming detector and the offline splitter are
        different algorithms (running threshold state machine vs global
        run-length masks) but must emit the same label sequence on clean
        well-separated connected speech."""
        from dsp_asr.models.streaming import StreamingRecognizer

        for seed in (21, 22):
            labs_truth = ["five", "two", "eight"]
            clip = synth_connected(labs_truth, seed)
            offline = recognizer.classify_connected([clip])[0]

            sr = StreamingRecognizer(recognizer, chunk_len=1600)
            events = []
            n = (len(clip) // 1600) * 1600
            for lo in range(0, n, 1600):
                events.extend(sr.feed(clip[lo:lo + 1600]))
            events.extend(sr.flush())
            assert [e[0] for e in events] == offline == labs_truth

    def test_chunked_connected_matches_unchunked(self, recognizer):
        """Recording-level chunking (max ~256 flat segments per device
        program) must not change labels: chunk boundaries only repeat
        padding rows that are trimmed on the way out."""
        clips = [synth_connected([DIGITS[i % 10]], 40 + i)
                 for i in range(9)]
        unchunked = recognizer.classify_connected(clips, max_segments=8)
        chunked = recognizer.classify_connected(clips, max_segments=32)
        assert [c[0] for c in chunked] == [u[0] for u in unchunked]
        out, starts, ends, n_segs = recognizer.classify_connected(
            clips, max_segments=32, return_segments=True)
        assert starts.shape == (9, 32) and len(out) == 9
        assert (n_segs == 1).all()

    def test_fast_matchers_route_through_connected(self, recognizer):
        """classify_connected honors the recognizer's matcher setting
        (ltw / cascade) exactly like classify_batch."""
        clips = [synth_connected(["three", "seven"], 5),
                 synth_connected(["one"], 6)]
        want = recognizer.classify_connected(clips)
        old = recognizer.matcher
        try:
            for matcher in ("ltw", "cascade"):
                recognizer.matcher = matcher
                assert recognizer.classify_connected(clips) == want, matcher
        finally:
            recognizer.matcher = old

    def test_mesh_rejects_fast_matchers(self, recognizer):
        """A mesh only implements the full banded DTW; silently ignoring
        a configured ltw/cascade matcher (as it used to) diverges from
        the meshless recognizer — it must raise instead."""
        from dsp_asr import parallel as par

        recognizer.mesh = par.make_mesh(4, 2)
        recognizer.matcher = "ltw"
        try:
            with pytest.raises(ValueError):
                recognizer.classify_batch([synth_connected(["one"], 6)])
            with pytest.raises(ValueError):
                recognizer.classify_connected([synth_connected(["one"], 6)])
        finally:
            recognizer.mesh = None
            recognizer.matcher = "dtw"

    def test_mesh_connected_matches_single_device(self, recognizer):
        """Bank-sharded connected decoding must match the single-device
        path label-for-label (same flat segment features, classify via
        parallel.classify_sharded)."""
        from dsp_asr import parallel as par

        clips = [synth_connected(["three", "seven", "zero"], 5),
                 synth_connected(["one"], 6),
                 synth_connected(["nine", "four"], 7)]
        want = recognizer.classify_connected(clips)
        recognizer.mesh = par.make_mesh(4, 2)
        try:
            got = recognizer.classify_connected(clips)
        finally:
            recognizer.mesh = None
        assert got == want

    def test_return_segments_shapes(self, recognizer):
        clips = [synth_connected(["two", "five"], 11)]
        out, starts, ends, n_segs = recognizer.classify_connected(
            clips, max_segments=4, return_segments=True)
        assert out == [["two", "five"]]
        assert starts.shape == (1, 4) and ends.shape == (1, 4)
        assert int(n_segs[0]) == 2
        assert int(ends[0, 0]) <= int(starts[0, 1])
