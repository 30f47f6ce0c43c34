"""Streaming front-end tests: streaming == offline MFCC (exact grid parity),
causal VAD sanity, end-to-end streaming recognition (SURVEY.md §4.6)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsp_asr.config import FrontendConfig, PipelineConfig, VadConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word
from dsp_asr.models.knn_dtw import KnnDtwRecognizer
from dsp_asr.models.streaming import StreamingRecognizer
from dsp_asr.ops import frontend as fe
from dsp_asr.ops import streaming as st

FCFG = FrontendConfig()
VCFG = VadConfig()
CHUNK = 1600


def _stream_all(x, chunk=CHUNK):
    mats = fe.make_matrices(FCFG)
    state = st.init_state(FCFG, chunk)
    outs = []
    for c in range(len(x) // chunk):
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * chunk:(c + 1) * chunk]), mats,
            FCFG, VCFG, chunk)
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("chunk", [1600, 3200])
def test_streaming_mfcc_equals_offline(chunk):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(16000).astype(np.float32)
    mats = fe.make_matrices(FCFG)
    want = np.asarray(fe.mfcc(jnp.asarray(x), FCFG, mats))

    state = st.init_state(FCFG, chunk)
    got = []
    for c in range(len(x) // chunk):
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * chunk:(c + 1) * chunk]), mats,
            FCFG, VCFG, chunk)
        got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
    got = np.concatenate(got)
    # streaming emits only frames fully contained in consumed chunks
    assert want.shape[0] - got.shape[0] <= 2
    # tiny f32 batching differences (different matmul tile shapes): the
    # frames land on the identical grid, values match to ~1e-4 abs
    np.testing.assert_allclose(got, want[: got.shape[0]], rtol=1e-3, atol=1e-3)


def test_streaming_zero_residual_config():
    """Regression: with frame_len == hop_len the per-chunk residual is
    empty, and ``buf[-0:]`` is the WHOLE buffer — the carried residual
    grew by chunk_len every chunk and stale frames were re-emitted.
    The residual must stay empty and the frames must match offline."""
    import dataclasses
    fcfg = dataclasses.replace(FCFG, frame_len=160, hop_len=160)
    chunk = 1600
    rng = np.random.default_rng(3)
    x = rng.standard_normal(8000).astype(np.float32)
    mats = fe.make_matrices(fcfg)
    want = np.asarray(fe.mfcc(jnp.asarray(x), fcfg, mats))

    state = st.init_state(fcfg, chunk)
    got = []
    for c in range(len(x) // chunk):
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * chunk:(c + 1) * chunk]), mats,
            fcfg, VCFG, chunk)
        assert state.residual.shape == (0,), state.residual.shape
        got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
    got = np.concatenate(got)
    assert got.shape[0] == want.shape[0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_streaming_energy_zcr_match_offline():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(8000).astype(np.float32)
    frames = golden.frame_signal(x, FCFG.frame_len, FCFG.hop_len)
    want_e = golden.short_time_energy(frames)
    want_z = golden.zero_crossing_rate(frames)
    _, outs = _stream_all(x)
    e = np.concatenate([np.asarray(o.energy)[np.asarray(o.frame_valid)] for o in outs])
    z = np.concatenate([np.asarray(o.zcr)[np.asarray(o.frame_valid)] for o in outs])
    np.testing.assert_allclose(e, want_e[: len(e)], rtol=1e-4)
    np.testing.assert_array_equal(z, want_z[: len(z)])


def test_streaming_vad_close_to_offline():
    """Causal VAD start/end within a few frames of the offline detector."""
    sr = 16000
    rng = np.random.default_rng(2)
    x = 0.001 * rng.standard_normal(32000)
    x[8000:18000] += 0.4 * np.sin(2 * np.pi * 300 * np.arange(10000) / sr)
    x = x.astype(np.float32)

    off_start, off_end, found = golden.detect_endpoints(x, FCFG, VCFG)
    assert found

    _, outs = _stream_all(x)
    ends = [(int(np.asarray(o.utt_start_idx)[t]), int(np.asarray(o.utt_end_idx)[t]))
            for o in outs for t in np.nonzero(np.asarray(o.utt_end))[0]]
    assert len(ends) == 1
    s, e = ends[0]
    assert abs(s - off_start) <= 5
    assert abs(e - off_end) <= VCFG.max_silence_frames + VCFG.hangover_frames


def test_streaming_recognizer_two_words():
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])

    # build a 2-utterance stream: word, 1s silence, word
    rng = np.random.default_rng(3)
    sig = 0.002 * rng.standard_normal(16000 * 5)
    w1 = synth_word("zero", 50, max_samples=24000)
    w2 = synth_word("two", 60, max_samples=24000)
    sig[8000:8000 + len(w1)] += w1
    sig[48000:48000 + len(w2)] += w2
    sig = sig.astype(np.float32)

    stream = StreamingRecognizer(rec, CHUNK)
    events = []
    for c in range(len(sig) // CHUNK):
        events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    events += stream.flush()
    got = [e[0] for e in events]
    assert got == ["zero", "two"], events


def test_streaming_honors_matcher_and_k():
    """Regression: _classify always used plain 1-NN full DTW; it must
    route through the wrapped recognizer's matcher and kNN vote."""
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(PipelineConfig(), k=3)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(3)])

    rng = np.random.default_rng(5)
    sig = 0.002 * rng.standard_normal(16000 * 3)
    w = synth_word("one", 70, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    sig = sig.astype(np.float32)

    for matcher in ("dtw", "ltw", "cascade"):
        rec.matcher = matcher
        stream = StreamingRecognizer(rec, CHUNK)
        events = []
        for c in range(len(sig) // CHUNK):
            events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])
        events += stream.flush()
        assert [e[0] for e in events] == ["one"], (matcher, events)
    rec.matcher = "dtw"


def test_streaming_tiny_history_drops_stale_events():
    """Regression: an utterance end landing behind a trimmed tiny
    history window crashed np.stack([]) instead of dropping the event."""
    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ("zero", "one"):
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    rng = np.random.default_rng(6)
    sig = 0.002 * rng.standard_normal(16000 * 4)
    w = synth_word("zero", 80, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    sig = sig.astype(np.float32)
    stream = StreamingRecognizer(rec, CHUNK, history_frames=5)
    for c in range(len(sig) // CHUNK):
        stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])   # must not raise
    stream.flush()


def test_batched_streams_match_individual():
    """S concurrent streams in one call == S independent streams."""
    import jax
    rng = np.random.default_rng(9)
    S, n_chunks = 4, 8
    mats = fe.make_matrices(FCFG)
    sigs = []
    for s in range(S):
        x = (0.002 * rng.standard_normal(CHUNK * n_chunks)).astype(np.float32)
        w = synth_word(["zero", "one", "two", "three"][s], 10 + s,
                       max_samples=8000)
        x[2000:2000 + len(w)] += w
        sigs.append(x)
    sigs = np.stack(sigs)

    # individual
    indiv = []
    for s in range(S):
        state = st.init_state(FCFG, CHUNK)
        outs = []
        for c in range(n_chunks):
            state, out = st.process_chunk(
                state, jnp.asarray(sigs[s, c * CHUNK:(c + 1) * CHUNK]),
                mats, FCFG, VCFG, CHUNK)
            outs.append(out)
        indiv.append(outs)

    # batched
    bstate = st.init_state_batch(S, FCFG, CHUNK)
    for c in range(n_chunks):
        bstate, bout = st.process_chunk_batch(
            bstate, jnp.asarray(sigs[:, c * CHUNK:(c + 1) * CHUNK]),
            mats, FCFG, VCFG, CHUNK)
        for s in range(S):
            np.testing.assert_allclose(
                np.asarray(bout.mfcc[s]), np.asarray(indiv[s][c].mfcc),
                rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(
                np.asarray(bout.in_speech[s]),
                np.asarray(indiv[s][c].in_speech), err_msg=f"s={s} c={c}")
            np.testing.assert_array_equal(
                np.asarray(bout.utt_end[s]), np.asarray(indiv[s][c].utt_end))


def test_long_stream_bounded_memory():
    """Hours-long streams must not grow host memory; a word arriving after
    a long silence is still recognized with correct global indices."""
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.models.streaming import StreamingRecognizer
    from dsp_asr.config import PipelineConfig

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    stream = StreamingRecognizer(rec, CHUNK, history_frames=300)

    rng = np.random.default_rng(4)
    silence_chunks = 120                     # 12 s of near-silence
    events = []
    for _ in range(silence_chunks):
        events += stream.feed((0.002 * rng.standard_normal(CHUNK)).astype(np.float32))
    assert len(stream._frames) <= 300        # history stayed bounded

    sig = 0.002 * rng.standard_normal(CHUNK * 25)
    w = synth_word("one", 33, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    for c in range(25):
        events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK].astype(np.float32))
    events += stream.flush()
    assert [e[0] for e in events] == ["one"], events


def test_sharded_streams_match_single_device():
    """Streams sharded over the mesh data axis == unsharded batch."""
    import jax

    from dsp_asr import parallel as par
    from dsp_asr.ops import streaming as st
    from dsp_asr.ops import frontend as fe

    rng = np.random.default_rng(11)
    s_streams, n_chunks = 8, 4
    sigs = 0.01 * rng.standard_normal((s_streams, n_chunks * CHUNK))
    for i in range(s_streams):
        w = synth_word("one", 100 + i, max_samples=CHUNK * 2)
        sigs[i, CHUNK:CHUNK + len(w)] += w
    sigs = sigs.astype(np.float32)
    mats = fe.make_matrices(FCFG)

    state = st.init_state_batch(s_streams, FCFG, CHUNK)
    outs_plain = []
    for c in range(n_chunks):
        state, out = st.process_chunk_batch(
            state, jnp.asarray(sigs[:, c * CHUNK:(c + 1) * CHUNK]),
            mats, FCFG, VCFG, CHUNK)
        outs_plain.append(out)

    mesh = par.make_mesh(4, 2)
    state_s = st.init_state_batch(s_streams, FCFG, CHUNK)
    for c in range(n_chunks):
        state_s, chunks_s = st.shard_streams(
            mesh, state_s, sigs[:, c * CHUNK:(c + 1) * CHUNK])
        state_s, out_s = st.process_chunk_batch(
            state_s, chunks_s, mats, FCFG, VCFG, CHUNK)
        for a, b in zip(jax.tree.leaves(outs_plain[c]), jax.tree.leaves(out_s)):
            # partitioned matmuls reassociate f32 sums: ~1e-4 abs noise
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=1e-2)


def test_streaming_cmn_matches_offline_pipeline():
    """With cfg.frontend.cmn the streaming classifier must normalise its
    queries like the offline pipeline (round-1 advisor medium finding:
    it silently matched un-normalised queries against a CMN bank)."""
    import dataclasses

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, cmn=True))
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(cfg)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])

    rng = np.random.default_rng(5)
    sig = 0.002 * rng.standard_normal(16000 * 3)
    w = synth_word("one", 77, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    sig = sig.astype(np.float32)

    stream = StreamingRecognizer(rec, CHUNK)
    events = []
    for c in range(len(sig) // CHUNK):
        events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    events += stream.flush()
    assert [e[0] for e in events] == ["one"], events


def test_streaming_denoise_mechanics_exact():
    """The streaming subtraction must be BIT-EXACT against an offline
    reference that uses the same causal noise estimate (mean PSD of the
    first ``vcfg.n_init`` valid frames).  This isolates the cross-chunk
    mechanics (collection window, count, carry, subtraction order) from
    the unavoidable estimator difference vs the offline k-lowest-energy
    picker (tested separately below).

    chunk=3200 puts all n_init estimation frames inside chunk 0, and the
    estimate is accumulated BEFORE the chunk's own frames are denoised —
    so every emitted frame uses the final estimate, enabling exactness.
    """
    import dataclasses

    fcfg = dataclasses.replace(FCFG, denoise="spectral_subtraction")
    chunk = 3200
    rng = np.random.default_rng(6)
    x = (0.02 * rng.standard_normal(32000)).astype(np.float32)

    mats = fe.make_matrices(fcfg)

    # offline reference with the streaming estimator injected
    y = np.concatenate([[x[0]], x[1:] - fcfg.preemphasis * x[:-1]])
    frames_y = fe.frame(jnp.asarray(y.astype(np.float32)),
                        fcfg.frame_len, fcfg.hop_len)
    pspec = fe.power_spectrum_dft(frames_y * mats.window, mats, fcfg.n_fft)
    noise = jnp.mean(pspec[:VCFG.n_init], axis=0)
    sub = jnp.maximum(pspec - fcfg.ss_alpha * noise[None, :],
                      fcfg.ss_beta * pspec)
    want = np.asarray(fe.mfcc_from_pspec(sub, frames_y, mats, fcfg))

    state = st.init_state(fcfg, chunk)
    got = []
    for c in range(len(x) // chunk):
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * chunk:(c + 1) * chunk]), mats,
            fcfg, VCFG, chunk)
        got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
    got = np.concatenate(got)
    n = got.shape[0]
    assert want.shape[0] - n <= 2
    np.testing.assert_allclose(got, want[:n], rtol=1e-3, atol=1e-3)


def test_streaming_denoise_tracks_offline_on_stationary_noise():
    """Round-2 verdict gap: per-chunk noise-PSD estimation silently shifted
    the feature space vs the offline-denoised bank.  The causal cross-chunk
    estimate (StreamState.noise_psd) must track the offline whole-recording
    estimator when the noise is stationary.

    Exact parity is impossible by construction — offline picks the k
    LOWEST-energy frames of the whole recording (selection-biased ~15%
    low), streaming causally averages the FIRST n_init (unbiased, fewer
    frames) — and the max(.., beta*P)+log tail amplifies small estimate
    differences in noise-dominated bins.  So the contract is relative:
    streaming features must sit much closer to the offline-denoised
    space than to the undenoised one."""
    import dataclasses

    fcfg = dataclasses.replace(FCFG, denoise="spectral_subtraction")
    sr = 16000
    rng = np.random.default_rng(6)
    x = 0.02 * rng.standard_normal(48000)
    t = np.arange(16000)
    x[16000:32000] += 0.4 * np.sin(2 * np.pi * 500 * t / sr) \
        + 0.2 * np.sin(2 * np.pi * 1400 * t / sr)
    x = x.astype(np.float32)

    mats = fe.make_matrices(fcfg)
    want = np.asarray(fe.mfcc(jnp.asarray(x), fcfg, mats))
    plain = np.asarray(fe.mfcc(jnp.asarray(x), FCFG, fe.make_matrices(FCFG)))

    state = st.init_state(fcfg, CHUNK)
    got = []
    for c in range(len(x) // CHUNK):
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * CHUNK:(c + 1) * CHUNK]), mats,
            fcfg, VCFG, CHUNK)
        got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
    got = np.concatenate(got)
    n = got.shape[0]

    err_denoised = np.abs(got - want[:n]).mean()
    err_plain = np.abs(got - plain[:n]).mean()
    assert err_denoised < 0.5 * err_plain, (err_denoised, err_plain)


def test_streaming_denoise_envelope_nonstationary():
    """VERDICT r3 #9: characterize the cross-chunk PSD carry under
    NON-stationary noise (ramp / burst), where streaming and offline
    estimates genuinely diverge.  Contract (measured table in
    ops/streaming.py's docstring): on every profile the streaming
    features must (a) stay within 10% of the OFFLINE estimator's
    distance-to-clean — both freeze on early/quiet stats, so they fail
    together — and (b) sit closer to the offline-denoised space than to
    the undenoised one (the stationary test's relative contract,
    extended)."""
    import dataclasses

    fcfg = dataclasses.replace(FCFG, denoise="spectral_subtraction")
    mats = fe.make_matrices(fcfg)
    mats_plain = fe.make_matrices(FCFG)
    sr, n = 16000, 48000
    rng = np.random.default_rng(6)
    t = np.arange(16000)
    speech = np.zeros(n)
    speech[16000:32000] = (0.4 * np.sin(2 * np.pi * 500 * t / sr)
                           + 0.2 * np.sin(2 * np.pi * 1400 * t / sr))
    clean = np.asarray(fe.mfcc(jnp.asarray(speech.astype(np.float32)),
                               FCFG, mats_plain))
    sp = slice(101, 199)                       # interior speech frames
    noise_base = rng.standard_normal(n)
    amps = {
        "stationary": np.full(n, 0.02),
        "ramp": np.linspace(0.02, 0.08, n),
        "burst": np.where((np.arange(n) >= 24000) & (np.arange(n) < 32000),
                          0.2, 0.02),
    }

    def stream_feats(x):
        state = st.init_state(fcfg, CHUNK)
        got = []
        for c in range(len(x) // CHUNK):
            state, out = st.process_chunk(
                state, jnp.asarray(x[c * CHUNK:(c + 1) * CHUNK]), mats,
                fcfg, VCFG, CHUNK)
            got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
        return np.concatenate(got)

    for profile, amp in amps.items():
        x = (speech + amp * noise_base).astype(np.float32)
        offline = np.asarray(fe.mfcc(jnp.asarray(x), fcfg, mats))
        plain = np.asarray(fe.mfcc(jnp.asarray(x), FCFG, mats_plain))
        got = stream_feats(x)

        d_clean_stream = np.abs(got[sp] - clean[sp]).mean()
        d_clean_offline = np.abs(offline[sp] - clean[sp]).mean()
        assert abs(d_clean_stream - d_clean_offline) < 0.10 * d_clean_offline, (
            profile, d_clean_stream, d_clean_offline)

        d_off = np.abs(got[sp] - offline[sp]).mean()
        d_plain = np.abs(got[sp] - plain[sp]).mean()
        assert d_off < 0.7 * d_plain, (profile, d_off, d_plain)


def test_streaming_recognizer_with_denoise():
    """End-to-end: denoise-configured bank + streaming queries agree."""
    import dataclasses

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend,
                                          denoise="spectral_subtraction"))
    labels = ["zero", "one", "two"]
    rec = KnnDtwRecognizer(cfg)
    for lab in labels:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])

    rng = np.random.default_rng(7)
    sig = 0.02 * rng.standard_normal(16000 * 3)
    w = synth_word("two", 88, max_samples=24000)
    sig[8000:8000 + len(w)] += w
    sig = sig.astype(np.float32)

    stream = StreamingRecognizer(rec, CHUNK)
    events = []
    for c in range(len(sig) // CHUNK):
        events += stream.feed(sig[c * CHUNK:(c + 1) * CHUNK])
    events += stream.flush()
    assert [e[0] for e in events] == ["two"], events


def test_streaming_rejects_lpcc():
    import dataclasses

    import pytest

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, feature_type="lpcc"))
    rec = KnnDtwRecognizer(cfg)
    rec.enroll("zero", [synth_word("zero", 0)])
    with pytest.raises(NotImplementedError, match="mfcc"):
        StreamingRecognizer(rec, CHUNK)
