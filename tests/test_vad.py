"""JAX VAD vs golden oracle: integer frame indices must match exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsp_asr.config import FrontendConfig, VadConfig
from dsp_asr import golden
from dsp_asr.io.dataset import synth_word
from dsp_asr.ops import vad as jvad

FCFG = FrontendConfig()
VCFG = VadConfig()


def _cases():
    rng = np.random.default_rng(0)
    out = []
    # tone burst in noise
    x = 0.001 * rng.standard_normal(32000)
    x[8000:18000] += 0.4 * np.sin(2 * np.pi * 300 * np.arange(10000) / 16000)
    out.append(x.astype(np.float32))
    # speech at the very start
    y = 0.001 * rng.standard_normal(32000)
    y[:6000] += 0.5 * np.sin(2 * np.pi * 500 * np.arange(6000) / 16000)
    out.append(y.astype(np.float32))
    # speech to the very end
    z = 0.001 * rng.standard_normal(32000)
    z[26000:] += 0.5 * np.sin(2 * np.pi * 700 * np.arange(6000) / 16000)
    out.append(z.astype(np.float32))
    # pure silence
    out.append((0.0005 * rng.standard_normal(32000)).astype(np.float32))
    # synthetic words
    out += [synth_word(w, i) for i, w in enumerate(["one", "seven", "zero"])]
    return out


@pytest.mark.parametrize("i", range(7))
def test_vad_exact_parity(i):
    x = _cases()[i]
    want = golden.detect_endpoints(x, FCFG, VCFG)
    s, e, f = jvad.detect_endpoints(jnp.asarray(x), FCFG, VCFG)
    got = (int(s), int(e), bool(f))
    assert got == want


def test_vad_energy_zcr_parity():
    x = _cases()[0]
    frames = golden.frame_signal(x, FCFG.frame_len, FCFG.hop_len)
    jframes = jnp.asarray(frames, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(jvad.short_time_energy(jframes)),
        golden.short_time_energy(frames), rtol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(jvad.zero_crossing_rate(jframes)),
        golden.zero_crossing_rate(frames))


def test_vad_padded_signal_invariance():
    """A zero-padded tail with the true sample length masked must give the
    same endpoints as the unpadded signal."""
    x = _cases()[0]
    short = x[:24000]
    want = golden.detect_endpoints(short, FCFG, VCFG)
    padded = np.zeros(32000, dtype=np.float32)
    padded[:24000] = short
    s, e, f = jvad.detect_endpoints(
        jnp.asarray(padded), FCFG, VCFG, length_samples=jnp.asarray(24000))
    assert (int(s), int(e), bool(f)) == want


def test_vad_batched_vmap():
    cases = _cases()[:4]
    batch = jnp.asarray(np.stack(cases))
    s, e, f = jax.vmap(lambda x: jvad.detect_endpoints(x, FCFG, VCFG))(batch)
    for i, x in enumerate(cases):
        want = golden.detect_endpoints(x, FCFG, VCFG)
        assert (int(s[i]), int(e[i]), bool(f[i])) == want


def test_vad_degenerate_lengths():
    """Valid regions of 0 or 1 frames must not crash or mis-index."""
    rng = np.random.default_rng(5)
    x = jnp.asarray((0.3 * rng.standard_normal(32000)).astype(np.float32))
    # shorter than one frame -> zero valid frames
    s, e, f = jvad.detect_endpoints(x, FCFG, VCFG, length_samples=jnp.asarray(100))
    assert (int(s), int(e), bool(f)) == (0, 0, False)
    # exactly one valid frame
    s, e, f = jvad.detect_endpoints(x, FCFG, VCFG, length_samples=jnp.asarray(400))
    assert int(e) <= 1 and int(s) == 0
    # loud single frame cannot satisfy min_speech_frames -> not found
    assert not bool(f)


TP_CFG = VadConfig(threshold_mode="two_pass")


def _snr0_case(seed=7, sigma=0.05):
    """A 0 dB-SNR-like recording: stationary noise whose per-frame energy
    is comparable to the speech band's, so TH = 4x noise-floor never
    fires (the structural noise_mult failure, docs/RESULTS.md snr0)."""
    rng = np.random.default_rng(seed)
    x = sigma * rng.standard_normal(32000)
    tone = np.sin(2 * np.pi * 350 * np.arange(12000) / 16000)
    x[10000:22000] += sigma * np.sqrt(2.0) * tone  # speech power == noise
    return x.astype(np.float32)


@pytest.mark.parametrize("i", range(7))
def test_vad_two_pass_exact_parity(i):
    x = _cases()[i]
    want = golden.detect_endpoints(x, FCFG, TP_CFG)
    s, e, f = jvad.detect_endpoints(jnp.asarray(x), FCFG, TP_CFG)
    assert (int(s), int(e), bool(f)) == want


def test_vad_two_pass_finds_0db_speech():
    """At ~0 dB SNR the classical rule cannot fire (speech+noise frames
    carry ~2x the floor energy < TH = 4x); two_pass interpolates between
    the measured floor and ceiling and must recover the word."""
    x = _snr0_case()
    _, _, f_classic = golden.detect_endpoints(x, FCFG, VCFG)
    s, e, f = golden.detect_endpoints(x, FCFG, TP_CFG)
    assert not f_classic          # the documented snr0 failure mode
    assert f
    # frame span must land on the 10000..22000 sample burst (+-20 frames)
    hop = FCFG.hop_len
    assert abs(s * hop - 10000) < 20 * hop, (s, e)
    assert abs(e * hop - 22000) < 20 * hop, (s, e)
    js, je, jf = jvad.detect_endpoints(jnp.asarray(x), FCFG, TP_CFG)
    assert (int(js), int(je), bool(jf)) == (s, e, f)


def test_vad_two_pass_pure_noise_fallback():
    """No speech-like contrast (ceil < tp_min_contrast * floor) must fall
    back to the classical thresholds, which correctly find nothing."""
    rng = np.random.default_rng(11)
    x = (0.05 * rng.standard_normal(32000)).astype(np.float32)
    want = golden.detect_endpoints(x, FCFG, TP_CFG)
    assert want == golden.detect_endpoints(x, FCFG, VCFG)
    assert not want[2]
    s, e, f = jvad.detect_endpoints(jnp.asarray(x), FCFG, TP_CFG)
    assert (int(s), int(e), bool(f)) == want


def test_vad_two_pass_padded_invariance():
    """The whole-utterance floor/ceiling statistics must ignore padding:
    invalid frames sort to +inf and the rank indices use the true
    length."""
    x = _snr0_case(seed=9)
    short = x[:24000]
    want = golden.detect_endpoints(short, FCFG, TP_CFG)
    padded = np.zeros(32000, dtype=np.float32)
    padded[:24000] = short
    s, e, f = jvad.detect_endpoints(
        jnp.asarray(padded), FCFG, TP_CFG,
        length_samples=jnp.asarray(24000))
    assert (int(s), int(e), bool(f)) == want


def test_vad_unknown_threshold_mode_raises():
    bad = VadConfig(threshold_mode="quantile")
    x = _cases()[0]
    with pytest.raises(ValueError):
        golden.detect_endpoints(x, FCFG, bad)
    with pytest.raises(ValueError):
        jvad.detect_endpoints(jnp.asarray(x), FCFG, bad)


def test_vad_two_pass_segments_parity():
    """The multi-segment splitter shares the threshold rule — exact
    golden parity under two_pass on a two-word stream."""
    rng = np.random.default_rng(13)
    x = 0.03 * rng.standard_normal(48000)
    t1 = np.sin(2 * np.pi * 300 * np.arange(8000) / 16000)
    t2 = np.sin(2 * np.pi * 500 * np.arange(8000) / 16000)
    x[6000:14000] += 0.06 * t1
    x[30000:38000] += 0.06 * t2
    x = x.astype(np.float32)
    from dsp_asr.golden import vad as gvad
    want = gvad.detect_segments(x, FCFG, TP_CFG)
    frames = golden.frame_signal(x, FCFG.frame_len, FCFG.hop_len)
    e = jnp.asarray(golden.short_time_energy(frames), jnp.float32)
    z = jnp.asarray(golden.zero_crossing_rate(frames), jnp.float32)
    starts, ends, n = jvad.detect_segments_frames(
        e, z, jnp.asarray(len(frames)), TP_CFG, max_segments=8)
    got = [(int(starts[i]), int(ends[i])) for i in range(int(n))]
    assert got == [tuple(seg) for seg in want]


def test_vad_short_burst_parity():
    """Short bursts around the min_speech_frames boundary: exact parity.

    (A 480-sample burst still overlaps ~5 frames partially, so whether it
    triggers is threshold-sensitive — the invariant is jax == golden.)"""
    rng = np.random.default_rng(6)
    for n_burst in (180, 480, 900):
        x = 0.001 * rng.standard_normal(16000)
        x[8000:8000 + n_burst] += 0.5 * np.sin(
            2 * np.pi * 400 * np.arange(n_burst) / 16000)
        want = golden.detect_endpoints(x.astype(np.float32), FCFG, VCFG)
        s, e, f = jvad.detect_endpoints(jnp.asarray(x, dtype=jnp.float32),
                                        FCFG, VCFG)
        assert (int(s), int(e), bool(f)) == want, n_burst
