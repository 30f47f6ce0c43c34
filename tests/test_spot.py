"""Keyword spotting: subsequence DTW (ops/spot.py).

Proof layers: (1) the golden loop-level subsequence DP is validated by
brute-force enumeration over every (start, end) span on tiny problems
(each span scored by classical whole-span DTW), (2) the jax row-major
batch op matches the golden tables on random ragged banks — scores AND
start witnesses, (3) the streaming SPRING column update equals the
batch op under ANY chunking, (4) event extraction finds planted
keywords in synthetic streams and matches the golden extractor.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsp_asr.golden import dtw as gd
from dsp_asr.golden import spot as gs
from dsp_asr.ops import spot as ops_spot

RNG = np.random.default_rng(5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_golden_matches_brute_enumeration(seed):
    """For every end column j the DP's RAW cost must equal the minimum
    over start columns s of the fixed-endpoint whole-span DTW raw cost
    (subsequence DTW minimises raw cost; span normalisation is a
    post-hoc readout), and the start witness must achieve that min."""
    from dsp_asr.config import DtwConfig
    cfg = DtwConfig(band_frac=None, squared=False, impl="scan")
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 2))
    b = rng.standard_normal((9, 2))
    ta = a.shape[0]
    norm, start = gs.subseq_dtw(a, b)
    for j in range(b.shape[0]):
        raws = [gd.dtw_distance(a, b[s:j + 1], cfg) * (ta + (j - s + 1))
                for s in range(j + 1)]
        got_raw = norm[j] * (ta + (j - int(start[j]) + 1))
        np.testing.assert_allclose(got_raw, min(raws), rtol=1e-12,
                                   err_msg=f"end col {j}")
        np.testing.assert_allclose(raws[int(start[j])], min(raws),
                                   rtol=1e-12, err_msg=f"witness at {j}")


def test_golden_finds_planted_keyword():
    rng = np.random.default_rng(1)
    kw = rng.standard_normal((6, 3))
    stream = rng.standard_normal((40, 3)) * 5.0     # keyword-unlike filler
    stream[12:18] = kw                               # exact plant
    norm, start = gs.subseq_dtw(kw, stream)
    j = int(np.argmin(norm))
    assert norm[j] < 1e-9                            # exact match costs 0
    assert (int(start[j]), j) == (12, 17)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_matches_golden(seed):
    rng = np.random.default_rng(seed)
    b_streams, u, f, k, t = 3, 24, 4, 5, 8
    streams = rng.standard_normal((b_streams, u, f)).astype(np.float32)
    s_lens = rng.integers(10, u + 1, size=b_streams).astype(np.int32)
    bank = rng.standard_normal((k, t, f)).astype(np.float32)
    b_lens = rng.integers(3, t + 1, size=k).astype(np.int32)
    # zero padded template rows like the pipeline does
    for v in range(k):
        bank[v, b_lens[v]:] = 0.0
    norm, start = ops_spot.subseq_dtw_batch(
        jnp.asarray(streams), jnp.asarray(s_lens),
        jnp.asarray(bank), jnp.asarray(b_lens))
    norm, start = np.asarray(norm), np.asarray(start)
    for bi in range(b_streams):
        for v in range(k):
            g_norm, g_start = gs.subseq_dtw(
                bank[v, : b_lens[v]], streams[bi, : s_lens[bi]])
            np.testing.assert_allclose(
                norm[bi, v, : s_lens[bi]], g_norm, rtol=2e-4, atol=1e-5,
                err_msg=f"stream {bi} template {v}")
            np.testing.assert_array_equal(
                start[bi, v, : s_lens[bi]], g_start)
            assert np.all(norm[bi, v, s_lens[bi]:] >= 1e20)


@pytest.mark.parametrize("chunks", [[31], [16, 15], [1] * 31, [7, 9, 4, 11]])
def test_spring_chunk_invariant_and_matches_batch(chunks):
    rng = np.random.default_rng(7)
    u, f, k, t = 31, 3, 4, 6
    assert sum(chunks) == u
    stream = rng.standard_normal((u, f)).astype(np.float32)
    bank = rng.standard_normal((k, t, f)).astype(np.float32)
    b_lens = np.asarray([6, 4, 3, 5], np.int32)
    for v in range(k):
        bank[v, b_lens[v]:] = 0.0
    bank_j, lens_j = jnp.asarray(bank), jnp.asarray(b_lens)

    state = ops_spot.spot_init(k, t)
    norms, starts = [], []
    # feed fixed-size chunks (pad the tail) so one program serves all
    offset = 0
    for c in chunks:
        buf = np.zeros((max(chunks), f), np.float32)
        buf[:c] = stream[offset:offset + c]
        state, nrm, st_ = ops_spot.spot_chunk(
            state, jnp.asarray(buf), jnp.asarray(c, jnp.int32),
            bank_j, lens_j)
        norms.append(np.asarray(nrm)[:, :c])
        starts.append(np.asarray(st_)[:, :c])
        offset += c
    norm_s = np.concatenate(norms, axis=1)
    start_s = np.concatenate(starts, axis=1)

    # batch reference (single stream)
    norm_b, start_b = ops_spot.subseq_dtw_batch(
        jnp.asarray(stream[None]), jnp.asarray([u], jnp.int32),
        bank_j, lens_j)
    np.testing.assert_allclose(norm_s, np.asarray(norm_b)[0],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(start_s, np.asarray(start_b)[0])


def test_spring_bit_exact_across_chunkings():
    rng = np.random.default_rng(9)
    u, f, k, t = 24, 3, 2, 5
    stream = rng.standard_normal((u, f)).astype(np.float32)
    bank = rng.standard_normal((k, t, f)).astype(np.float32)
    lens = jnp.asarray([5, 3], jnp.int32)
    outs = []
    for chunks in ([24], [8, 8, 8], [1] * 24):
        state = ops_spot.spot_init(k, t)
        parts = []
        off = 0
        for c in chunks:
            buf = np.zeros((max(chunks), f), np.float32)
            buf[:c] = stream[off:off + c]
            state, nrm, _ = ops_spot.spot_chunk(
                state, jnp.asarray(buf), jnp.asarray(c, jnp.int32),
                jnp.asarray(bank), lens)
            parts.append(np.asarray(nrm)[:, :c])
            off += c
        outs.append(np.concatenate(parts, axis=1))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_extract_events_matches_golden_and_spots_plants():
    rng = np.random.default_rng(3)
    f = 3
    kw0 = rng.standard_normal((6, f))
    kw1 = rng.standard_normal((5, f))
    stream = rng.standard_normal((60, f)) * 4.0
    stream[10:16] = kw0
    stream[40:45] = kw1
    bank = [kw0, kw1]
    norm = np.stack([gs.subseq_dtw(kw, stream)[0] for kw in bank])
    start = np.stack([gs.subseq_dtw(kw, stream)[1] for kw in bank])
    want = gs.spot_events(norm, start, threshold=0.1)
    got = ops_spot.extract_events(norm, start, threshold=0.1)
    assert got == want
    assert [(ev[0], ev[1], ev[2]) for ev in got] == [(0, 10, 15), (1, 40, 44)]
    assert all(ev[3] < 1e-9 for ev in got)


def test_extract_events_suppresses_overlaps():
    # two templates matching the same span: only the better one reported
    norm = np.asarray([[5.0, 0.02, 5.0, 5.0],
                       [5.0, 5.0, 0.05, 5.0]])
    start = np.asarray([[0, 0, 2, 3],
                        [0, 0, 1, 3]])
    events = ops_spot.extract_events(norm, start, threshold=0.5)
    assert events == [(0, 0, 1, 0.02)]
