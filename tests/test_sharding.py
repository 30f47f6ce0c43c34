"""Multi-device tests on the fake 8-device CPU mesh (SURVEY.md §4.4).

Bank-sharded classification must match single-device classification
bit-for-bit on the argmin label and allclose on distances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsp_asr.config import PipelineConfig
from dsp_asr.ops import dtw as jdtw, frontend as fe
from dsp_asr import parallel as par
from dsp_asr import pipeline as pl
from dsp_asr.io.dataset import synth_word

CFG = PipelineConfig()


def _random_problem(rng, b=8, k=8, t=30, u=26, f=13):
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(5, t + 1, size=b).astype(np.int32)
    bl = rng.integers(5, u + 1, size=k).astype(np.int32)
    ids = (rng.integers(0, 3, size=k)).astype(np.int32)
    return q, ql, bank, bl, ids


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_classify_matches_single_device(shape):
    rng = np.random.default_rng(0)
    q, ql, bank, bl, ids = _random_problem(rng)
    # single device truth
    d = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                  jnp.asarray(bank), jnp.asarray(bl)))
    want_idx = d.argmin(axis=1)
    want_label = ids[want_idx]
    want_dist = d.min(axis=1)

    mesh = par.make_mesh(*shape)
    qd, qld = par.shard_queries(mesh, q, ql)
    bd, bld = par.shard_bank(mesh, bank, bl)
    idsd = par.replicate(mesh, ids)
    got_label, got_dist = par.classify_sharded(mesh, qd, qld, bd, bld, idsd)
    np.testing.assert_array_equal(np.asarray(got_label), want_label)
    np.testing.assert_allclose(np.asarray(got_dist), want_dist, rtol=1e-6)


def test_sharded_with_padded_bank():
    """K not divisible by bank axis -> pad with invalid templates."""
    rng = np.random.default_rng(1)
    q, ql, bank, bl, ids = _random_problem(rng, k=5)
    d = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                  jnp.asarray(bank), jnp.asarray(bl)))
    want_label = ids[d.argmin(axis=1)]

    mesh = par.make_mesh(2, 4)
    bank_p, korig = par.pad_axis_to_multiple(bank, 4)
    bl_p, _ = par.pad_axis_to_multiple(bl, 4)
    ids_p, _ = par.pad_axis_to_multiple(ids, 4)
    bl_p = np.maximum(bl_p, 1)
    valid = np.arange(bank_p.shape[0]) < korig

    qd, qld = par.shard_queries(mesh, q, ql)
    bd, bld = par.shard_bank(mesh, bank_p, bl_p)
    idsd, validd = par.replicate(mesh, ids_p, valid)
    # bank_valid travels sharded with the bank
    validd = par.shard_bank(mesh, valid)
    got_label, _ = par.classify_sharded(mesh, qd, qld, bd, bld, idsd, validd)
    np.testing.assert_array_equal(np.asarray(got_label), want_label)


def test_recognize_sharded_end_to_end():
    """Full pipeline over the mesh equals the single-device pipeline."""
    labels = ["zero", "one", "two", "three"]
    mats = fe.make_matrices(CFG.frontend)
    bank_sigs = np.stack([synth_word(lab, i, max_samples=CFG.max_samples)
                          for lab in labels for i in range(2)])
    bank_ns = np.full(8, CFG.max_samples, dtype=np.int32)
    ids = np.repeat(np.arange(4, dtype=np.int32), 2)
    bank = pl.extract_features(jnp.asarray(bank_sigs), jnp.asarray(bank_ns), mats, CFG)

    test_sigs = np.stack([synth_word(lab, 50 + i, max_samples=CFG.max_samples)
                          for i, lab in enumerate(labels * 2)])
    test_ns = np.full(8, CFG.max_samples, dtype=np.int32)

    want_ids, _ = pl.recognize_batch(
        jnp.asarray(test_sigs), jnp.asarray(test_ns), mats,
        bank, jnp.asarray(ids), CFG)

    mesh = par.make_mesh(2, 4)
    sig_d, ns_d = par.shard_queries(mesh, test_sigs, test_ns)
    bf_d = par.shard_bank(mesh, np.asarray(bank.feats))
    blen_d = par.shard_bank(mesh, np.asarray(bank.length))
    ids_d = par.replicate(mesh, ids)
    got_ids, _ = par.recognize_sharded(
        mesh, sig_d, ns_d, mats, bf_d, blen_d, ids_d, cfg=CFG)
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))
    # and the predictions are actually right
    np.testing.assert_array_equal(np.asarray(got_ids), np.array([0, 1, 2, 3] * 2))


def test_recognizer_with_mesh_matches_single_device():
    """KnnDtwRecognizer(mesh=...) == KnnDtwRecognizer() labels, with ragged
    batch (B=5 not divisible by data axis) and ragged bank (K=6)."""
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    labels = ["zero", "one", "two"]
    mesh = par.make_mesh(2, 4)
    plain = KnnDtwRecognizer(CFG)
    sharded = KnnDtwRecognizer(CFG, mesh=mesh)
    for rec in (plain, sharded):
        for lab in labels:
            rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    tests = [synth_word(labels[i % 3], 40 + i) for i in range(5)]
    assert sharded.classify_batch(tests) == plain.classify_batch(tests)
    assert plain.classify_batch(tests) == [labels[i % 3] for i in range(5)]


def test_multihost_helpers_single_process():
    from dsp_asr.parallel import multihost
    multihost.initialize()          # no-op single host
    assert multihost.is_primary()
    assert multihost.all_hosts_agree(0.875)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
def test_sharded_knn_k3_matches_single_device(shape):
    """Mesh kNN (per-shard top-k gather + vote) == single-device kNN
    (round-1 review item: the mesh path used to reject k>1)."""
    from dsp_asr.pipeline import knn_vote

    rng = np.random.default_rng(3)
    q, ql, bank, bl, ids = _random_problem(rng, b=8, k=8)
    n_labels = int(ids.max()) + 1
    d = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                  jnp.asarray(bank), jnp.asarray(bl)))
    want = np.asarray(knn_vote(jnp.asarray(d), jnp.asarray(ids),
                               n_labels=n_labels, k=3))

    mesh = par.make_mesh(*shape)
    qd, qld = par.shard_queries(mesh, q, ql)
    bd, bld = par.shard_bank(mesh, bank, bl)
    idsd = par.replicate(mesh, ids)
    got, _ = par.classify_sharded(mesh, qd, qld, bd, bld, idsd,
                                  k=3, n_labels=n_labels)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_sharded_full_distances_match_single_device():
    rng = np.random.default_rng(4)
    q, ql, bank, bl, ids = _random_problem(rng)
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(q), jnp.asarray(ql),
                                     jnp.asarray(bank), jnp.asarray(bl)))
    mesh = par.make_mesh(2, 4)
    qd, qld = par.shard_queries(mesh, q, ql)
    bd, bld = par.shard_bank(mesh, bank, bl)
    idsd = par.replicate(mesh, ids)
    _, dists = par.classify_sharded(mesh, qd, qld, bd, bld, idsd,
                                    return_full=True)
    np.testing.assert_allclose(np.asarray(dists), want, rtol=1e-6)


def test_recognizer_mesh_knn_and_distances():
    """KnnDtwRecognizer(mesh=..., k=3) matches the single-device
    recognizer, and mesh return_distances now yields the full [B, K]."""
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    mesh = par.make_mesh(2, 4)
    labels = ["zero", "one", "two"]
    single = KnnDtwRecognizer(CFG, k=3)
    meshed = KnnDtwRecognizer(CFG, k=3, mesh=mesh)
    for lab in labels:
        sigs = [synth_word(lab, i) for i in range(2)]
        single.enroll(lab, sigs)
        meshed.enroll(lab, sigs)
    queries = [synth_word(lab, 50 + i) for i, lab in enumerate(labels * 2)]
    want, want_d = single.classify_batch(queries, return_distances=True)
    got, got_d = meshed.classify_batch(queries, return_distances=True)
    assert got == want
    assert got_d.shape == want_d.shape
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5)


def test_hmm_mesh_decode_matches_single_device():
    """Data-parallel HMM decode (GmmHmmRecognizer(mesh=...)) returns the
    same labels and scores as the single-device path."""
    from dsp_asr import parallel as par
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import make_corpus, synth_word
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer

    labels = ["zero", "one", "two"]
    train = make_corpus(labels, n_per_word=3, seed=0)
    rec = GmmHmmRecognizer(PipelineConfig(),
                           HmmConfig(n_states=4, n_mix=2, n_iter=3))
    rec.fit(train)
    queries = [synth_word(lab, 40 + i) for i, lab in enumerate(labels * 3)]

    want, want_s = rec.classify_batch(queries, return_scores=True)
    rec.mesh = par.make_mesh(2, 4)
    got, got_s = rec.classify_batch(queries, return_scores=True)
    assert got == want
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1)])
def test_level_build_sharded_matches_single_device(shape):
    """Bank-sharded level building: per-level [T]-vector reduction over
    the bank axis must reproduce the single-device DP exactly (costs
    bit-comparable, words/starts equal on live cells)."""
    from dsp_asr.ops.level_building import BIG, level_build
    from dsp_asr.parallel.sharding import level_build_sharded

    rng = np.random.default_rng(4)
    b, k, t, u, f = 8, 8, 20, 10, 5
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = np.full(b, t, np.int32)
    bl = rng.integers(4, u + 1, size=k).astype(np.int32)

    want_c, want_w, want_s = level_build(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        max_levels=4, word_penalty=0.2)
    mesh = par.make_mesh(*shape)
    got_c, got_w, got_s = level_build_sharded(
        mesh, jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
        jnp.asarray(bl), max_levels=4, word_penalty=0.2)
    want_c, got_c = np.asarray(want_c), np.asarray(got_c)
    live = want_c < BIG / 2
    np.testing.assert_array_equal(got_c < BIG / 2, live)
    np.testing.assert_allclose(got_c[live], want_c[live], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_w)[live],
                                  np.asarray(want_w)[live])
    np.testing.assert_array_equal(np.asarray(got_s)[live],
                                  np.asarray(want_s)[live])


def test_level_build_sharded_padded_bank():
    """Padding templates (bank_valid=False) must never be selected."""
    from dsp_asr.ops.level_building import BIG, level_build
    from dsp_asr.parallel.sharding import level_build_sharded

    rng = np.random.default_rng(5)
    b, k, t, u, f = 4, 6, 16, 8, 4
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = np.full(b, t, np.int32)
    bl = rng.integers(3, u + 1, size=k).astype(np.int32)

    want_c, want_w, _ = level_build(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank), jnp.asarray(bl),
        max_levels=3)
    pad = np.zeros((2, u, f), np.float32)        # pad K 6 -> 8 for nb=4
    bank_p = np.concatenate([bank, pad])
    bl_p = np.concatenate([bl, np.ones(2, np.int32)])
    valid = np.asarray([True] * k + [False] * 2)
    mesh = par.make_mesh(2, 4)
    got_c, got_w, _ = level_build_sharded(
        mesh, jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank_p),
        jnp.asarray(bl_p), jnp.asarray(valid), max_levels=3)
    live = np.asarray(want_c) < BIG / 2
    np.testing.assert_allclose(np.asarray(got_c)[live],
                               np.asarray(want_c)[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_w)[live],
                                  np.asarray(want_w)[live])
    assert (np.asarray(got_w)[live] < k).all()   # pads never win


@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (8, 1)])
def test_level_build_grammar_sharded_matches_single(shape):
    """Grammar DP over the mesh == single-device planes, incl. a padded
    bank whose dead rows are masked out of the grammar."""
    from dsp_asr.ops.level_building import (BIG, backtrack_grammar,
                                            level_build_grammar)
    from dsp_asr.parallel.sharding import level_build_grammar_sharded

    rng = np.random.default_rng(31)
    b, k, t, u, f = 8, 6, 14, 7, 4
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = np.full(b, t, np.int32)
    bl = rng.integers(3, u + 1, size=k).astype(np.int32)
    start = rng.random(k) < 0.7
    pairs = rng.random((k, k)) < 0.7
    end = rng.random(k) < 0.7
    start[0] = end[0] = True
    pairs[np.arange(k), (np.arange(k) + 1) % k] = True

    want_c, want_s = level_build_grammar(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank),
        jnp.asarray(bl), jnp.asarray(start), jnp.asarray(pairs),
        max_levels=3, word_penalty=0.2)

    kp = 8                                       # pad K 6 -> 8 for nb=8
    bank_p = np.concatenate([bank, np.zeros((kp - k, u, f), np.float32)])
    bl_p = np.concatenate([bl, np.ones(kp - k, np.int32)])
    valid = np.asarray([True] * k + [False] * (kp - k))
    start_p = np.concatenate([start, np.zeros(kp - k, bool)])
    pairs_p = np.zeros((kp, kp), bool)
    pairs_p[:k, :k] = pairs
    mesh = par.make_mesh(*shape)
    got_c, got_s = level_build_grammar_sharded(
        mesh, jnp.asarray(q), jnp.asarray(ql), jnp.asarray(bank_p),
        jnp.asarray(bl_p), jnp.asarray(valid), jnp.asarray(start_p),
        jnp.asarray(pairs_p), max_levels=3, word_penalty=0.2)
    want_c, got_c = np.asarray(want_c), np.asarray(got_c)
    live = want_c < BIG / 2
    np.testing.assert_array_equal(got_c[..., :k] < BIG / 2, live)
    np.testing.assert_allclose(got_c[..., :k][live], want_c[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_s)[..., :k][live],
                                  np.asarray(want_s)[live])
    assert (got_c[..., k:] >= BIG / 2).all()     # pads never reachable
    # end-to-end: identical backtracked sequences through either plane
    end_p = np.concatenate([end, np.zeros(kp - k, bool)])
    for row in range(b):
        assert backtrack_grammar(got_c[row], np.asarray(got_s)[row],
                                 pairs_p, end_p, t)[0] == \
            backtrack_grammar(want_c[row], np.asarray(want_s)[row],
                              pairs, end, t)[0]


def test_recognizer_level_grammar_with_mesh():
    """classify_connected(method='level', grammar=...) routes through
    the bank-sharded grammar DP when a mesh is set and matches the
    single-device decode — including a constraint that reroutes."""
    from dsp_asr.io.dataset import synth_connected, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    truth = ["two", "zero", "one"]
    sigs = [synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                            lead_ms=(50.0, 60.0)),
            synth_connected(["one", "two"], seed=9)]
    ok = {"no_repeat": True}
    reroute = {"start": ["zero", "one"]}         # forbids truth's "two"
    want_ok = rec.classify_connected(sigs, max_segments=4, method="level",
                                     grammar=ok)
    want_re = rec.classify_connected(sigs, max_segments=4, method="level",
                                     grammar=reroute)
    rec.mesh = par.make_mesh(2, 4)
    got_ok = rec.classify_connected(sigs, max_segments=4, method="level",
                                    grammar=ok)
    got_re = rec.classify_connected(sigs, max_segments=4, method="level",
                                    grammar=reroute)
    assert got_ok == want_ok == [truth, ["one", "two"]]
    assert got_re == want_re and got_re[0][0] != "two"


def test_recognizer_level_method_with_mesh():
    """classify_connected(method='level') routes through the bank-sharded
    DP when a mesh is set and matches the single-device decode."""
    from dsp_asr.io.dataset import synth_connected, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab in ["zero", "one", "two"]:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    truth = ["two", "zero", "one"]
    sigs = [synth_connected(truth, seed=5, gap_ms=(0.0, 1.0),
                            lead_ms=(50.0, 60.0)),
            synth_connected(["one", "two"], seed=9)]
    want = rec.classify_connected(sigs, max_segments=4, method="level")
    rec.mesh = par.make_mesh(2, 4)
    got = rec.classify_connected(sigs, max_segments=4, method="level")
    assert got == want == [truth, ["one", "two"]]


def test_vq_mesh_scoring_matches_single_device():
    from dsp_asr import parallel as par
    from dsp_asr.config import PipelineConfig, VqConfig
    from dsp_asr.io.dataset import make_corpus, synth_word
    from dsp_asr.models.vq import VqRecognizer

    labels = ["zero", "one", "two"]
    rec = VqRecognizer(PipelineConfig(), VqConfig(n_codes=16, n_iter=4))
    rec.fit(make_corpus(labels, n_per_word=2, seed=0))
    queries = [synth_word(lab, 70 + i) for i, lab in enumerate(labels * 3)]

    want, want_d = rec.classify_batch(queries, return_distances=True)
    rec.mesh = par.make_mesh(4, 2)
    got, got_d = rec.classify_batch(queries, return_distances=True)
    assert got == want
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)
