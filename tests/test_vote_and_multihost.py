"""Regression tests for the kNN tie-break and the multi-host agreement
check (round-1 review items: an epsilon-blend vote score flips once
distance sums dwarf the vote gap; a pmean-based agreement check cannot
distinguish 'all agree' from errors that average out)."""

import numpy as np

import jax.numpy as jnp

from dsp_asr.parallel import multihost
from dsp_asr.pipeline import knn_vote


def test_knn_vote_majority_beats_huge_distances():
    """Label 0 has 2 votes with ~1e7 distances; label 1 has 1 vote with a
    tiny distance.  Majority must win regardless of distance magnitude
    (the old epsilon score flipped here)."""
    dists = jnp.asarray([[1.0e7, 1.1e7, 1.0e-3, 5.0e7]])
    ids = jnp.asarray([0, 0, 1, 1], dtype=jnp.int32)
    got = np.asarray(knn_vote(dists, ids, n_labels=2, k=3))
    assert got[0] == 0


def test_knn_vote_distance_breaks_exact_ties():
    """Equal votes -> smaller summed distance wins."""
    dists = jnp.asarray([[3.0, 9.0, 4.0, 5.0]])
    ids = jnp.asarray([0, 0, 1, 1], dtype=jnp.int32)   # sums: 12 vs 9
    got = np.asarray(knn_vote(dists, ids, n_labels=2, k=4))
    assert got[0] == 1


def test_knn_vote_ignores_nontop_labels():
    dists = jnp.asarray([[0.1, 0.2, 99.0, 98.0, 0.15]])
    ids = jnp.asarray([2, 2, 0, 1, 2], dtype=jnp.int32)
    got = np.asarray(knn_vote(dists, ids, n_labels=3, k=3))
    assert got[0] == 2


def test_all_hosts_agree_single_process():
    assert multihost.all_hosts_agree(0.5)
    assert multihost.all_hosts_agree(123.0, atol=0.1)


def test_min_max_across_hosts_is_exact():
    lo, hi = multihost._min_max_across_hosts(0.75)
    assert lo == hi == 0.75
    assert multihost.jnp_mean_across_hosts(2.0) == 2.0


def test_vote_topk_drops_normalized_unreachable_candidates():
    """Unreachable pairs arrive NORMALIZED (~BIG/(la+lb) ~ 2.5e27, e.g.
    under slope='itakura') — they must not out-vote a single reachable
    candidate (regression: the old BIG/2 liveness threshold let them)."""
    from dsp_asr.pipeline import vote_topk

    top_d = jnp.asarray([[0.5, 2.5e27, 2.5e27]], jnp.float32)
    top_labels = jnp.asarray([[0, 1, 1]], jnp.int32)
    got = vote_topk(top_d, top_labels, n_labels=2)
    assert int(got[0]) == 0


def test_vote_topk_all_dead_row_returns_sentinel():
    """A row whose candidates are ALL unreachable must surface -1, not
    silently elect label 0 (ADVICE round 2); live rows are unaffected."""
    from dsp_asr.pipeline import vote_topk

    top_d = jnp.asarray([[2.5e27, 2.5e27, 2.5e27],
                         [0.5, 0.4, 2.5e27]], jnp.float32)
    top_labels = jnp.asarray([[0, 1, 1], [0, 1, 1]], jnp.int32)
    got = np.asarray(vote_topk(top_d, top_labels, n_labels=2))
    assert got[0] == -1
    assert got[1] == 1


def _itakura_dead_setup():
    """Query 5x longer than every template under slope='itakura' (length
    ratio > max_warp_scale=2) -> every distance unreachable (>= 1e20)."""
    from dsp_asr.config import DtwConfig, PipelineConfig
    from dsp_asr.pipeline import Features

    rng = np.random.default_rng(7)
    q = Features(jnp.asarray(rng.standard_normal((2, 50, 5)), jnp.float32),
                 jnp.asarray([50, 12], jnp.int32))   # row 1 stays reachable
    bank = Features(jnp.asarray(rng.standard_normal((3, 50, 5)), jnp.float32),
                    jnp.asarray([10, 9, 8], jnp.int32))
    ids = jnp.asarray([0, 1, 1], jnp.int32)
    cfg = PipelineConfig(dtw=DtwConfig(band_frac=1.0, max_warp_scale=2.0,
                                       slope="itakura"))
    return q, bank, ids, cfg


def test_classify_features_k1_all_dead_row_returns_sentinel():
    """k=1 must surface -1 on an all-unreachable row exactly like
    vote_topk does, so single-device k=1 agrees with the mesh path
    (ADVICE round 3: plain argmin silently elected template 0)."""
    from dsp_asr import pipeline as pl

    q, bank, ids, cfg = _itakura_dead_setup()
    got, d = pl.classify_features(q, bank, ids, k=1, cfg=cfg)
    d = np.asarray(d)
    assert (d[0] >= 1e20).all() and (d[1] < 1e20).any()
    assert int(got[0]) == -1
    assert int(got[1]) in (0, 1)


def test_classify_features_cascade_k1_all_dead_row_returns_sentinel():
    from dsp_asr import pipeline as pl

    q, bank, ids, cfg = _itakura_dead_setup()
    got, d, _ = pl.classify_features_cascade(q, bank, ids, shortlist=3,
                                             k=1, cfg=cfg)
    d = np.asarray(d)
    assert (d[0] >= 1e20).all() and (d[1] < 1e20).any()
    assert int(got[0]) == -1
    assert int(got[1]) in (0, 1)


def test_recognizer_maps_sentinel_to_no_match():
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer, NO_MATCH

    rec = KnnDtwRecognizer()
    rec.labels = ["a", "b"]
    assert rec._ids_to_labels(np.asarray([1, -1, 0])) == ["b", NO_MATCH, "a"]


def test_initialize_warns_on_failed_autoinit_with_cluster_markers(
        monkeypatch, caplog):
    """Auto-init failure with multi-host env markers present must WARN
    (cluster misconfig degrading to 1 process), not log at INFO
    (ADVICE round 3)."""
    import logging

    import jax

    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h0:1234")

    def boom():
        raise RuntimeError("coordinator unreachable")

    # the package logger sets propagate=False, so capture via a direct
    # handler rather than caplog's root-logger hook
    records = []

    class Sink(logging.Handler):
        def emit(self, record):
            records.append(record)

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    multihost.log.addHandler(Sink())
    try:
        multihost.initialize()
    finally:
        multihost.log.handlers = [h for h in multihost.log.handlers
                                  if not isinstance(h, Sink)]
    assert any(r.levelno == logging.WARNING
               and "misconfiguration" in r.getMessage() for r in records)


def test_initialize_quiet_on_failed_autoinit_without_markers(
        monkeypatch, caplog):
    import logging

    import jax

    monkeypatch.setattr(multihost, "_initialized", False)
    for v in multihost.CLUSTER_MARKERS:
        monkeypatch.delenv(v, raising=False)

    def boom():
        raise RuntimeError("no cluster")

    records = []

    class Sink(logging.Handler):
        def emit(self, record):
            records.append(record)

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    multihost.log.addHandler(Sink())
    try:
        multihost.initialize()
    finally:
        multihost.log.handlers = [h for h in multihost.log.handlers
                                  if not isinstance(h, Sink)]
    assert records   # the INFO fallback line was emitted
    assert not any(r.levelno >= logging.WARNING for r in records)


def test_initialize_explicit_single_process_is_noop():
    """Regression: initialize(num_processes=1) used to probe
    jax.process_count() first, initialising the backend and making the
    subsequent jax.distributed.initialize raise."""
    multihost.initialize(num_processes=1, process_id=0)   # must not raise


def test_make_mesh_rejects_oversubscription():
    """Regression: an axis exceeding the device count rounded the other
    axis to 0 and silently built an empty mesh."""
    import pytest

    from dsp_asr import parallel as par

    with pytest.raises(ValueError):
        par.make_mesh(bank=1024)
    with pytest.raises(ValueError):
        par.make_mesh(data=1024)
