"""GMM-HMM model tests: emission GEMM parity, training convergence,
recognition accuracy, checkpoint round-trip."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsp_asr.config import HmmConfig, PipelineConfig
from dsp_asr.models import gmm_hmm as gh
from dsp_asr.io.dataset import make_corpus, synth_word

HCFG = HmmConfig(n_states=4, n_mix=2, n_iter=5)


def test_gmm_loglik_matches_naive():
    """GEMM-expanded Gaussian log-lik == direct formula."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    means = rng.standard_normal((6, 5)).astype(np.float32)
    log_var = (0.2 * rng.standard_normal((6, 5))).astype(np.float32)
    got = np.asarray(gh.gmm_loglik_flat(jnp.asarray(x), jnp.asarray(means),
                                        jnp.asarray(log_var)))
    var = np.exp(log_var)
    want = np.stack([
        -0.5 * (((x - means[k]) ** 2 / var[k]).sum(-1)
                + log_var[k].sum() + 5 * np.log(2 * np.pi))
        for k in range(6)
    ], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_emission_logb_normalises():
    """logB with a single mixture equals the Gaussian; mixture weights sum to 1."""
    rng = np.random.default_rng(1)
    s, m, f = 3, 1, 4
    params = gh.HmmParams(
        log_pi=jnp.zeros(s),
        log_a=jnp.zeros((s, s)),
        means=jnp.asarray(rng.standard_normal((s, m, f)), dtype=jnp.float32),
        log_var=jnp.zeros((s, m, f)),
        log_mix=jnp.zeros((s, m)),
    )
    x = jnp.asarray(rng.standard_normal((2, f)), dtype=jnp.float32)
    got = np.asarray(gh.emission_logb(x, params))
    assert got.shape == (2, s)


def test_segmental_em_increases_likelihood():
    rng = np.random.default_rng(2)
    # two-phase synthetic sequences: distributions shift halfway
    n, t, f = 6, 40, 8
    feats = np.zeros((n, t, f), dtype=np.float32)
    feats[:, :20] = rng.standard_normal((n, 20, f)) + 2.0
    feats[:, 20:] = rng.standard_normal((n, 20, f)) - 2.0
    lengths = np.full(n, t, dtype=np.int32)

    key = jax.random.PRNGKey(0)
    params = gh.init_params(jnp.asarray(feats), jnp.asarray(lengths), HCFG, key)
    lls = []
    for _ in range(6):
        params, ll = gh._em_iteration(jnp.asarray(feats), jnp.asarray(lengths),
                                      params, HCFG)
        lls.append(float(ll))
    assert lls[-1] > lls[0]          # training improves alignment likelihood
    assert np.isfinite(lls).all()


def test_hmm_recognizer_end_to_end(tmp_path):
    labels = ["zero", "one", "two"]
    train = make_corpus(labels, n_per_word=6, seed=0)
    test = {lab: [v for v in make_corpus([lab], 3, seed=9)[lab]] for lab in labels}

    rec = gh.GmmHmmRecognizer(PipelineConfig(), HCFG)
    rec.fit(train)
    result = rec.evaluate(test)
    assert result["n"] == 9
    assert result["accuracy"] >= 8 / 9          # allow one miss

    path = str(tmp_path / "hmm.npz")
    rec.save(path)
    loaded = gh.GmmHmmRecognizer.load(path, PipelineConfig(), HCFG)
    x = test["one"][0]
    assert loaded.recognize(x) == rec.recognize(x)


def test_score_words_batch_shape():
    rng = np.random.default_rng(3)
    w, s, m, f = 4, 3, 2, 6
    params = gh.HmmParams(
        log_pi=jnp.tile(jnp.asarray([0.0] + [gh.NEG_INF] * (s - 1)), (w, 1)),
        log_a=jnp.tile(gh._lr_log_a(jnp.full((s,), 0.6), s)[None], (w, 1, 1)),
        means=jnp.asarray(rng.standard_normal((w, s, m, f)), dtype=jnp.float32),
        log_var=jnp.zeros((w, s, m, f)),
        log_mix=jnp.full((w, s, m), -np.log(m)),
    )
    feats = jnp.asarray(rng.standard_normal((5, 20, f)), dtype=jnp.float32)
    lengths = jnp.asarray(rng.integers(5, 21, size=5).astype(np.int32))
    scores = gh.score_words(feats, lengths, params)
    assert scores.shape == (5, w)
    assert np.isfinite(np.asarray(scores)).all()


def test_sharded_em_matches_single_device():
    """psum-reduced distributed EM == single-device EM (SURVEY.md §4.4)."""
    import jax
    from dsp_asr import parallel as par
    from dsp_asr.parallel.em import em_step_sharded

    rng = np.random.default_rng(7)
    n, t, f = 8, 24, 6
    feats = rng.standard_normal((n, t, f)).astype(np.float32)
    lengths = rng.integers(10, t + 1, size=n).astype(np.int32)
    params = gh.init_params(jnp.asarray(feats), jnp.asarray(lengths), HCFG,
                            jax.random.PRNGKey(0))

    want, want_ll = gh._em_iteration(jnp.asarray(feats), jnp.asarray(lengths),
                                     params, HCFG)

    mesh = par.make_mesh(4, 2)
    fd, ld = par.shard_queries(mesh, feats, lengths)
    pd = jax.tree.map(lambda a: par.replicate(mesh, np.asarray(a)), params)
    got, got_ll = em_step_sharded(mesh, fd, ld, pd, HCFG)

    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)
    for name in gh.HmmParams._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            rtol=1e-4, atol=1e-4, err_msg=name)


def test_forward_backward_consistency():
    """sum_s alpha[t,s]+beta[t,s] == loglik at every valid t; gamma sums to 1."""
    import jax
    rng = np.random.default_rng(10)
    s, t, L = 4, 12, 9
    log_pi = np.log(rng.dirichlet(np.ones(s))).astype(np.float32)
    log_a = np.log(rng.dirichlet(np.ones(s), size=s)).astype(np.float32)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    alphas, betas, ll = gh._forward_backward(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b),
        jnp.asarray(L))
    alphas, betas = np.asarray(alphas), np.asarray(betas)
    # parity with the golden forward algorithm on the truncated sequence
    want_ll = float(__import__("dsp_asr.golden.hmm", fromlist=["forward_log"])
                    .forward_log(log_pi.astype(np.float64),
                                 log_a.astype(np.float64),
                                 log_b[:L].astype(np.float64)))
    np.testing.assert_allclose(float(ll), want_ll, rtol=1e-4)
    for ti in range(L):
        tot = np.logaddexp.reduce(alphas[ti] + betas[ti])
        np.testing.assert_allclose(tot, float(ll), rtol=1e-4)
        gamma = np.exp(alphas[ti] + betas[ti] - float(ll))
        np.testing.assert_allclose(gamma.sum(), 1.0, rtol=1e-4)


def test_baum_welch_increases_likelihood_and_recognizes():
    labels = ["zero", "one", "two"]
    from dsp_asr.io.dataset import make_corpus, synth_word
    cfg_bw = HmmConfig(n_states=4, n_mix=2, n_iter=5, train_mode="baum_welch")
    train = make_corpus(labels, n_per_word=5, seed=0)
    from dsp_asr.config import PipelineConfig
    rec = gh.GmmHmmRecognizer(PipelineConfig(), cfg_bw)

    # likelihood monotonicity on one word
    feats = rec.extract(train["zero"])
    import jax
    params = gh.init_params(feats.feats, feats.length, cfg_bw,
                            jax.random.PRNGKey(0))
    lls = []
    for _ in range(5):
        params, ll = gh._em_iteration(feats.feats, feats.length, params, cfg_bw)
        lls.append(float(ll))
    assert lls[-1] > lls[0]
    assert np.isfinite(lls).all()

    rec.fit(train)
    test = {lab: make_corpus([lab], 2, seed=50)[lab] for lab in labels}
    assert rec.evaluate(test)["accuracy"] >= 5 / 6


def test_fit_with_mesh_matches_single_device():
    """GmmHmmRecognizer.fit(mesh=...) == fit() parameters (ragged N)."""
    from dsp_asr import parallel as par
    from dsp_asr.io.dataset import make_corpus, synth_word
    from dsp_asr.config import PipelineConfig

    corpus = make_corpus(["zero", "one"], n_per_word=5, seed=0)  # 5 % 4 != 0
    plain = gh.GmmHmmRecognizer(PipelineConfig(), HCFG)
    plain.fit(corpus)
    mesh = par.make_mesh(4, 2)
    sharded = gh.GmmHmmRecognizer(PipelineConfig(), HCFG)
    sharded.fit(corpus, mesh=mesh)
    # psum vs single-device summation order drifts ~0.4% through 5 EM
    # iterations (f32); require near-parity + identical predictions
    for name in gh.HmmParams._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(sharded.params, name)),
            np.asarray(getattr(plain.params, name)),
            rtol=2e-2, atol=1e-2, err_msg=name)
    from dsp_asr.io.dataset import synth_word
    probes = [synth_word(w, 77 + i) for i, w in enumerate(["zero", "one"])]
    assert sharded.classify_batch(probes) == plain.classify_batch(probes)


def test_batched_fit_matches_per_word_loop():
    """fit_words_batched (one program) == the per-word host loop (same
    seeds): round-1 review item 'batch per-word HMM training'."""
    import dataclasses

    corpus = {lab: [synth_word(lab, i) for i in range(3)]
              for lab in ["zero", "one", "two"]}
    hmm = HmmConfig(n_states=3, n_mix=2, n_iter=3)
    rec_loop = gh.GmmHmmRecognizer(PipelineConfig(), hmm)
    rec_loop.fit(corpus, batched=False)
    rec_batch = gh.GmmHmmRecognizer(PipelineConfig(), hmm)
    rec_batch.fit(corpus)
    assert rec_loop.labels == rec_batch.labels
    for f in rec_loop.params._fields:
        a = np.asarray(getattr(rec_loop.params, f))
        b = np.asarray(getattr(rec_batch.params, f))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=f)
    # and both decode the training corpus identically
    sigs = [x for xs in corpus.values() for x in xs]
    assert rec_loop.classify_batch(sigs) == rec_batch.classify_batch(sigs)


def test_batched_fit_on_mesh():
    """Words x utterances sharded over a ('data','bank') mesh."""
    from dsp_asr import parallel as par

    corpus = {lab: [synth_word(lab, i) for i in range(2)]
              for lab in ["zero", "one", "two", "three"]}
    hmm = HmmConfig(n_states=3, n_mix=2, n_iter=2)
    plain = gh.GmmHmmRecognizer(PipelineConfig(), hmm)
    plain.fit(corpus)
    meshed = gh.GmmHmmRecognizer(PipelineConfig(), hmm)
    meshed.fit(corpus, mesh=par.make_mesh(2, 4))
    for f in plain.params._fields:
        # partitioned matmul/psum reassociation: ~1e-3 f32 noise
        np.testing.assert_allclose(np.asarray(getattr(plain.params, f)),
                                   np.asarray(getattr(meshed.params, f)),
                                   rtol=5e-3, atol=5e-3, err_msg=f)


def test_map_adaptation_helps_one_shot():
    """UBM-MAP adaptation must beat (or match) plain ML in the 1-shot
    regime — the classical few-shot regulariser (ROADMAP item 7)."""
    labels = ["zero", "one", "two", "three", "four"]
    train = {lab: [synth_word(lab, 0)] for lab in labels}          # 1-shot
    test = {lab: [synth_word(lab, 50 + i) for i in range(3)] for lab in labels}

    ml = gh.GmmHmmRecognizer(PipelineConfig(),
                             HmmConfig(n_states=4, n_mix=2, n_iter=5))
    ml.fit(train)
    acc_ml = ml.evaluate(test)["accuracy"]

    mapped = gh.GmmHmmRecognizer(
        PipelineConfig(),
        HmmConfig(n_states=4, n_mix=2, n_iter=5, map_tau=8.0))
    mapped.fit(train)
    acc_map = mapped.evaluate(test)["accuracy"]
    assert acc_map >= acc_ml, (acc_map, acc_ml)
    assert acc_map >= 0.6
