"""Benchmark all five BASELINE.json configs; one JSON line each.

    python bench_all.py                     # on the GPU; refuses without one
    BENCH_PLATFORM=cpu python bench_all.py  # explicit CPU rehearsal

Every config is timed over BENCH_ALL_PASSES (default 3) passes after one
warm pass (bench.timeit_spread: host clock ended by
``jax.block_until_ready``); the JSON line carries value = MEDIAN rate
plus min/max.  The first line names the device.

Configs (BASELINE.json `configs`):
  0. single WAV -> MFCC -> DTW vs 10-digit bank  (latency)
  1. batched 1k utterances x 100 templates        (headline throughput;
     same measurement as bench.py)
  2. streaming chunked front-end                  (real-time factor)
  3. GMM-HMM batched log-space Viterbi decode     (utterances/s)
  4. 35-class kNN-DTW, Speech-Commands-shaped     (synthetic stand-in
     unless SC2_ROOT points at a real checkout; bank sharding is covered
     by tests/test_sharding.py on the CPU mesh — one local chip here)
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp


def emit(**kv):
    print(json.dumps(kv), flush=True)


def main():
    from bench import require_gpu, timeit_spread

    emit(device=require_gpu())
    from dsp_asr.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from dsp_asr import pipeline as pl
    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, synth_word
    from dsp_asr.models import gmm_hmm as gh
    from dsp_asr.ops import frontend as fe
    from dsp_asr.ops import streaming as st

    passes = int(os.environ.get("BENCH_ALL_PASSES", 3))

    def timed(step, args, n_iters, scale, **meta):
        med, lo, hi = timeit_spread(step, args, n_iters=n_iters,
                                    passes=passes)
        # rates invert the dt ordering: fastest pass -> max rate
        emit(value=round(scale / med, 1),
             passes=passes, min=round(scale / hi, 1),
             max=round(scale / lo, 1), **meta)
        return med

    cfg = PipelineConfig()
    mats = fe.make_matrices(cfg.frontend)

    def make_bank(words, per_word):
        sigs = np.stack([synth_word(w, i, max_samples=cfg.max_samples)
                         for w in words for i in range(per_word)])
        ns = np.full(len(sigs), cfg.max_samples, dtype=np.int32)
        ids = np.repeat(np.arange(len(words), dtype=np.int32), per_word)
        bank = pl.extract_features(jnp.asarray(sigs), jnp.asarray(ns), mats, cfg)
        return bank, jnp.asarray(ids)

    # ---- config 0: single-utterance latency --------------------------------
    bank10, ids10 = make_bank(DIGITS, 1)
    x1 = jnp.asarray(synth_word("three", 123)[None])
    n1 = jnp.full(1, cfg.max_samples, dtype=jnp.int32)

    @jax.jit
    def single(x):
        labels, _ = pl.recognize_batch(x, n1, mats,
                                       bank10, ids10, cfg)
        return labels

    med, lo, hi = timeit_spread(single, (x1,), n_iters=16, passes=passes)
    emit(config=0, metric="single_wav_recognize_latency_ms",
         value=round(med * 1e3, 3), passes=passes,
         min=round(lo * 1e3, 3), max=round(hi * 1e3, 3), unit="ms")

    # ---- config 1: headline batched throughput -----------------------------
    bank100, ids100 = make_bank(DIGITS, 10)
    B = 256
    sigs = np.stack([synth_word(DIGITS[i % 10], 1000 + i,
                                max_samples=cfg.max_samples) for i in range(B)])
    xb = jnp.asarray(sigs)
    nb = jnp.full(B, cfg.max_samples, dtype=jnp.int32)

    @jax.jit
    def batched(x):
        labels, _ = pl.recognize_batch(x, nb, mats,
                                       bank100, ids100, cfg)
        return labels

    timed(batched, (xb,), 8, B * 100, config=1,
          metric="mfcc_dtw_alignments_per_sec_per_chip",
          unit="alignments/s/chip")

    # ---- config 2: streaming front-end real-time factor --------------------
    chunk_len = 1600  # 100 ms of audio
    state = st.init_state(cfg.frontend, chunk_len)
    chunk = jnp.asarray(synth_word("five", 7)[:chunk_len])

    @jax.jit
    def stream_step(c, state=state):
        s, out = st.process_chunk(state, c, mats,
                                  cfg.frontend, cfg.vad, chunk_len)
        return out.mfcc

    timed(stream_step, (chunk,), 32, 0.1, config=2,
          metric="streaming_realtime_factor",
          unit="x realtime (100ms chunks)")

    # ---- config 3: GMM-HMM Viterbi decode ----------------------------------
    rng = np.random.default_rng(0)
    W, S, M, F = 10, 5, 3, cfg.frontend.n_feats
    params = gh.HmmParams(
        log_pi=jnp.tile(jnp.asarray([0.0] + [gh.NEG_INF] * (S - 1)), (W, 1)),
        log_a=jnp.tile(gh._lr_log_a(jnp.full((S,), 0.6), S)[None], (W, 1, 1)),
        means=jnp.asarray(rng.standard_normal((W, S, M, F)), dtype=jnp.float32),
        log_var=jnp.zeros((W, S, M, F)),
        log_mix=jnp.full((W, S, M), -np.log(M)),
    )
    feats = pl.extract_features(xb, nb, mats, cfg)

    @jax.jit
    def decode(f):
        return gh.score_words(f, feats.length, params)

    timed(decode, (feats.feats,), 48, B * W, config=3,
          metric="viterbi_decodes_per_sec",
          unit="utterance-word decodes/s/chip")

    # ---- config 4: 35-class kNN-DTW ----------------------------------------
    root = os.environ.get("SC2_ROOT")
    words35 = [f"w{i:02d}" for i in range(35)]
    if root:
        emit(config="4-note",
             note="real SC2 data detected: run `python -m dsp_asr evaluate-sc2 --root ...` for the real-data accuracy/throughput; the line below is the synthetic stand-in")
    bank35, ids35 = make_bank(words35, 3)   # 105 templates, 35 classes

    @jax.jit
    def c35(x):
        labels, _ = pl.recognize_batch(x, nb, mats,
                                       bank35, ids35, cfg)
        return labels

    timed(c35, (xb,), 8, B * int(bank35.feats.shape[0]), config=4,
          metric="sc2_style_35class_alignments_per_sec",
          unit="alignments/s/chip (synthetic 35-class)")

    # ---- bonus: connected-word decoding ------------------------------------
    from dsp_asr.io.dataset import synth_connected

    n_conn, n_words = 64, 3
    clen = 3 * cfg.max_samples
    conn = np.zeros((n_conn, clen), np.float32)
    clens = np.zeros(n_conn, np.int32)
    for i in range(n_conn):
        x = synth_connected([DIGITS[(i + j) % 10] for j in range(n_words)],
                            300 + i)
        m = min(len(x), clen)
        conn[i, :m] = x[:m]
        clens[i] = m
    connj = jnp.asarray(conn)
    clensj = jnp.asarray(clens)

    @jax.jit
    def conn_step(x):
        label_ids, n_segs, _, _ = pl.recognize_connected_batch(
            x, clensj, mats, bank100, ids100,
            n_labels=len(DIGITS), cfg=cfg, max_segments=4)
        return label_ids

    timed(conn_step, (connj,), 8, n_conn * n_words, config="connected",
          metric="connected_words_per_sec_per_chip",
          unit="words/s/chip (multi-segment split + classify, 3-word clips)")

    # ---- bonus: connected-word decoding, level-building DP ------------------
    from dsp_asr.ops.level_building import level_build

    t_rec = max(1, 1 + (clen - cfg.frontend.frame_len) // cfg.frontend.hop_len)
    conn_feats = pl.extract_recording_features(connj, clensj, mats, cfg,
                                               t_rec)

    @jax.jit
    def level_step(f):
        costs, words, starts = level_build(
            f, conn_feats.length, bank100.feats,
            bank100.length, max_levels=4, word_penalty=0.0)
        return costs

    timed(level_step, (conn_feats.feats,), 4, n_conn * n_words,
          config="connected-level",
          metric="level_building_words_per_sec_per_chip",
          unit="words/s/chip (gapless level-building DP, 3-word clips, "
               "100-template bank)")

    # ---- bonus: keyword spotting (subsequence DTW) --------------------------
    # `spot` = the production entry (subseq_dtw_batch, jitted scan);
    # `spot-scan` = the same XLA row scan called unjitted inside the step
    from dsp_asr.ops.spot import subseq_dtw_batch, subseq_dtw_batch_impl

    @jax.jit
    def spot_step(f):
        norm, _ = subseq_dtw_batch(f,
                                   conn_feats.length,
                                   bank100.feats, bank100.length)
        return norm

    audio_s = float(np.sum(clens)) / cfg.frontend.sample_rate
    timed(spot_step, (conn_feats.feats,), 4, audio_s, config="spot",
          metric="spotting_audio_seconds_per_sec_per_chip",
          unit="audio-s/s/chip (100-template subsequence match, witnesses, "
               "production routing)")

    @jax.jit
    def spot_scan_step(f):
        norm, _ = subseq_dtw_batch_impl(f,
                                        conn_feats.length,
                                        bank100.feats, bank100.length)
        return norm

    timed(spot_scan_step, (conn_feats.feats,), 4, audio_s, config="spot-scan",
          metric="spotting_scan_audio_seconds_per_sec_per_chip",
          unit="audio-s/s/chip (100-template subsequence XLA row scan)")

    # ---- bonus: HMM spotting scan (cascade stage 1) --------------------------
    # the parametric keyword/filler scan over the same streams: O(W*S)
    # elementwise max-plus per frame vs the DTW scan's O(K*U) cells —
    # this rate vs config "spot" is the cascade's cheap-front margin
    # (stage 2 reranks only candidate windows; models/spotter.py)
    from dsp_asr.ops.spot_hmm import spot_hmm_impl

    ubm = (jnp.asarray(rng.standard_normal((M, F)), dtype=jnp.float32),
           jnp.zeros((M, F)), jnp.full((M,), -np.log(M)))

    @jax.jit
    def spot_hmm_step(f):
        llr, _ = spot_hmm_impl(f, conn_feats.length,
                               params, ubm)
        return llr

    timed(spot_hmm_step, (conn_feats.feats,), 8, audio_s,
          config="spot-hmm",
          metric="hmm_spotting_audio_seconds_per_sec_per_chip",
          unit="audio-s/s/chip (10-word keyword/filler scan, "
               "cascade stage 1)")

    # ---- bonus: linear-time-warp fast matcher ------------------------------
    @jax.jit
    def ltw(x):
        f = pl.extract_features(x, nb, mats, cfg)
        labels, _ = pl.classify_features_ltw(f, bank100, ids100, 64)
        return labels

    timed(ltw, (xb,), 16, B * 100, config="ltw",
          metric="ltw_comparisons_per_sec_per_chip",
          unit="comparisons/s/chip (fast matcher)")


if __name__ == "__main__":
    main()
