#!/usr/bin/env python3
"""Smoke test of the recognizer on a GPU, through the entry points a user calls.

    python chip_smoke.py          # one GPU: every phase below but `four`
    python chip_smoke.py --four   # four GPUs: only the sharded paths,
                                  # each against the same call on one device

One process holds the card(s) throughout; nothing here starts a second
JAX process.  Each phase prints one ``[phase] ...`` line:

  device     platform, device kind and count; card name and power limit
  cli        make-corpus, enroll (100 templates), evaluate (1,024
             utterances in chunks of 256) and serve, all through
             dsp_asr.cli.main in this process
  timing     cold compile, steady seconds per chunk, peak device bytes
             and memory_analysis() of recognize_batch at the chunk shape
  golden     4 queries x the 100-template bank == golden/pipeline.recognize
  precision  the recognizer's labels == the HIGHEST-precision XLA scan's
             on all 1,024 queries; DEFAULT-vs-HIGHEST label flips and
             the precision bench.py times at
  kernel     fused banded DTW kernel vs the XLA scan, end to end through
             recognize_batch at B=256/K=100 and B=1/K=10
  hmm, stream, spot, level
             the secondary paths at their bench_all.py shapes, each
             against its reference on a small slice
  tests      ``pytest -m gpu`` (tests/test_gpu_device.py), in process
  four       (--four only) recognize_sharded, level_build_sharded,
             spot_sharded and em_step_sharded on four cards vs one

Without a GPU, or when any phase fails, the script exits non-zero and
prints no result.  Otherwise the last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

ONE_CARD_PHASES = ("cli", "timing", "golden", "precision", "kernel", "hmm",
                   "stream", "spot", "level", "tests")
FOUR_CARD_PHASES = ("four",)
# kernel vs scan distances: both f32, but the kernel sums (a - b)^2 over
# features while the scan expands |a|^2 + |b|^2 - 2ab, so the local
# costs round differently and the DP sums them in another order
KERNEL_RTOL = 1e-4


def phases_for(four: bool) -> tuple[str, ...]:
    """The phases one run makes: ``--four`` runs only the sharded one."""
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def result_line(device: dict) -> str:
    """The last line of a run in which every phase passed."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def card_line() -> str:
    """Name and power limit of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc={out.returncode}): "
                           f"{out.stderr.strip()}")
    return out.stdout.strip()


def device_identity() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def seconds(fn, *args, n: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` after a warm call, each call
    ended by ``jax.block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def labels_of(ids, labels: list[str]) -> list[str]:
    return [labels[i] if i >= 0 else "<none>" for i in map(int, ids)]


# ------------------------------------------------------------ main path
@dataclasses.dataclass
class MainPath:
    """What the cli phase leaves for the phases that check it."""

    bank_path: str
    train: dict           # label -> template signals, enrollment order
    queries: list         # evaluation signals
    truth: list           # their labels
    serve_paths: list


def phase_cli(work: str, per_word: int = 10, n_eval: int = 1024,
              n_serve: int = 4) -> MainPath:
    from dsp_asr import cli
    from dsp_asr.config import PipelineConfig

    bank_dir = os.path.join(work, "bank_corpus")
    eval_dir = os.path.join(work, "eval_corpus")
    bank_path = os.path.join(work, "bank.npz")
    cli.main(["make-corpus", "--out", bank_dir, "--n", str(per_word)])
    cli.main(["make-corpus", "--out", eval_dir,
              "--n", str(-(-n_eval // 10))])
    test_dir = os.path.join(eval_dir, "test")
    words = sorted(os.listdir(test_dir))
    # trim the evaluation split to exactly n_eval utterances
    extra = sum(len(os.listdir(os.path.join(test_dir, w)))
                for w in words) - n_eval
    for w in words[:extra]:
        d = os.path.join(test_dir, w)
        os.remove(os.path.join(d, sorted(os.listdir(d))[-1]))

    cli.main(["enroll", "--corpus", os.path.join(bank_dir, "train"),
              "--bank", bank_path])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["evaluate", "--corpus", test_dir, "--bank", bank_path])
    m = re.search(r"accuracy: ([0-9.]+) \((\d+) utterances\)", out.getvalue())
    if not m or int(m.group(2)) != n_eval:
        raise AssertionError(f"evaluate printed no accuracy over {n_eval} "
                             f"utterances:\n{out.getvalue()[-2000:]}")
    accuracy = float(m.group(1))

    sr = PipelineConfig().frontend.sample_rate
    train = cli._load_corpus(os.path.join(bank_dir, "train"), sr)
    test = cli._load_corpus(test_dir, sr)
    queries, truth = [], []
    for lab, xs in test.items():
        queries.extend(xs)
        truth.extend([lab] * len(xs))
    serve_paths = [os.path.join(test_dir, w, sorted(os.listdir(
        os.path.join(test_dir, w)))[0]) for w in words[:n_serve]]

    out, stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO("".join(p + "\n" for p in serve_paths))
    try:
        with contextlib.redirect_stdout(out):
            cli.main(["serve", "--bank", bank_path])
    finally:
        sys.stdin = stdin
    lines = out.getvalue().splitlines()
    rows = [ln.split("\t") for ln in lines[1:]]
    if lines[:1] != ["ready"] or len(rows) != n_serve or any(
            len(r) != 3 or r[1].startswith("ERROR") for r in rows):
        raise AssertionError(f"serve answered:\n{out.getvalue()}")
    served = {r[0]: r[1] for r in rows}
    say("cli", f"enrolled {sum(map(len, train.values()))} templates; "
               f"evaluate accuracy {accuracy:.4f} over {len(queries)} "
               f"utterances; serve answered {len(rows)} requests "
               f"({', '.join(f'{os.path.basename(p)}->{served[p]}' for p in serve_paths)}; "
               f"ms {[float(r[2]) for r in rows]})")
    return MainPath(bank_path, train, queries, truth, serve_paths)


def load_recognizer(main: MainPath):
    from dsp_asr.config import PipelineConfig
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    return KnnDtwRecognizer.load(main.bank_path, PipelineConfig())


def chunks_of(main: MainPath, chunk: int, max_samples: int):
    from dsp_asr import pipeline as pl

    qs = list(main.queries)
    qs += qs[-1:] * (-len(qs) % chunk)        # whole chunks, one program
    return [pl.pad_signals(qs[lo:lo + chunk], max_samples)
            for lo in range(0, len(qs), chunk)]


def phase_timing(main: MainPath, chunk: int = 256, passes: int = 5) -> None:
    import jax

    from dsp_asr import pipeline as pl

    rec = load_recognizer(main)
    bank, ids = rec.device_bank()
    chunks = chunks_of(main, chunk, rec.cfg.max_samples)
    t0 = time.perf_counter()
    compiled = pl.recognize_batch.lower(
        *chunks[0], rec.mats, bank, ids, cfg=rec.cfg).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready([compiled(x, n, rec.mats, bank, ids)
                           for x, n in chunks])
    dts = []
    for _ in range(passes):
        t0 = time.perf_counter()
        jax.block_until_ready([compiled(x, n, rec.mats, bank, ids)
                               for x, n in chunks])
        dts.append((time.perf_counter() - t0) / len(chunks))
    stats = jax.devices()[0].memory_stats() or {}
    say("timing", f"recognize_batch B={chunk} K={rec.n_templates}: compile "
                  f"{compile_s:.2f} s (persistent cache: "
                  f"{os.environ.get('JAX_COMPILATION_CACHE_DIR') or 'repo .jax_cache'}); "
                  f"steady {float(np.median(dts)):.6f} s/chunk (median of "
                  f"{passes} passes over {len(chunks)} chunks, min "
                  f"{min(dts):.6f}, max {max(dts):.6f}); peak device bytes "
                  f"{stats.get('peak_bytes_in_use')}")
    say("timing", f"memory_analysis: {compiled.memory_analysis()}")


def phase_golden(main: MainPath, n_queries: int = 4) -> None:
    from dsp_asr.golden import pipeline as gp

    rec = load_recognizer(main)
    # one query of each of the first n_queries words
    picks = [main.truth.index(w) for w in sorted(set(main.truth))][:n_queries]
    xs = [main.queries[i] for i in picks]
    got, dists = rec.classify_batch(xs, return_distances=True)
    gbank = [(lab, gp.extract_features(np.asarray(x, np.float64), rec.cfg)[0])
             for lab in rec.labels for x in main.train[lab]]
    want, worst = [], 0.0
    for x, d in zip(xs, dists):
        lab, gd = gp.recognize(np.asarray(x, np.float64), gbank, rec.cfg)
        want.append(lab)
        gd = np.asarray(gd)
        fin = gd < 1e20
        worst = max(worst, float(np.max(np.abs(d[fin] - gd[fin]) / gd[fin])))
    say("golden", f"{len(xs)} queries x {len(gbank)} templates: device "
                  f"{got} golden {want}; max rel distance diff {worst:.2e}")
    if got != want:
        raise AssertionError(f"labels differ from golden: {got} vs {want}")
    if worst > 1e-3:       # f32 device front-end vs the float64 golden
        raise AssertionError(f"distances differ from golden by {worst:.2e}")


def phase_precision(main: MainPath, chunk: int = 256) -> str:
    """Labels at the shipped settings vs the HIGHEST-precision scan."""
    import jax

    import bench
    from dsp_asr import pipeline as pl

    rec = load_recognizer(main)
    bank, ids = rec.device_bank()
    cfg_scan = dataclasses.replace(
        rec.cfg, dtw=dataclasses.replace(rec.cfg.dtw, impl="scan"))
    hi, lo = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
    shipped = rec.classify_batch(main.queries, chunk=chunk)
    scan_hi, default = [], []
    for x, n in chunks_of(main, chunk, rec.cfg.max_samples):
        scan_hi += labels_of(pl.recognize_batch(
            x, n, rec.mats, bank, ids, cfg_scan, hi)[0], rec.labels)
        default += labels_of(pl.recognize_batch(
            x, n, rec.mats, bank, ids, rec.cfg, lo)[0], rec.labels)
    n = len(main.queries)
    scan_hi, default = scan_hi[:n], default[:n]
    differ = sum(a != b for a, b in zip(shipped, scan_hi))
    flips = sum(a != b for a, b in zip(default, scan_hi))
    decided = "highest" if flips else "default"
    say("precision", f"recognizer (HIGHEST front-end, {pl.dtw_impl(rec.cfg.dtw, chunk, rec.n_templates, rec.cfg.max_frames, rec.cfg.max_frames)} DTW) "
                     f"vs HIGHEST scan: {differ}/{n} labels differ; "
                     f"DEFAULT vs HIGHEST: {flips}/{n} label flips -> "
                     f"{decided.upper()} on this card; bench.py times at "
                     f"{bench.PRECISION.upper()}")
    if differ:
        raise AssertionError(f"{differ} labels differ from the HIGHEST scan")
    if bench.PRECISION != decided:
        raise AssertionError(f"bench.PRECISION is {bench.PRECISION!r} but "
                             f"{flips} DEFAULT labels flip: use {decided!r}")
    return decided


def _dtw_check(d_kernel, d_scan) -> tuple[float, int]:
    """(max rel diff on finite values, argmin differences off near-ties)."""
    d_kernel, d_scan = np.asarray(d_kernel), np.asarray(d_scan)
    fin = d_scan < 1e20
    if not np.array_equal(fin, d_kernel < 1e20):
        raise AssertionError("kernel and scan disagree on dead pairs")
    rel = float(np.max(np.abs(d_kernel[fin] - d_scan[fin]) / d_scan[fin])) \
        if fin.any() else 0.0
    srt = np.sort(np.where(fin, d_scan, np.inf), axis=1)
    near_tie = (srt[:, 1] - srt[:, 0]) <= KERNEL_RTOL * srt[:, 0] \
        if d_scan.shape[1] > 1 else np.zeros(len(d_scan), bool)
    off = (d_kernel.argmin(1) != d_scan.argmin(1)) & ~near_tie
    return rel, int(off.sum())


def phase_kernel(main: MainPath, shapes=((256, 100), (1, 10)),
                 interpret: bool = False) -> None:
    """Kernel vs scan, end to end through recognize_batch, per shape."""
    import jax
    import jax.numpy as jnp

    import bench
    from dsp_asr import pipeline as pl
    from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded
    from dsp_asr.ops import dtw as jdtw

    rec = load_recognizer(main)
    bank, ids = rec.device_bank()
    prec = {"default": jax.lax.Precision.DEFAULT,
            "highest": jax.lax.Precision.HIGHEST}[bench.PRECISION]
    first = [rec._bank_label_ids.index(i) for i in range(len(rec.labels))]
    for slope in (None, "itakura"):
        base = dataclasses.replace(
            rec.cfg, dtw=dataclasses.replace(rec.cfg.dtw, slope=slope))
        for b, k in shapes:
            sel = jnp.asarray(first if k == len(first) else np.arange(k))
            bk = pl.Features(bank.feats[sel], bank.length[sel])
            bids = ids[sel]
            x, n = pl.pad_signals(main.queries[:b], rec.cfg.max_samples)
            feats = pl.extract_features(x, n, rec.mats, rec.cfg)
            d_k = dtw_batch_fused_banded(feats.feats, feats.length, bk.feats,
                                         bk.length, base.dtw,
                                         interpret=interpret)
            d_s = jdtw.dtw_batch(feats.feats, feats.length, bk.feats,
                                 bk.length, base.dtw)
            rel, off = _dtw_check(d_k, d_s)
            times = {}
            if not interpret:
                for impl in ("fused_banded", "scan"):
                    c = dataclasses.replace(
                        base, dtw=dataclasses.replace(base.dtw, impl=impl))
                    times[impl] = seconds(
                        lambda: pl.recognize_batch(x, n, rec.mats, bk, bids,
                                                   c, prec))
            routed = pl.dtw_impl(base.dtw, b, k, rec.cfg.max_frames,
                                 rec.cfg.max_frames)
            say("kernel", f"slope={slope} B={b} K={k}: recognize_batch "
                          f"kernel {times.get('fused_banded', 0) * 1e3:.3f} ms"
                          f" vs scan {times.get('scan', 0) * 1e3:.3f} ms "
                          f"({bench.PRECISION}); max rel distance diff "
                          f"{rel:.2e}; argmin differences off near-ties "
                          f"{off}; auto routes to {routed}")
            if rel > KERNEL_RTOL or off:
                raise AssertionError("kernel distances disagree with the scan")
            # the routed implementation must be the faster one here (5%
            # allowance for the run-to-run spread of a millisecond timing)
            if times and times[routed] > 1.05 * min(times.values()):
                raise AssertionError(f"auto routes to {routed}, which is "
                                     f"slower here: {times}")


# ------------------------------------------------------- secondary paths
def phase_hmm(main: MainPath, n_utts: int = 256, n_check: int = 2) -> None:
    """Config 3: batched GMM-HMM Viterbi vs golden/hmm.viterbi_log."""
    import jax
    import jax.numpy as jnp

    from dsp_asr import golden
    from dsp_asr import pipeline as pl
    from dsp_asr.models import gmm_hmm as gh

    rec = load_recognizer(main)
    rng = np.random.default_rng(0)
    w, s, m, f = 10, 5, 3, rec.cfg.frontend.n_feats
    params = gh.HmmParams(
        log_pi=jnp.tile(jnp.asarray([0.0] + [gh.NEG_INF] * (s - 1)), (w, 1)),
        log_a=jnp.tile(gh._lr_log_a(jnp.full((s,), 0.6), s)[None], (w, 1, 1)),
        means=jnp.asarray(rng.standard_normal((w, s, m, f)), jnp.float32),
        log_var=jnp.zeros((w, s, m, f)),
        log_mix=jnp.full((w, s, m), -np.log(m)),
    )
    x, n = pl.pad_signals(main.queries[:n_utts], rec.cfg.max_samples)
    feats = pl.extract_features(x, n, rec.mats, rec.cfg)
    dt = seconds(gh.score_words, feats.feats, feats.length, params)
    got = np.asarray(gh.score_words(feats.feats, feats.length, params))
    worst = 0.0
    for i in range(n_check):
        ln = int(feats.length[i])
        logb = np.asarray(gh.emission_logb(feats.feats[i, :ln], params))
        for j in range(w):
            want, _ = golden.viterbi_log(np.asarray(params.log_pi[j]),
                                         np.asarray(params.log_a[j]),
                                         logb[:, j])
            worst = max(worst, abs(got[i, j] - want) / abs(want))
    say("hmm", f"score_words B={x.shape[0]} W={w}: {dt * 1e3:.3f} ms "
               f"({x.shape[0] * w / dt:.1f} decodes/s); max rel diff vs "
               f"golden Viterbi on {n_check} utterances {worst:.2e} "
               f"({jax.devices()[0].platform})")
    if not np.isfinite(got).all() or worst > 1e-4:
        raise AssertionError("Viterbi scores disagree with golden")


def phase_stream(main: MainPath, chunk_len: int = 1600) -> None:
    """Config 2: one stream of 100 ms chunks vs the golden offline MFCC."""
    import jax
    import jax.numpy as jnp

    from dsp_asr import golden
    from dsp_asr.ops import streaming as st

    rec = load_recognizer(main)
    fcfg = rec.cfg.frontend
    x = np.asarray(main.queries[0], np.float32)
    state = st.init_state(fcfg, chunk_len)
    got, dts = [], []
    for c in range(len(x) // chunk_len):
        t0 = time.perf_counter()
        state, out = st.process_chunk(
            state, jnp.asarray(x[c * chunk_len:(c + 1) * chunk_len]),
            rec.mats, fcfg, rec.cfg.vad, chunk_len)
        jax.block_until_ready(out)
        dts.append(time.perf_counter() - t0)
        got.append(np.asarray(out.mfcc)[np.asarray(out.frame_valid)])
    got = np.concatenate(got)
    want = golden.mfcc(x.astype(np.float64), fcfg)[: got.shape[0]]
    err = float(np.max(np.abs(got - want)))
    steady = float(np.median(dts[1:])) if len(dts) > 1 else dts[0]
    say("stream", f"{len(dts)} chunks of {chunk_len} samples: median "
                  f"{steady * 1e3:.3f} ms/chunk (real-time factor "
                  f"{chunk_len / fcfg.sample_rate / steady:.1f}x); "
                  f"{got.shape[0]} frames, max abs diff vs golden MFCC "
                  f"{err:.2e}")
    # same tolerance as tests/test_frontend.py's golden MFCC checks
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def connected_features(rec, n_conn: int, n_words: int = 3):
    """bench_all.py's connected-word recordings, as device features."""
    import jax.numpy as jnp

    from dsp_asr import pipeline as pl
    from dsp_asr.io.dataset import DIGITS, synth_connected

    clen = n_words * rec.cfg.max_samples
    conn = np.zeros((n_conn, clen), np.float32)
    clens = np.zeros(n_conn, np.int32)
    for i in range(n_conn):
        x = synth_connected([DIGITS[(i + j) % 10] for j in range(n_words)],
                            300 + i)
        m = min(len(x), clen)
        conn[i, :m] = x[:m]
        clens[i] = m
    fr = rec.cfg.frontend
    t_rec = max(1, 1 + (clen - fr.frame_len) // fr.hop_len)
    return pl.extract_recording_features(jnp.asarray(conn),
                                         jnp.asarray(clens), rec.mats,
                                         rec.cfg, t_rec)


def phase_spot(main: MainPath, n_conn: int = 64, n_check: int = 3) -> None:
    """Subsequence-DTW spotting scan vs golden/spot.subseq_dtw."""
    from dsp_asr.golden import spot as gs
    from dsp_asr.ops.spot import subseq_dtw_batch

    rec = load_recognizer(main)
    bank, _ = rec.device_bank()
    feats = connected_features(rec, n_conn)
    dt = seconds(subseq_dtw_batch, feats.feats, feats.length, bank.feats,
                 bank.length)
    norm, start = (np.asarray(a) for a in subseq_dtw_batch(
        feats.feats, feats.length, bank.feats, bank.length))
    sl = int(feats.length[0])
    worst = 0.0
    for v in range(n_check):
        bl = int(bank.length[v])
        g_norm, g_start = gs.subseq_dtw(np.asarray(bank.feats[v, :bl]),
                                        np.asarray(feats.feats[0, :sl]))
        np.testing.assert_array_equal(start[0, v, :sl], g_start)
        np.testing.assert_allclose(norm[0, v, :sl], g_norm, rtol=2e-4,
                                   atol=1e-5)
        worst = max(worst, float(np.max(np.abs(norm[0, v, :sl] - g_norm)
                                        / np.abs(g_norm))))
    say("spot", f"subseq_dtw_batch {n_conn} streams x {bank.feats.shape[0]} "
                f"templates, T_rec={feats.feats.shape[1]}: {dt * 1e3:.3f} ms; "
                f"{n_check} pairs vs golden: starts equal, max rel diff "
                f"{worst:.2e}")


def phase_level(main: MainPath, n_conn: int = 64, n_templates: int = 5,
                n_frames: int = 120) -> None:
    """Level-building connected decode vs golden/level_building."""
    import jax.numpy as jnp

    from dsp_asr.golden import level_building as gl
    from dsp_asr.ops.level_building import level_build

    rec = load_recognizer(main)
    bank, _ = rec.device_bank()
    feats = connected_features(rec, n_conn)
    dt = seconds(lambda f: level_build(f, feats.length, bank.feats,
                                       bank.length, max_levels=4,
                                       word_penalty=0.0)[0], feats.feats)
    # the slice: one recording's first n_frames against n_templates
    q = feats.feats[:1, :n_frames]
    lens = jnp.minimum(feats.length[:1], n_frames)
    costs, words, starts = (np.asarray(a)[0] for a in level_build(
        q, lens, bank.feats[:n_templates], bank.length[:n_templates],
        max_levels=4, word_penalty=0.3))
    t = int(lens[0])
    templates = [np.asarray(bank.feats[v, :int(bank.length[v])])
                 for v in range(n_templates)]
    rc, rw, rs = gl.level_build_ref(np.asarray(q[0, :t]), templates, 4, 0.3)
    live = rc < gl.BIG / 2
    np.testing.assert_array_equal(costs[:, :t] < gl.BIG / 2, live)
    np.testing.assert_allclose(costs[:, :t][live], rc[live], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(words[:, :t][live], rw[live])
    np.testing.assert_array_equal(starts[:, :t][live], rs[live])
    say("level", f"level_build {n_conn} recordings x "
                 f"{bank.feats.shape[0]} templates, 4 levels: "
                 f"{dt * 1e3:.3f} ms; slice ({t} frames x {n_templates} "
                 f"templates) equals golden on {int(live.sum())} live cells")


def phase_tests() -> None:
    """``pytest -m gpu`` in this process (the card is already ours)."""
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes.append((report.nodeid, report.outcome))

    os.environ["DSP_ASR_DEVICE_TESTS"] = "1"
    count = Count()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu_device.py")],
                     plugins=[count])
    passed = sum(o == "passed" for _, o in count.outcomes)
    bad = [(i, o) for i, o in count.outcomes if o != "passed"]
    say("tests", f"pytest -m gpu: {passed} passed, {len(bad)} not "
                 f"passed {bad} (exit {int(rc)})")
    if int(rc) != 0 or bad or not passed:
        raise AssertionError("on-card tests did not all pass")


# ------------------------------------------------------------ four cards
def phase_four(n_queries: int = 256, n_words: int = 35, per_word: int = 3,
               n_conn: int = 4) -> None:
    """Sharded paths on four devices vs the same calls on one."""
    import jax
    import jax.numpy as jnp

    from dsp_asr import parallel as par
    from dsp_asr import pipeline as pl
    from dsp_asr.config import HmmConfig, PipelineConfig
    from dsp_asr.io.dataset import synth_word
    from dsp_asr.models import gmm_hmm as gh
    from dsp_asr.ops import frontend as fe
    from dsp_asr.ops.level_building import level_build
    from dsp_asr.ops.spot import subseq_dtw_batch
    from dsp_asr.parallel.em import em_step_sharded

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four needs 4 devices, JAX sees {len(devs)}")

    def spread(*arrays):
        for a in arrays:
            got = {s.device for s in a.addressable_shards}
            if len(got) != 4:
                raise AssertionError(f"array {a.shape} sits on {got}")

    cfg = PipelineConfig()
    mats = fe.make_matrices(cfg.frontend)
    words = [f"w{i:02d}" for i in range(n_words)]
    bank_sigs = np.stack([synth_word(w, i, max_samples=cfg.max_samples)
                          for w in words for i in range(per_word)])
    ids = np.repeat(np.arange(n_words, dtype=np.int32), per_word)
    q_sigs = np.stack([synth_word(words[i % n_words], 1000 + i,
                                  max_samples=cfg.max_samples)
                       for i in range(n_queries)])
    full = lambda m: jnp.full(m, cfg.max_samples, jnp.int32)
    bank = pl.extract_features(jnp.asarray(bank_sigs), full(len(bank_sigs)),
                               mats, cfg)
    k = len(bank_sigs)

    # recognize_sharded on a (1, 4) bank mesh, 35-word config-4 shape
    mesh = par.make_mesh(1, 4)
    bf, k0 = par.pad_axis_to_multiple(np.asarray(bank.feats), 4)
    bl, _ = par.pad_axis_to_multiple(np.asarray(bank.length), 4)
    valid = np.arange(len(bl)) < k0
    bl = np.maximum(bl, 1)
    bfd, bld, vd = par.shard_bank(mesh, bf, bl, valid)
    ids_p, _ = par.pad_axis_to_multiple(ids, 4)
    spread(bfd, bld, vd)
    xd, nd = par.shard_queries(mesh, q_sigs, np.asarray(full(n_queries)))
    lab4, d4 = par.recognize_sharded(mesh, xd, nd, mats, bfd, bld,
                                     par.replicate(mesh, ids_p), vd, cfg=cfg,
                                     return_full=True)
    lab1, d1 = pl.recognize_batch(jnp.asarray(q_sigs), full(n_queries), mats,
                                  bank, jnp.asarray(ids), cfg)
    d4, d1 = np.asarray(d4)[:, :k], np.asarray(d1)
    fin = d1 < 1e20
    rel = float(np.max(np.abs(d4[fin] - d1[fin]) / d1[fin]))
    same = int((np.asarray(lab4) == np.asarray(lab1)).sum())
    say("four", f"recognize_sharded (1,4) B={n_queries} K={k} "
                f"({n_words} words): {same}/{n_queries} labels equal one "
                f"device; max rel distance diff {rel:.2e}")
    # XLA may fuse the sharded front-end differently from one device's
    if same != n_queries or rel > KERNEL_RTOL:
        raise AssertionError("recognize_sharded disagrees with one device")

    # level building and spotting on small slices, bank-sharded
    conn_q = pl.extract_features(jnp.asarray(q_sigs[:n_conn]), full(n_conn),
                                 mats, cfg)
    kb = 8
    sb = par.shard_bank(mesh, np.asarray(bank.feats[:kb]),
                        np.asarray(bank.length[:kb]), np.ones(kb, bool))
    spread(*sb)
    sq = par.shard_queries(mesh, np.asarray(conn_q.feats),
                           np.asarray(conn_q.length))
    from dsp_asr.parallel.sharding import level_build_sharded, spot_sharded
    c4, w4, s4 = (np.asarray(a) for a in level_build_sharded(
        mesh, *sq, *sb, max_levels=3, word_penalty=0.1))
    c1, w1, s1 = (np.asarray(a) for a in level_build(
        conn_q.feats, conn_q.length, bank.feats[:kb], bank.length[:kb],
        max_levels=3, word_penalty=0.1))
    live = c1 < 1e20
    np.testing.assert_array_equal(c4 < 1e20, live)
    np.testing.assert_allclose(c4[live], c1[live], rtol=1e-5)
    np.testing.assert_array_equal(w4[live], w1[live])
    np.testing.assert_array_equal(s4[live], s1[live])
    n4, st4 = (np.asarray(a) for a in spot_sharded(mesh, *sq, *sb))
    n1, st1 = (np.asarray(a) for a in subseq_dtw_batch(
        conn_q.feats, conn_q.length, bank.feats[:kb], bank.length[:kb]))
    fin = n1 < 1e20
    np.testing.assert_array_equal(n4 < 1e20, fin)
    np.testing.assert_allclose(n4[fin], n1[fin], rtol=1e-5)
    np.testing.assert_array_equal(st4[fin], st1[fin])
    say("four", f"level_build_sharded and spot_sharded ({n_conn} queries x "
                f"{kb} templates on 4 bank shards) equal one device")

    # em_step_sharded on a (4, 1) data mesh
    hcfg = HmmConfig(n_states=3, n_mix=2, n_iter=1)
    n_em = min(16, n_queries)
    feats = pl.extract_features(jnp.asarray(q_sigs[:n_em]), full(n_em), mats,
                                cfg)
    params = gh.init_params(feats.feats, feats.length, hcfg,
                            jax.random.PRNGKey(0))
    want, want_ll = gh._em_iteration(feats.feats, feats.length, params, hcfg)
    dmesh = par.make_mesh(4, 1)
    fd, ld = par.shard_queries(dmesh, np.asarray(feats.feats),
                               np.asarray(feats.length))
    spread(fd, ld)
    pd = jax.tree.map(lambda a: par.replicate(dmesh, np.asarray(a)), params)
    got, got_ll = em_step_sharded(dmesh, fd, ld, pd, hcfg)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)
    # the variance update E[x^2] - mean^2 cancels in f32 on MFCC-scale
    # features, and the psum adds the shards' sums in another order
    for name in gh.HmmParams._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    say("four", f"em_step_sharded (4,1) on {n_em} utterances: log-likelihood "
                f"{float(got_ll):.6f} vs one device {float(want_ll):.6f}")


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)

    dev = device_identity()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev}); nothing measured",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if dev["count"] < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {dev['count']}",
              file=sys.stderr)
        return 2
    say("device", f"platform={dev['platform']} kind={dev['kind']} "
                  f"count={dev['count']}")
    print(card_line(), flush=True)

    from dsp_asr.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    failed = []

    def run(name, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        except Exception:                       # reported, then exit 1
            traceback.print_exc()
            say(name, "FAILED")
            failed.append(name)
        finally:
            print(f"# {name}: {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr, flush=True)

    if args.four:
        run("four", phase_four)
    else:
        with tempfile.TemporaryDirectory() as work:
            main_path = run("cli", phase_cli, work)
            if main_path is not None:
                for name in ONE_CARD_PHASES[1:-1]:
                    run(name, globals()[f"phase_{name}"], main_path)
        run("tests", phase_tests)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    print(result_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
