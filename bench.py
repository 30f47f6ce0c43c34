"""Headline benchmark: batched isolated-word recognition throughput.

BASELINE.json config 1: utterance batch x 100-template bank, full
pipeline (VAD -> MFCC+delta/delta-delta -> all-pairs DTW -> argmin) on
one device.  Metric: utterance x template DTW alignments per second per
chip, including the fused front-end (the north-star floor is 10,000;
the reference publishes no numbers — BASELINE.md).

    python bench.py                     # on the GPU; refuses without one
    BENCH_PLATFORM=cpu python bench.py  # explicit CPU rehearsal

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"passes", "min", "max", "precision", "device"}.  ``value`` is the median
of BENCH_PASSES timed passes after one warm pass; each pass is host
clock around the chunk loop, ended by ``jax.block_until_ready``.
``device`` names what ran it (platform, device_kind, count).

Env knobs: BENCH_UTTS (default 1024), BENCH_TEMPLATES (100),
BENCH_CHUNK (256), BENCH_PASSES (5), BENCH_PRECISION (the shipped
``PRECISION`` below | default | highest), BENCH_SLOPE ("" = shipped
default | "itakura"), BENCH_PLATFORM ("" = the GPU, required | "cpu").
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NORTH_STAR = 10_000.0
# matmul precision of the timed pipeline: on the H100, DEFAULT lets f32
# GEMMs run in TF32; chip_smoke.py counts the labels that flips against
# HIGHEST at the full config-1 width and prints the decision
PRECISION = "default"


def device_identity() -> dict:
    """What JAX runs on: platform, device kind and device count."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def require_gpu() -> dict:
    """Device identity, or SystemExit(1) when no GPU is present.

    ``BENCH_PLATFORM=cpu`` pins the CPU for an explicit rehearsal; any
    other run that finds no GPU refuses to measure instead of timing
    the CPU under a device metric's name.
    """
    import jax

    if os.environ.get("BENCH_PLATFORM", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return device_identity()
    try:
        dev = device_identity()
    except RuntimeError as e:              # JAX_PLATFORMS names no device
        print(f"# bench: NOT MEASURED — no GPU ({e})", file=sys.stderr)
        raise SystemExit(1)
    if dev["platform"] != "gpu":
        print(f"# bench: NOT MEASURED — no GPU (JAX found {dev}); set "
              f"BENCH_PLATFORM=cpu for a CPU rehearsal", file=sys.stderr)
        raise SystemExit(1)
    return dev


def median_spread(dts: list[float]):
    """(median, lo, hi) of a list of timings."""
    dts = sorted(dts)
    n = len(dts)
    med = dts[n // 2] if n % 2 else 0.5 * (dts[n // 2 - 1] + dts[n // 2])
    return med, dts[0], dts[-1]


def timeit_spread(step, args, n_iters: int = 8, passes: int = 3):
    """(median, lo, hi) seconds per call of ``step(*args)``.

    One warm call (compiles), then ``passes`` timed passes of
    ``n_iters`` calls each, ended by ``jax.block_until_ready``.
    """
    import jax

    jax.block_until_ready(step(*args))
    dts = []
    for _ in range(max(1, passes)):
        t0 = time.perf_counter()
        out = None
        for _ in range(n_iters):
            out = step(*args)
        jax.block_until_ready(out)
        dts.append((time.perf_counter() - t0) / n_iters)
    return median_spread(dts)


def run(n_utts: int = 1024, n_templates: int = 100, chunk: int = 256,
        passes: int = 5, precision: str = PRECISION, slope: str = "") -> dict:
    """The full benchmark: bank build, compile/warm, timed passes."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dsp_asr import pipeline as pl
    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, synth_word
    from dsp_asr.ops import frontend as fe

    prec = {"default": jax.lax.Precision.DEFAULT,
            "highest": jax.lax.Precision.HIGHEST}[precision]
    cfg = PipelineConfig()
    if slope:
        cfg = dataclasses.replace(
            cfg, dtw=dataclasses.replace(cfg.dtw, slope=slope))
    mats = fe.make_matrices(cfg.frontend)

    # template bank: 10 words x (n_templates/10) takes each
    per_word = max(1, n_templates // len(DIGITS))
    bank_sigs = np.stack([
        synth_word(lab, i, max_samples=cfg.max_samples)
        for lab in DIGITS for i in range(per_word)
    ])[:n_templates]
    ids = np.repeat(np.arange(len(DIGITS), dtype=np.int32), per_word)[:n_templates]
    bank_ns = np.full(bank_sigs.shape[0], cfg.max_samples, dtype=np.int32)
    bank = jax.block_until_ready(pl.extract_features(
        jnp.asarray(bank_sigs), jnp.asarray(bank_ns), mats, cfg))

    # query utterances: distinct signals per chunk
    rng = np.random.default_rng(0)
    n_chunks = max(1, round(n_utts / chunk))
    if n_chunks * chunk != n_utts:
        print(f"# note: BENCH_UTTS {n_utts} rounded to {n_chunks * chunk} "
              f"(whole chunks of {chunk})", file=sys.stderr)
    chunks = []
    for c in range(n_chunks):
        q_sigs = np.stack([
            synth_word(DIGITS[rng.integers(10)], 1000 + c * chunk + i,
                       max_samples=cfg.max_samples)
            for i in range(chunk)
        ])
        chunks.append(jnp.asarray(q_sigs))
    qn = jnp.full(chunk, cfg.max_samples, dtype=jnp.int32)
    ids_d = jnp.asarray(ids)

    def run_chain():
        # one async dispatch per chunk; the host enqueues chunk c+1
        # while c runs, and one barrier ends the pass
        labels = [pl.recognize_batch(x, qn, mats, bank, ids_d, cfg, prec)[0]
                  for x in chunks]
        jax.block_until_ready(labels)

    run_chain()                        # compile + warm
    dts = []
    for _ in range(passes):
        t0 = time.perf_counter()
        run_chain()
        dts.append(time.perf_counter() - t0)

    alignments = n_chunks * chunk * bank.feats.shape[0]
    med, lo, hi = median_spread(dts)
    return {
        "metric": "mfcc_dtw_alignments_per_sec_per_chip",
        "value": round(alignments / med, 1),
        "unit": "alignments/s/chip",
        "vs_baseline": round(alignments / med / NORTH_STAR, 3),
        "passes": len(dts),
        "min": round(alignments / hi, 1),
        "max": round(alignments / lo, 1),
        "precision": precision,
    }


def main():
    dev = require_gpu()
    print(f"# bench: device {dev}", file=sys.stderr)
    from dsp_asr.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    env = os.environ.get
    result = run(n_utts=int(env("BENCH_UTTS", 1024)),
                 n_templates=int(env("BENCH_TEMPLATES", 100)),
                 chunk=int(env("BENCH_CHUNK", 256)),
                 passes=int(env("BENCH_PASSES", 5)),
                 precision=env("BENCH_PRECISION", PRECISION),
                 slope=env("BENCH_SLOPE", ""))
    result["device"] = dev
    print(json.dumps(result))


if __name__ == "__main__":
    main()
