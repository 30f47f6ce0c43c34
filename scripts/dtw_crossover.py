"""Where the fused banded DTW kernel beats the XLA row scan on this GPU.

    python scripts/dtw_crossover.py [--out FILE]

Times all-pairs DTW, ``[B,T,F] x [K,U,F] -> [B,K]``, on MFCC features of
synthetic digits at the shipped config-1 width (T=U=198, F=39), for the
kernel (kernels/dtw_fused_banded.py) and the scan (ops/dtw.py at
bench.PRECISION), with and without the Itakura slope, over a grid of
batch sizes B and bank sizes K.  Each point is the median of 7 calls
after a warm one, each ended by ``jax.block_until_ready``.  Prints one
JSON line per point, with the implementation ``pipeline.dtw_impl``
routes it to; ``kernels/dtw_fused_banded.faster_than_scan`` holds the
thresholds read off this sweep.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCHES = (1, 8, 32, 64, 128, 256)
BANKS = (10, 100)


def median_seconds(fn, *args, n: int = 7) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def features(n: int, seed: int):
    """MFCC features of n synthetic digit utterances at the shipped config."""
    import jax.numpy as jnp

    from dsp_asr import pipeline as pl
    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, synth_word
    from dsp_asr.ops import frontend as fe

    cfg = PipelineConfig()
    sigs = np.stack([synth_word(DIGITS[i % 10], seed + i,
                                max_samples=cfg.max_samples)
                     for i in range(n)])
    return pl.extract_features(jnp.asarray(sigs),
                               jnp.full(n, cfg.max_samples, jnp.int32),
                               fe.make_matrices(cfg.frontend), cfg)


def sweep(kernels: dict, batches=BATCHES, banks=BANKS):
    """Yield one dict per (slope, K, B): each kernel's and the scan's ms."""
    import jax

    import bench
    from dsp_asr import pipeline as pl
    from dsp_asr.config import PipelineConfig
    from dsp_asr.ops.dtw import dtw_batch

    prec = {"default": jax.lax.Precision.DEFAULT,
            "highest": jax.lax.Precision.HIGHEST}[bench.PRECISION]
    t = PipelineConfig().max_frames
    bank = features(max(banks), seed=0)
    qs = features(max(batches), seed=1000)
    for slope in (None, "itakura"):
        dc = dataclasses.replace(PipelineConfig().dtw, slope=slope)
        fns = {name: jax.jit(lambda a, b, c, d, f=f: f(a, b, c, d, dc))
               for name, f in kernels.items()}
        fns["scan"] = jax.jit(lambda a, b, c, d: dtw_batch(a, b, c, d, dc,
                                                           prec))
        for k in banks:
            for b in batches:
                args = (qs.feats[:b], qs.length[:b], bank.feats[:k],
                        bank.length[:k])
                row = {"slope": slope, "B": b, "K": k}
                for name, fn in fns.items():
                    row[f"{name}_ms"] = median_seconds(fn, *args) * 1e3
                row["routed"] = pl.dtw_impl(dc, b, k, t, t)
                yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args(argv)

    import jax

    from dsp_asr.kernels.dtw_fused_banded import dtw_batch_fused_banded

    if jax.devices()[0].platform != "gpu":
        print("dtw_crossover: needs a GPU", file=sys.stderr)
        return 2
    out = open(args.out, "w") if args.out else None
    for row in sweep({"kernel": dtw_batch_fused_banded}):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
