"""Single-utterance serving latency (docs/PERF.md "Serving latency").

Production serving cares about per-request wall-clock, not just batch
throughput: this drives the REAL ``classify_batch`` path at small batch
sizes over a warm cache and reports wall-clock percentiles per call —
host padding, device dispatch, DTW against the full bank, label fetch.

    python scripts/serve_latency.py [--bank-size 100] [--batches 1,8,64]
    python scripts/serve_latency.py --platform cpu   # smoke, not a measurement
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bank-size", type=int, default=100)
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from dsp_asr.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax

    from dsp_asr.config import PipelineConfig
    from dsp_asr.io.dataset import DIGITS, synth_word
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    cfg = PipelineConfig()
    rec = KnnDtwRecognizer(cfg, k=1)
    per = max(1, -(-args.bank_size // len(DIGITS)))
    for lab in DIGITS:
        rec.enroll(lab, [synth_word(lab, i, max_samples=cfg.max_samples)
                         for i in range(per)])

    print(f"# serving latency: bank={rec.n_templates}, "
          f"{args.calls} calls/row, backend={jax.default_backend()}")
    print("| batch | p50 ms | p90 ms | p99 ms | labels/s |")
    print("|---|---|---|---|---|")
    for b in (int(x) for x in args.batches.split(",") if x.strip()):
        sigs = [synth_word(DIGITS[i % 10], 9000 + i,
                           max_samples=cfg.max_samples) for i in range(b)]
        rec.classify_batch(sigs)                      # compile + warm
        lat = []
        for c in range(args.calls):
            t0 = time.perf_counter()
            labels = rec.classify_batch(sigs)         # includes label fetch
            lat.append((time.perf_counter() - t0) * 1e3)
            assert len(labels) == b
        lat.sort()
        p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
        print(f"| {b} | {p(0.50):.1f} | {p(0.90):.1f} | {p(0.99):.1f} | "
              f"{1e3 * b / (sum(lat) / len(lat)):.0f} |", flush=True)

    # ---- serve's other request modes, per single request (B=1) -------
    from dsp_asr.io.dataset import synth_connected

    truth = DIGITS[:3]
    conn = synth_connected(truth, seed=77)                 # gapped
    gapless = synth_connected(truth, seed=78, gap_ms=(0.0, 1.0))
    grammar = {"no_repeat": True}
    modes = [
        ("connected (vad split)",
         lambda: rec.classify_connected([conn], max_segments=4)),
        ("level (gapless DP)",
         lambda: rec.classify_connected([gapless], max_segments=4,
                                        method="level")),
        ("level + grammar",
         lambda: rec.classify_connected([gapless], max_segments=4,
                                        method="level", grammar=grammar)),
        ("nbest (n=3)", lambda: rec.classify_nbest([conn[:cfg.max_samples]],
                                                   n=3)),
    ]
    print(f"\n# per-request modes (B=1, {args.calls} calls/row, "
          f"words/request={len(truth)})")
    print("| request mode | p50 ms | p90 ms | p99 ms | words/s |")
    print("|---|---|---|---|---|")
    for name, call in modes:
        call()                                             # compile + warm
        lat = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            call()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
        wps = 1e3 * len(truth) / (sum(lat) / len(lat))
        print(f"| {name} | {p(0.50):.1f} | {p(0.90):.1f} | "
              f"{p(0.99):.1f} | {wps:.0f} |", flush=True)


if __name__ == "__main__":
    main()
