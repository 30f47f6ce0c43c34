"""bench.py / bench_all.py: device identity, refusal without a GPU, and
the timing helpers (the measurements themselves run on the card)."""

import json
import os
import subprocess
import sys

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script):
    env = {k: v for k, v in os.environ.items() if k != "BENCH_PLATFORM"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, os.path.join(REPO, script)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_require_gpu_refuses_the_cpu(monkeypatch):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    with pytest.raises(SystemExit) as e:
        bench.require_gpu()
    assert e.value.code == 1


def test_cpu_rehearsal_is_explicit_and_named(monkeypatch):
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    dev = bench.require_gpu()
    assert dev["platform"] == "cpu" and dev["count"] >= 1 and dev["kind"]


@pytest.mark.parametrize("script", ["bench.py", "bench_all.py"])
def test_scripts_measure_nothing_without_a_gpu(script):
    res = _run(script)
    assert res.returncode == 1
    assert "NOT MEASURED" in res.stderr
    assert not res.stdout.strip()


def test_device_identity_shape():
    dev = bench.device_identity()
    assert set(dev) == {"platform", "kind", "count"}
    assert dev["platform"] == "cpu"
    json.dumps(dev)


@pytest.mark.parametrize("dts,want", [([3.0, 1.0, 2.0], (2.0, 1.0, 3.0)),
                                      ([4.0, 1.0, 2.0, 3.0], (2.5, 1.0, 4.0)),
                                      ([5.0], (5.0, 5.0, 5.0))])
def test_median_spread(dts, want):
    assert bench.median_spread(dts) == want


def test_timeit_spread_warms_then_times_every_call():
    import jax.numpy as jnp

    calls = []

    def step(x):
        calls.append(1)
        return x + 1

    med, lo, hi = bench.timeit_spread(step, (jnp.zeros(3),), n_iters=4,
                                      passes=3)
    assert len(calls) == 1 + 3 * 4
    assert 0 < lo <= med <= hi
