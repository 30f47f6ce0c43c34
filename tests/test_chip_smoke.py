"""chip_smoke.py's CPU-testable parts: refusal without a GPU, the last
line, phase selection, failure handling, and every one-card phase
rehearsed at a tiny size (the kernel in interpret mode)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    res = _run(REPO, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_result_line_format():
    line = cs.result_line(dict(GPU, extra="ignored"))
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_phases_for():
    assert cs.phases_for(True) == ("four",)
    one = cs.phases_for(False)
    assert "four" not in one and one[0] == "cli" and one[-1] == "tests"


@pytest.fixture
def fake_card(monkeypatch):
    """A GPU device identity, an nvidia-smi line and recording phases."""
    ran = []
    dev = dict(GPU)
    monkeypatch.setattr(cs, "device_identity", lambda: dev)
    monkeypatch.setattr(cs, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for name in cs.ONE_CARD_PHASES + cs.FOUR_CARD_PHASES:
        monkeypatch.setattr(cs, f"phase_{name}",
                            lambda *a, _n=name: ran.append(_n) or "main")
    return dev, ran


def test_one_card_runs_every_one_card_phase(fake_card, capsys):
    dev, ran = fake_card
    assert cs.main([]) == 0
    assert tuple(ran) == cs.ONE_CARD_PHASES
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(out[-1]) == {"ok": True, "device": GPU}


def test_four_runs_only_its_phase(fake_card, capsys):
    dev, ran = fake_card
    dev["count"] = 4
    assert cs.main(["--four"]) == 0
    assert ran == ["four"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "device"]["count"] == 4


def test_four_refuses_fewer_cards(fake_card, capsys):
    _, ran = fake_card
    assert cs.main(["--four"]) != 0
    assert ran == [] and '"ok"' not in capsys.readouterr().out


def test_failed_phase_fails_the_run(fake_card, monkeypatch, capsys):
    _, ran = fake_card

    def broken(*a):
        raise AssertionError("wrong labels")

    monkeypatch.setattr(cs, "phase_golden", broken)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out and "[golden] FAILED" in out
    assert "tests" in ran                     # the other phases still ran


def test_card_line_needs_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises((RuntimeError, OSError)):
        cs.card_line()


def test_one_card_phases_rehearse_on_cpu(tmp_path, capsys):
    """Each one-card phase end to end at a tiny size on the CPU."""
    main = cs.phase_cli(str(tmp_path), per_word=1, n_eval=12, n_serve=2)
    assert len(main.queries) == 12 and len(main.serve_paths) == 2
    cs.phase_timing(main, chunk=8, passes=1)
    cs.phase_golden(main, n_queries=2)
    assert cs.phase_precision(main, chunk=8) == "default"
    cs.phase_kernel(main, shapes=((3, 10), (1, 2)), interpret=True)
    cs.phase_hmm(main, n_utts=4, n_check=1)
    cs.phase_stream(main)
    cs.phase_spot(main, n_conn=2, n_check=1)
    cs.phase_level(main, n_conn=2, n_templates=3, n_frames=60)
    out = capsys.readouterr().out
    for name in cs.ONE_CARD_PHASES[:-1]:
        assert f"[{name}] " in out, name
    assert "FAILED" not in out


def test_four_card_phase_rehearses_on_cpu_mesh():
    """The --four phase on four of the suite's virtual CPU devices."""
    cs.phase_four(n_queries=8, n_words=5, per_word=3, n_conn=4)
