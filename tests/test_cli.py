"""CLI end-to-end: make-corpus -> enroll -> recognize/evaluate -> demo."""

import json
import os

import numpy as np
import pytest

from dsp_asr import cli


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3"])
    return d


def test_make_corpus_layout(corpus_dir):
    train = os.path.join(corpus_dir, "train")
    labels = sorted(os.listdir(train))
    assert len(labels) == 3
    for lab in labels:
        wavs = os.listdir(os.path.join(train, lab))
        assert len(wavs) == 2


def test_enroll_evaluate_roundtrip(corpus_dir, tmp_path, capsys):
    bank = str(tmp_path / "bank.npz")
    metrics = str(tmp_path / "metrics.json")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    assert os.path.exists(bank)
    cli.main(["evaluate", "--corpus", os.path.join(corpus_dir, "test"),
              "--bank", bank, "--metrics-out", metrics])
    out = capsys.readouterr().out
    assert "accuracy:" in out
    acc = float(out.rsplit("accuracy:", 1)[1].split("(")[0])
    assert acc >= 0.8
    rec = json.load(open(metrics))
    assert rec["accuracy"] == acc


def test_recognize_command(corpus_dir, tmp_path, capsys):
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    lab_dir = sorted(os.listdir(os.path.join(corpus_dir, "test")))[0]
    wav = os.path.join(corpus_dir, "test", lab_dir,
                       sorted(os.listdir(os.path.join(corpus_dir, "test", lab_dir)))[0])
    cli.main(["recognize", "--bank", bank, wav])
    out = capsys.readouterr().out
    assert wav in out


def test_recognize_reject_flag(corpus_dir, tmp_path, capsys):
    """enroll stores a calibrated rejection threshold; recognize
    --reject returns <reject> for an out-of-vocabulary WAV."""
    from dsp_asr.io.dataset import synth_word
    from dsp_asr.io.wav import write_wav
    from dsp_asr.models.knn_dtw import REJECT, KnnDtwRecognizer

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    assert KnnDtwRecognizer.load(bank).reject_threshold is not None
    oov = str(tmp_path / "oov.wav")
    write_wav(oov, 16000, synth_word("papa", 7))
    cli.main(["recognize", "--bank", bank, "--reject", oov])
    out = capsys.readouterr().out
    assert REJECT in out
    # in-vocab WAVs stay accepted under the same flag
    lab = sorted(os.listdir(os.path.join(corpus_dir, "test")))[0]
    wav = os.path.join(corpus_dir, "test", lab,
                       sorted(os.listdir(
                           os.path.join(corpus_dir, "test", lab)))[0])
    cli.main(["recognize", "--bank", bank, "--reject", wav])
    out = capsys.readouterr().out
    assert REJECT not in out and lab in out
    # loud error instead of a silently ignored flag (ADVICE r4 lesson)
    with pytest.raises(SystemExit, match="plain classification"):
        cli.main(["recognize", "--bank", bank, "--reject",
                  "--connected", wav])
    # enroll --no-reject-calibration leaves the threshold unset
    bank2 = str(tmp_path / "bank2.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank2, "--no-reject-calibration"])
    assert KnnDtwRecognizer.load(bank2).reject_threshold is None


def test_evaluate_reject_oov(corpus_dir, tmp_path, capsys):
    """evaluate --reject on a corpus containing an un-enrolled label:
    those queries count correct iff rejected."""
    import shutil

    from dsp_asr.io.dataset import synth_word
    from dsp_asr.io.wav import write_wav

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    test_dir = str(tmp_path / "test_oov")
    shutil.copytree(os.path.join(corpus_dir, "test"), test_dir)
    oov_dir = os.path.join(test_dir, "papa")
    os.makedirs(oov_dir)
    write_wav(os.path.join(oov_dir, "w.wav"), 16000, synth_word("papa", 7))
    cli.main(["evaluate", "--corpus", test_dir, "--bank", bank,
              "--reject"])
    out = capsys.readouterr().out
    assert "<reject>" in out
    acc = float(out.rsplit("accuracy:", 1)[1].split("(")[0])
    assert acc >= 0.8


def test_recognize_connected(corpus_dir, tmp_path, capsys):
    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.io.wav import write_wav

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    labels = sorted(os.listdir(os.path.join(corpus_dir, "train")))[:2]
    wav = str(tmp_path / "connected.wav")
    write_wav(wav, 16000, synth_connected(labels, 1))
    cli.main(["recognize", "--bank", bank, "--connected", wav])
    out = capsys.readouterr().out
    assert out.strip().split("\t")[1].split(" ") == labels


def test_recognize_connected_level_method(corpus_dir, tmp_path, capsys):
    """--connected-method level decodes a GAPLESS recording the VAD
    splitter cannot segment (ops/level_building.py)."""
    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.io.wav import write_wav

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    labels = sorted(os.listdir(os.path.join(corpus_dir, "train")))[:2]
    wav = str(tmp_path / "gapless.wav")
    write_wav(wav, 16000, synth_connected(labels, 3, gap_ms=(0.0, 1.0)))
    cli.main(["recognize", "--bank", bank, "--connected",
              "--connected-method", "level", wav])
    out = capsys.readouterr().out
    assert out.strip().split("\t")[1].split(" ") == labels


def test_make_corpus_connected_and_evaluate(tmp_path, capsys):
    d = str(tmp_path / "corpus")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3",
              "--connected", "4"])
    conn = os.path.join(d, "connected")
    assert len([f for f in os.listdir(conn) if f.endswith(".wav")]) == 4
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    metrics = str(tmp_path / "conn_metrics.json")
    cli.main(["evaluate-connected", "--corpus", conn, "--bank", bank,
              "--metrics-out", metrics])
    out = capsys.readouterr().out
    wer = float(out.rsplit("wer:", 1)[1].split("(")[0])
    assert wer <= 0.25
    assert json.load(open(metrics))["wer"] == wer
    # the other two families share the same evaluator
    vq = str(tmp_path / "vq.npz")
    cli.main(["train-vq", "--corpus", os.path.join(d, "train"),
              "--model", vq])
    cli.main(["evaluate-connected", "--corpus", conn, "--vq", vq])
    out = capsys.readouterr().out
    assert float(out.rsplit("wer:", 1)[1].split("(")[0]) <= 0.25
    with pytest.raises(SystemExit):
        cli.main(["evaluate-connected", "--corpus", conn,
                  "--bank", bank, "--vq", vq])


def test_make_corpus_gapless_and_evaluate_level(tmp_path, capsys):
    """--gapless clips + evaluate-connected --connected-method level:
    the full gapless workflow end-to-end through the CLI."""
    d = str(tmp_path / "corpus")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3",
              "--connected", "3", "--gapless"])
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    conn = os.path.join(d, "connected")
    cli.main(["evaluate-connected", "--corpus", conn, "--bank", bank,
              "--connected-method", "level"])
    out = capsys.readouterr().out
    wer = float(out.rsplit("wer:", 1)[1].split("(")[0])
    assert wer <= 0.25


def test_grammar_flag_constrains_level_decode(tmp_path, capsys):
    """--grammar on recognize/evaluate-connected: a spec matching the
    truth is a no-op; a vad-method combination is rejected."""
    d = str(tmp_path / "corpus")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3",
              "--connected", "3", "--gapless"])
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    spec = str(tmp_path / "grammar.json")
    with open(spec, "w") as f:
        # all-allowed spec: plumbing must be a no-op vs no grammar
        # (the corpus writer samples labels WITH repetition, so e.g.
        # no_repeat would genuinely conflict with some truths)
        json.dump({"start": "*", "end": "*"}, f)
    conn = os.path.join(d, "connected")
    cli.main(["evaluate-connected", "--corpus", conn, "--bank", bank,
              "--connected-method", "level"])
    wer_plain = float(
        capsys.readouterr().out.rsplit("wer:", 1)[1].split("(")[0])
    cli.main(["evaluate-connected", "--corpus", conn, "--bank", bank,
              "--connected-method", "level", "--grammar", spec])
    out = capsys.readouterr().out
    assert float(out.rsplit("wer:", 1)[1].split("(")[0]) == wer_plain
    with pytest.raises(SystemExit, match="grammar requires"):
        cli.main(["evaluate-connected", "--corpus", conn, "--bank", bank,
                  "--grammar", spec])
    # recognize surface: grammar rides the same level path
    wav = [f for f in sorted(os.listdir(conn)) if f.endswith(".wav")][0]
    with open(os.path.join(conn, "labels.tsv")) as f:
        truth = f.readline().rstrip("\n").split("\t")[1]
    cli.main(["recognize", "--bank", bank, "--connected",
              "--connected-method", "level", "--grammar", spec,
              os.path.join(conn, wav)])
    out = capsys.readouterr().out
    assert out.strip().split("\t")[1] == truth


def test_flag_sentinels_preserve_enrolled_config(corpus_dir, tmp_path,
                                                 capsys):
    """Regression: argparse defaults used to clobber a checkpoint's
    enrolled k/matcher on every evaluate/recognize (no way to tell
    'flag passed' from 'default'); None sentinels fix that."""
    import argparse

    from dsp_asr.cli import _apply_matcher_flags
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    bank = str(tmp_path / "bank3.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank, "--k", "3", "--matcher", "cascade"])
    rec = KnnDtwRecognizer.load(bank)
    assert rec.k == 3 and rec.matcher == "cascade"
    _apply_matcher_flags(rec, argparse.Namespace(k=None, matcher=None,
                                                shortlist=None))
    assert rec.k == 3 and rec.matcher == "cascade"   # untouched
    _apply_matcher_flags(rec, argparse.Namespace(k=1, matcher="dtw",
                                                shortlist=None))
    assert rec.k == 1 and rec.matcher == "dtw"       # explicit override
    # oversized --k must clamp inside the vote, not crash lax.top_k
    cli.main(["evaluate", "--corpus", os.path.join(corpus_dir, "test"),
              "--bank", bank, "--k", "50"])
    out = capsys.readouterr().out
    assert "accuracy:" in out


def test_serve_loop(corpus_dir, tmp_path, capsys, monkeypatch):
    import io

    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.io.wav import write_wav

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    labels = sorted(os.listdir(os.path.join(corpus_dir, "train")))
    lab_dir = labels[0]
    wav = os.path.join(corpus_dir, "test", lab_dir,
                       sorted(os.listdir(os.path.join(
                           corpus_dir, "test", lab_dir)))[0])
    conn_wav = str(tmp_path / "serve_conn.wav")
    write_wav(conn_wav, 16000, synth_connected(labels[:2], 3))
    gapless_wav = str(tmp_path / "serve_gapless.wav")
    write_wav(gapless_wav, 16000,
              synth_connected(labels[:2], 4, gap_ms=(0.0, 1.0)))
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"{wav}\nconnected {conn_wav}\nlevel {gapless_wav}\n"
        f"spot {conn_wav}\n{tmp_path}/missing.wav\n"))
    cli.main(["serve", "--bank", bank])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "ready"
    assert lines[1].split("\t")[1] == lab_dir
    assert lines[2].split("\t")[1] == " ".join(labels[:2])
    assert lines[3].split("\t")[1] == " ".join(labels[:2])   # gapless
    spotted = [c.split(":")[0] for c in lines[4].split("\t")[1].split(" ")]
    assert spotted == labels[:2]                              # spot mode
    assert "ERROR" in lines[5]


def test_serve_grammar_applies_to_level_lines(corpus_dir, tmp_path,
                                              capsys, monkeypatch):
    """serve --grammar gates 'level ' requests: forbidding the true
    first word as a start reroutes the decode."""
    import io

    from dsp_asr.io.dataset import synth_connected
    from dsp_asr.io.wav import write_wav

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    labels = sorted(os.listdir(os.path.join(corpus_dir, "train")))
    gapless_wav = str(tmp_path / "serve_gapless.wav")
    write_wav(gapless_wav, 16000,
              synth_connected(labels[:2], 4, gap_ms=(0.0, 1.0)))
    spec = str(tmp_path / "grammar.json")
    with open(spec, "w") as f:
        json.dump({"start": [labels[1]]}, f)   # truth starts labels[0]
    monkeypatch.setattr("sys.stdin", io.StringIO(f"level {gapless_wav}\n"))
    cli.main(["serve", "--bank", bank, "--grammar", spec])
    lines = capsys.readouterr().out.strip().splitlines()
    got = lines[1].split("\t")[1].split(" ")
    assert got != labels[:2] and got[0] == labels[1]


def test_demo_synthetic_stream(corpus_dir, tmp_path, capsys):
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    cli.main(["demo", "--bank", bank])
    out = capsys.readouterr().out
    assert out.count("s]") >= 3   # recognized several events


def test_train_hmm_roundtrip(corpus_dir, tmp_path, capsys):
    model = str(tmp_path / "hmm.npz")
    cli.main(["train-hmm", "--corpus", os.path.join(corpus_dir, "train"),
              "--model", model, "--states", "3", "--mix", "2", "--iters", "3"])
    cli.main(["evaluate-hmm", "--corpus", os.path.join(corpus_dir, "test"),
              "--model", model, "--states", "3", "--mix", "2", "--iters", "3"])
    out = capsys.readouterr().out
    assert "accuracy:" in out


def test_plot_command(corpus_dir, tmp_path):
    bank = str(tmp_path / "bank.npz")
    out = str(tmp_path / "pipeline.png")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    cli.main(["plot", "--word", "one", "--bank", bank, "--out", out])
    assert os.path.getsize(out) > 10000   # a real PNG was rendered


def test_evaluate_with_mesh_flag(corpus_dir, tmp_path, capsys):
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    cli.main(["evaluate", "--corpus", os.path.join(corpus_dir, "test"),
              "--bank", bank, "--mesh"])
    out = capsys.readouterr().out
    acc = float(out.rsplit("accuracy:", 1)[1].split("(")[0])
    assert acc >= 0.8


def test_warm_command(corpus_dir, tmp_path, capsys):
    """`warm` drives the real classify path in-process at the given
    batch sizes."""
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    cli.main(["warm", "--bank", bank, "--batches", "2"])
    out = capsys.readouterr().out
    assert "warm: batch=2" in out and "warm: done" in out


def test_warm_command_synthetic_bank(capsys):
    cli.main(["warm", "--bank-size", "4", "--batches", "1"])
    out = capsys.readouterr().out
    assert "warm: batch=1 bank=10" in out   # 10 words x ceil(4/10)=1 each


def test_warm_connected_paths(corpus_dir, tmp_path, capsys):
    """warm --connected compiles the splitter, level-building and
    grammar decoders at the given length multiple."""
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    spec = str(tmp_path / "g.json")
    with open(spec, "w") as f:
        json.dump({"no_repeat": True}, f)
    cli.main(["warm", "--bank", bank, "--batches", "", "--connected", "2",
              "--grammar", spec])
    out = capsys.readouterr().out
    assert "warm: connected+spot len=2x" in out and "warm: done" in out


def test_make_corpus_hostile_defaults_to_full_vocab(tmp_path):
    """Unset --words on --hostile must yield the full 35-class confusable
    vocabulary, not the 10-digit default (ADVICE round 3)."""
    d = str(tmp_path / "hostile")
    cli.main(["make-corpus", "--out", d, "--n", "1", "--hostile"])
    assert len(os.listdir(os.path.join(d, "train"))) == 35


def test_spot_and_evaluate_spot(tmp_path, capsys):
    """make-corpus --spotting -> enroll -> evaluate-spot finds the
    planted keywords (threshold in the measured [25, 50] window), and
    `spot` prints events for a single stream."""
    d = str(tmp_path / "c")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3",
              "--spotting", "2"])
    spotting = os.path.join(d, "spotting")
    assert os.path.exists(os.path.join(spotting, "events.tsv"))
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    capsys.readouterr()
    cli.main(["evaluate-spot", "--corpus", spotting, "--bank", bank,
              "--threshold", "30"])
    out = capsys.readouterr().out
    f1 = float(out.rsplit("f1:", 1)[1].split()[0])
    assert f1 >= 0.6
    # per-bank calibrated threshold must also find the keywords
    cli.main(["evaluate-spot", "--corpus", spotting, "--bank", bank,
              "--calibrate-threshold"])
    out = capsys.readouterr().out
    f1 = float(out.rsplit("f1:", 1)[1].split()[0])
    assert f1 >= 0.6
    with pytest.raises(SystemExit):
        cli.main(["evaluate-spot", "--corpus", spotting, "--bank", bank,
                  "--threshold", "30", "--calibrate-threshold"])
    wav = os.path.join(
        spotting, sorted(p for p in os.listdir(spotting)
                         if p.endswith(".wav"))[0])
    cli.main(["spot", "--bank", bank, "--threshold", "30", wav])
    out = capsys.readouterr().out
    assert wav in out
    # enroll stored a calibrated threshold in the bank (default-on), and
    # evaluate-spot with NO threshold flag picks it up — F1 must match
    # the eager --calibrate-threshold run above
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    stored = KnnDtwRecognizer.load(bank).spot_threshold
    assert stored is not None and 10.0 < stored < 60.0
    cli.main(["evaluate-spot", "--corpus", spotting, "--bank", bank])
    out = capsys.readouterr().out
    assert f"threshold: {stored}" in out
    assert float(out.rsplit("f1:", 1)[1].split()[0]) == f1
    # the escape hatch: --no-spot-calibration leaves the bank unstamped
    bank2 = str(tmp_path / "bank2.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank2, "--no-spot-calibration"])
    assert KnnDtwRecognizer.load(bank2).spot_threshold is None


def test_spot_hmm_family(tmp_path, capsys):
    """train-hmm -> evaluate-spot --hmm: the HMM spotter (open-endpoint
    Viterbi vs the checkpoint's stored UBM filler) finds keywords with
    the midpoint hit rule."""
    d = str(tmp_path / "c")
    cli.main(["make-corpus", "--out", d, "--n", "3", "--words", "3",
              "--spotting", "2"])
    model = str(tmp_path / "hmm.npz")
    cli.main(["train-hmm", "--corpus", os.path.join(d, "train"),
              "--model", model])
    capsys.readouterr()
    spotting = os.path.join(d, "spotting")
    cli.main(["evaluate-spot", "--corpus", spotting, "--hmm", model,
              "--threshold", "-60"])
    out = capsys.readouterr().out
    rec = float(out.rsplit("recall:", 1)[1].split()[1].strip("(").split("/")[0])
    f1 = float(out.rsplit("f1:", 1)[1].split()[0])
    assert f1 > 0.5, out
    wav = os.path.join(
        spotting, sorted(p for p in os.listdir(spotting)
                         if p.endswith(".wav"))[0])
    cli.main(["spot", "--hmm", model, "--threshold", "-60", wav])
    out = capsys.readouterr().out
    assert wav in out
    # online path: the keyword/filler column update streams too
    cli.main(["spot", "--hmm", model, "--threshold", "-60", "--stream",
              wav])
    out = capsys.readouterr().out
    assert wav in out


def test_spot_cascade_family(tmp_path, capsys):
    """--bank AND --hmm together select the cascade spotter: HMM
    landmarks propose windows, the bank's subsequence DTW reranks —
    full-word spans (overlap hit rule), DTW score units."""
    d = str(tmp_path / "c")
    cli.main(["make-corpus", "--out", d, "--n", "3", "--words", "3",
              "--spotting", "2"])
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    model = str(tmp_path / "hmm.npz")
    cli.main(["train-hmm", "--corpus", os.path.join(d, "train"),
              "--model", model])
    capsys.readouterr()
    spotting = os.path.join(d, "spotting")
    cli.main(["evaluate-spot", "--corpus", spotting, "--bank", bank,
              "--hmm", model])
    out = capsys.readouterr().out
    f1 = float(out.rsplit("f1:", 1)[1].split()[0])
    assert f1 >= 0.6, out
    wav = os.path.join(
        spotting, sorted(p for p in os.listdir(spotting)
                         if p.endswith(".wav"))[0])
    cli.main(["spot", "--bank", bank, "--hmm", model, wav])
    out = capsys.readouterr().out
    assert wav in out
    offline_lines = sorted(ln for ln in out.splitlines() if "\t" in ln)
    # round 5: --stream selects the streaming cascade (bounded-lag
    # rescored events) and agrees with offline on gap-separated words
    cli.main(["spot", "--bank", bank, "--hmm", model, "--stream", wav])
    sout = capsys.readouterr().out
    stream_lines = sorted(ln for ln in sout.splitlines() if "\t" in ln)
    assert [ln.split("\t")[1] for ln in stream_lines] == \
        [ln.split("\t")[1] for ln in offline_lines], (sout, out)
    with pytest.raises(SystemExit):
        cli.main(["spot", wav])                  # neither model given


def test_spot_mesh_flag_matches_single_device(tmp_path, capsys):
    """`spot --mesh` (bank-sharded spot_sharded on the fake 8-device
    mesh) prints the same events as the single-device path."""
    d = str(tmp_path / "c")
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3",
              "--spotting", "1"])
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(d, "train"),
              "--bank", bank])
    spotting = os.path.join(d, "spotting")
    wav = os.path.join(
        spotting, sorted(p for p in os.listdir(spotting)
                         if p.endswith(".wav"))[0])
    capsys.readouterr()
    cli.main(["spot", "--bank", bank, wav])
    single = capsys.readouterr().out
    cli.main(["spot", "--bank", bank, "--mesh", wav])
    mesh = capsys.readouterr().out
    assert mesh == single and wav in single
