"""Speech Commands v2 harness tests on a synthetic mini-dataset that
mimics the SC2 on-disk layout (real dataset needs egress; gated)."""

import os

import numpy as np
import pytest

from dsp_asr import cli
from dsp_asr.io import speech_commands as sc
from dsp_asr.io.dataset import synth_word
from dsp_asr.io.wav import write_wav

WORDS = ["go", "no", "yes"]


@pytest.fixture(scope="module")
def sc2_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("sc2")
    val_list, test_list = [], []
    for w in WORDS:
        os.makedirs(root / w)
        for i in range(6):
            rel = f"{w}/spk{i:02d}_nohash_0.wav"
            x = synth_word(w, i, max_samples=16000)
            write_wav(str(root / rel), 16000, x)
            if i == 4:
                val_list.append(rel)
            elif i == 5:
                test_list.append(rel)
    (root / "validation_list.txt").write_text("\n".join(val_list) + "\n")
    (root / "testing_list.txt").write_text("\n".join(test_list) + "\n")
    return str(root)


def test_split_partitioning(sc2_root):
    train = sc.list_split(sc2_root, "train", WORDS)
    val = sc.list_split(sc2_root, "validation", WORDS)
    test = sc.list_split(sc2_root, "test", WORDS)
    assert len(train) == 12 and len(val) == 3 and len(test) == 3
    all_paths = {p for _, p in train + val + test}
    assert len(all_paths) == 18   # disjoint and complete


def test_load_split_shapes(sc2_root):
    sigs, lens, ids, labels = sc.load_split(sc2_root, "train", WORDS,
                                            per_word=2)
    assert sigs.shape == (6, 16000)
    assert labels == sorted(WORDS)
    assert set(ids) == {0, 1, 2}
    assert (lens > 0).all()


def test_evaluate_sc2_command(sc2_root, capsys, tmp_path):
    metrics = str(tmp_path / "m.json")
    cli.main(["evaluate-sc2", "--root", sc2_root, "--templates", "4",
              "--batch", "4", "--metrics-out", metrics])
    out = capsys.readouterr().out
    acc = float(out.rsplit("accuracy:", 1)[1].split("(")[0])
    assert acc == 1.0   # synthetic words are easily separable
    assert os.path.exists(metrics)


def test_evaluate_sc2_no_mesh_matches(sc2_root, capsys):
    cli.main(["evaluate-sc2", "--root", sc2_root, "--templates", "4",
              "--batch", "4", "--no-mesh"])
    out = capsys.readouterr().out
    acc = float(out.rsplit("accuracy:", 1)[1].split("(")[0])
    assert acc == 1.0
