"""N-best hypothesis readout (pipeline.nbest_from_scores + the three
families' classify_nbest + the recognize/serve CLI surfaces)."""

import os

import numpy as np
import pytest

from dsp_asr import cli
from dsp_asr import pipeline as pl
from dsp_asr.config import PipelineConfig
from dsp_asr.io.dataset import make_corpus

LABELS = ["one", "two", "zero"]


# ---------------------------------------------------------------- helper
def test_helper_orders_and_weights_distances():
    scores = np.asarray([[3.0, 1.0, 2.0]])
    (row,) = pl.nbest_from_scores(scores, LABELS, n=3)
    assert [x[0] for x in row] == ["two", "zero", "one"]
    assert [x[1] for x in row] == [1.0, 2.0, 3.0]       # native scores kept
    ws = [x[2] for x in row]
    assert ws[0] > ws[1] > ws[2] > 0
    assert sum(ws) == pytest.approx(1.0)


def test_helper_higher_better_orientation():
    scores = np.asarray([[-10.0, -2.0, -5.0]])          # log-liks
    (row,) = pl.nbest_from_scores(scores, LABELS, n=2, higher_better=True)
    assert [x[0] for x in row] == ["two", "zero"]
    assert row[0][1] == -2.0


def test_helper_drops_dead_entries():
    scores = np.asarray([[1e30, 4.0, 2.5e27],           # BIG + normalized-BIG
                         [1e30, 1e30, 1e30]])
    rows = pl.nbest_from_scores(scores, LABELS, n=3)
    assert [x[0] for x in rows[0]] == ["two"]           # only live entry
    assert rows[0][0][2] == pytest.approx(1.0)          # lone hypothesis
    assert rows[1] == []                                # all dead


def test_helper_n_caps_and_tie_weights():
    scores = np.asarray([[2.0, 2.0, 2.0]])
    (row,) = pl.nbest_from_scores(scores, LABELS, n=2)
    assert len(row) == 2
    assert row[0][2] == pytest.approx(1 / 3)            # zero-std guard


# ---------------------------------------------------------------- families
@pytest.fixture(scope="module")
def corpus():
    return make_corpus(LABELS, n_per_word=3, seed=0)


def test_knn_nbest_top1_matches_classify(corpus):
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab, xs in corpus.items():
        rec.enroll(lab, xs[:2])
    sigs = [xs[2] for xs in corpus.values()]
    hyps = rec.classify_nbest(sigs, n=3)
    assert [h[0][0] for h in hyps] == rec.classify_batch(sigs)
    for h in hyps:
        assert len(h) == 3 and h[0][2] >= h[1][2] >= h[2][2]
        assert h[0][1] <= h[1][1] <= h[2][1]            # distances ascend
    assert rec.classify_nbest([]) == []


def test_hmm_nbest_top1_matches_classify(corpus):
    from dsp_asr.models.gmm_hmm import GmmHmmRecognizer
    from dsp_asr.config import HmmConfig

    rec = GmmHmmRecognizer(PipelineConfig(),
                           HmmConfig(n_states=3, n_mix=2, n_iter=3))
    rec.fit(corpus)
    sigs = [xs[2] for xs in corpus.values()]
    hyps = rec.classify_nbest(sigs, n=2)
    assert [h[0][0] for h in hyps] == rec.classify_batch(sigs)
    for h in hyps:
        assert h[0][1] >= h[1][1]                       # log-liks descend


def test_vq_nbest_top1_matches_classify(corpus):
    from dsp_asr.models.vq import VqRecognizer

    rec = VqRecognizer(PipelineConfig())
    rec.fit(corpus)
    sigs = [xs[2] for xs in corpus.values()]
    hyps = rec.classify_nbest(sigs, n=2)
    assert [h[0][0] for h in hyps] == rec.classify_batch(sigs)


def test_knn_nbest_mesh_matches_single_device(corpus):
    from dsp_asr.models.knn_dtw import KnnDtwRecognizer
    from dsp_asr.parallel import make_mesh

    rec = KnnDtwRecognizer(PipelineConfig())
    for lab, xs in corpus.items():
        rec.enroll(lab, xs[:2])
    sigs = [xs[2] for xs in corpus.values()]
    want = rec.classify_nbest(sigs, n=3)
    rec.mesh = make_mesh()
    got = rec.classify_nbest(sigs, n=3)
    for w_row, g_row in zip(want, got):
        assert [x[0] for x in w_row] == [x[0] for x in g_row]
        np.testing.assert_allclose([x[1] for x in w_row],
                                   [x[1] for x in g_row], rtol=2e-4)


# ---------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    cli.main(["make-corpus", "--out", d, "--n", "2", "--words", "3"])
    return d


def test_recognize_nbest_flag(corpus_dir, tmp_path, capsys):
    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    lab = sorted(os.listdir(os.path.join(corpus_dir, "test")))[0]
    wav = os.path.join(corpus_dir, "test", lab,
                       sorted(os.listdir(
                           os.path.join(corpus_dir, "test", lab)))[0])
    cli.main(["recognize", "--bank", bank, "--nbest", "2", wav])
    out = capsys.readouterr().out.strip()
    cells = out.split("\t")[1].split(" ")
    assert len(cells) == 2
    top_lab, dist, weight = cells[0].split(":")
    assert top_lab == lab and float(dist) > 0 and 0 < float(weight) <= 1


def test_serve_nbest_line(corpus_dir, tmp_path, capsys, monkeypatch):
    import io

    bank = str(tmp_path / "bank.npz")
    cli.main(["enroll", "--corpus", os.path.join(corpus_dir, "train"),
              "--bank", bank])
    lab = sorted(os.listdir(os.path.join(corpus_dir, "test")))[0]
    wav = os.path.join(corpus_dir, "test", lab,
                       sorted(os.listdir(
                           os.path.join(corpus_dir, "test", lab)))[0])
    monkeypatch.setattr("sys.stdin", io.StringIO(f"nbest {wav}\n"))
    cli.main(["serve", "--bank", bank, "--nbest", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "ready"
    cells = lines[1].split("\t")[1].split(" ")
    assert len(cells) == 2 and cells[0].split(":")[0] == lab
