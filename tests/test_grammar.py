"""Word-grammar spec parsing and unit-mask compilation (ops/grammar.py)."""

import json

import numpy as np
import pytest

from dsp_asr.ops.grammar import Grammar

WORDS = ("one", "two", "three")


def test_loop_allows_everything():
    g = Grammar.loop(WORDS)
    assert g.start.all() and g.end.all() and g.pairs.all()


def test_no_repeat_kills_diagonal_only():
    g = Grammar.no_repeat(WORDS)
    assert not g.pairs.diagonal().any()
    off = ~np.eye(3, dtype=bool)
    assert g.pairs[off].all()


def test_from_spec_start_end_lists():
    g = Grammar.from_spec({"start": ["one"], "end": ["two", "three"]}, WORDS)
    np.testing.assert_array_equal(g.start, [True, False, False])
    np.testing.assert_array_equal(g.end, [False, True, True])
    assert g.pairs.all()                     # omitted pairs = all allowed


def test_from_spec_pairs_replace_default():
    g = Grammar.from_spec({"pairs": [["one", "two"]]}, WORDS)
    want = np.zeros((3, 3), bool)
    want[0, 1] = True
    np.testing.assert_array_equal(g.pairs, want)


def test_from_spec_wildcard_and_precedence():
    """no_repeat then forbidden subtract, in that order, from pairs."""
    g = Grammar.from_spec(
        {"pairs": [["*", "*"]], "no_repeat": True,
         "forbidden": [["one", "*"]]}, WORDS)
    assert not g.pairs.diagonal().any()
    assert not g.pairs[0].any()              # one -> anything forbidden
    assert g.pairs[1, 0] and g.pairs[2, 0]


def test_from_spec_unknown_word_raises():
    with pytest.raises(ValueError, match="unknown word 'four'"):
        Grammar.from_spec({"start": ["four"]}, WORDS)


def test_load_roundtrip(tmp_path):
    spec = {"start": "one", "pairs": [["one", "two"], ["two", "three"]],
            "end": ["three"]}
    p = tmp_path / "g.json"
    p.write_text(json.dumps(spec))
    g = Grammar.load(str(p), WORDS)
    assert g.start[0] and not g.start[1]
    assert g.pairs[0, 1] and g.pairs[1, 2] and not g.pairs[1, 0]
    assert g.end[2] and not g.end[0]


def test_unit_masks_expand_labels_to_templates():
    """Bank with several templates per label: a template pair is
    allowed iff its LABEL pair is."""
    g = Grammar.from_spec({"pairs": [["one", "two"]],
                           "start": ["one"], "end": ["two"]}, WORDS)
    unit_labels = np.asarray([0, 0, 1, 2])   # two templates of "one"
    s, p, e = g.unit_masks(unit_labels)
    np.testing.assert_array_equal(s, [True, True, False, False])
    np.testing.assert_array_equal(e, [False, False, True, False])
    assert p[0, 2] and p[1, 2]               # either "one" template -> "two"
    assert not p[2, 0] and not p[0, 1]       # one->one forbidden by pairs


def test_unit_masks_out_of_range_raises():
    g = Grammar.loop(WORDS)
    with pytest.raises(ValueError, match="outside the grammar"):
        g.unit_masks(np.asarray([0, 3]))


def test_describe_counts():
    g = Grammar.no_repeat(WORDS)
    assert g.describe() == "grammar over 3 words: 3 start, 6/9 pairs, 3 end"
