"""The paper's ``load_file`` in the port (``repro_torch/data/text.py``) and
the core package's exports, against the reference.

``load_file`` on a temporary text file (blank lines, mixed case, a cut
width) gives the reference's rows and vocabulary bit for bit; a per-op
wordcount over those rows gives the reference's counts exactly (both
engines, both targets); and every name of ``repro.core.__all__``
imports from ``repro_torch.core``.
"""
import importlib

import numpy as np
import pytest

import repro.core as jcore
from repro.core.session import BlazeSession as JaxSession
from repro.core.algorithms.wordcount import wordcount as jwordcount
from repro.data.text import load_file as jload_file
from repro.data.text import tokenize_lines as jtokenize_lines
from repro_torch.core import BlazeSession
from repro_torch.core.algorithms.wordcount import wordcount
from repro_torch.data.text import load_file, tokenize_lines

TEXT = """The quick brown Fox
jumps over the LAZY dog

  the  Dog barks; the fox   RUNS away
\t
a b c d e f g h i j k l
FOX fox Fox
"""


@pytest.fixture
def text_file(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text(TEXT)
    return str(path)


@pytest.mark.parametrize("width", [None, 3, 20])
def test_load_file_matches_reference(text_file, width):
    rows, vocab = load_file(text_file, max_words_per_line=width)
    jrows, jvocab = jload_file(text_file, max_words_per_line=width)
    assert rows.dtype == jrows.dtype == np.int32
    assert rows.shape == jrows.shape and rows.tobytes() == jrows.tobytes()
    assert vocab == jvocab
    # blank lines skipped, words lower-cased, short rows padded with -1
    assert rows.shape[0] == 5 and "fox" in vocab.values() and "Fox" not in vocab.values()
    assert (rows[rows >= 0] < len(vocab)).all()
    assert (rows == -1).any() == (width != 3)  # every line has 3 words or more


def test_tokenize_lines_edge_cases():
    for lines in ([], [""], ["   "], ["one"], ["A a A", "b"]):
        got, vocab = tokenize_lines(lines)
        want, jvocab = jtokenize_lines(lines)
        assert got.tobytes() == want.tobytes() and got.shape == want.shape
        assert vocab == jvocab


@pytest.mark.parametrize("engine", ["eager", "pallas"])
@pytest.mark.parametrize("target", ["hash", "dense"])
def test_wordcount_over_loaded_rows_matches_reference(text_file, engine, target):
    rows, vocab = load_file(text_file)
    kw = dict(engine=engine, target=target, vocab_size=len(vocab))
    got = wordcount(rows, session=BlazeSession(device="cpu"), **kw)
    want = jwordcount(rows, session=JaxSession(), **kw)
    if target == "hash":
        assert {k: int(v) for k, v in got.to_dict().items()} == \
            {k: int(v) for k, v in want.to_dict().items()}
        counts = got.to_dict()
    else:
        assert np.array_equal(got.cpu().numpy(), np.asarray(want))
        counts = dict(enumerate(got.cpu().numpy()))
    words = TEXT.lower().split()
    assert {vocab[k]: int(v) for k, v in counts.items()} == \
        {w: words.count(w) for w in set(words)}


def test_core_exports_every_reference_name():
    tcore = importlib.import_module("repro_torch.core")
    want = list(jcore.__all__)
    assert sorted(tcore.__all__) == sorted(want)
    for name in want:
        assert getattr(tcore, name) is not None, name
    from repro_torch.core import HostBlockStore, Plan, Program, load_file as lf  # noqa: F401
    assert lf is load_file
