"""Text loading and tokenization: the paper's ``load_file`` utility.

The counterpart of ``repro/data/text.py`` (numpy only, its own copy).
``load_file(path)`` reads a text file into fixed-width rows of int32 word
ids (padding -1), ready for ``distribute`` and the word-count mapper, and
the id -> word vocabulary for decoding results: the fixed-shape form of the
paper's "distributed vector of lines".  Words are interned on the host in
first-seen order, so ids are dense and the hash map stays small.
"""
from __future__ import annotations

import numpy as np


def tokenize_lines(lines: list[str], *, max_words_per_line: int | None = None
                   ) -> tuple[np.ndarray, dict[int, str]]:
    """Lines -> ``(rows [n_lines, width] int32, vocab)``: words split on
    whitespace and lower-cased, ``width`` the longest line (or
    ``max_words_per_line``, longer lines cut), short rows padded with -1."""
    vocab: dict[str, int] = {}
    toks: list[list[int]] = []
    for line in lines:
        row = []
        for w in line.split():
            w = w.strip().lower()
            if not w:
                continue
            if w not in vocab:
                vocab[w] = len(vocab)
            row.append(vocab[w])
        toks.append(row)
    width = max_words_per_line or max((len(r) for r in toks), default=1)
    out = np.full((len(toks), max(width, 1)), -1, np.int32)
    for i, r in enumerate(toks):
        out[i, : min(len(r), width)] = r[:width]
    return out, {i: w for w, i in vocab.items()}


def load_file(path: str, *, max_words_per_line: int | None = None
              ) -> tuple[np.ndarray, dict[int, str]]:
    """The paper's ``blaze::util::load_file``: a text file (blank lines
    skipped) -> ``(token rows, vocab)``."""
    with open(path, "r", errors="replace") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return tokenize_lines(lines, max_words_per_line=max_words_per_line)
