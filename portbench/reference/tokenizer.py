"""CLIP's tokenizer without a merges file: SimpleTokenizer's byte-level vocabulary (256 bytes, the same
with "</w>", then start and end of text) and its pre-tokenizing pattern, so every word is its bytes with
"</w>" on the last.  Ids: start of text 512, end of text 513, zero-padded to 77."""

from __future__ import annotations

import html
import re

import numpy as np

_PAT = re.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
                  re.IGNORECASE)


def _byte_order() -> list:
    """Bytes in SimpleTokenizer's order: the printable ranges first, then the rest."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    return bs + [b for b in range(256) if b not in bs]


def tokenize(text: str, context_length: int = 77) -> np.ndarray:
    """(1, context_length) int64 ids of ``text``."""
    rank = {b: i for i, b in enumerate(_byte_order())}
    text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).strip().lower()
    ids = [512]
    for word in re.findall(_PAT, text):
        raw = word.encode("utf-8")
        ids += [rank[b] for b in raw[:-1]] + [256 + rank[raw[-1]]]
    ids = ids[: context_length - 1] + [513]
    out = np.zeros((1, context_length), np.int64)
    out[0, : len(ids)] = ids
    return out
