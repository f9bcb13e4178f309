"""CLIP BPE tokenizer (a copy of arp_tpu/models/clip/tokenizer.py, so the port imports no JAX).

Byte-pair encoding identical in algorithm to OpenAI's SimpleTokenizer.
Given the original ``bpe_simple_vocab_16e6.txt.gz`` merges file it reproduces
CLIP token ids exactly; without that file, a deterministic byte-level
fallback vocabulary keeps the pipeline runnable (ids then differ from
OpenAI's, and the tokenizer's identity says "fallback").

Set ``ARP_TPU_BPE_PATH`` or pass ``bpe_path`` to use the real merges file.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Optional, Sequence, Union
import warnings

import numpy as np

MAX_TEXT_LENGTH = 77
BPE_FILENAME = "bpe_simple_vocab_16e6.txt.gz"
# The port's own vendor point (assets/README.md): it reads no file of the JAX package.
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


def resolve_asset(filename: str, explicit: Optional[str] = None,
                  env_var: Optional[str] = None) -> Optional[str]:
    """Local path of a tokenizer asset, or None if absent everywhere.

    The lookup of the JAX package's models/clip/download.py::resolve_asset, without
    its fetcher: the explicit path, the env var, the port's vendored
    ``arp_tpu_torch/assets/`` directory, then the ``~/.cache/arp_tpu`` cache (which
    the JAX package's fetcher fills).  Never touches the network.
    """
    candidates = [explicit]
    if env_var:
        candidates.append(os.environ.get(env_var))
    candidates.append(os.path.join(ASSETS_DIR, filename))
    cache = os.environ.get("ARP_TPU_CHECKPOINT_DIR", os.path.expanduser("~/.cache/arp_tpu"))
    candidates.append(os.path.join(cache, filename))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None

# OpenAI's pattern uses regex-module classes \p{L}/\p{N}; stdlib-re
# equivalents: [^\W\d_] = unicode letter, \d = unicode decimal digit
# (Nd — \p{N}'s rare Nl/No extras are the one divergence), and the
# punctuation run must re-include "_" which \w claims.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # (the original also runs ftfy.fix_text; inputs here are clean ASCII
    # instructions so html-unescape + strip matches its output)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class BPETokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges: list[tuple[str, str]] = []
        self.using_fallback_vocab = True
        # identity string for provenance stamps (labeled HDF5 files carry it
        # so downstream consumers can tell which vocab produced the rewards)
        self.identity = "fallback"
        if bpe_path is not None and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # original file: first line is a comment, merges at 1:49152-256-2+1
            merge_lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in merge_lines if m.strip()]
            self.using_fallback_vocab = False
            import hashlib

            with open(bpe_path, "rb") as f:
                self.identity = "bpe:" + hashlib.sha256(f.read()).hexdigest()[:16]
        else:
            warnings.warn(
                "CLIP BPE merges file not found: using the deterministic "
                "byte-level FALLBACK vocabulary. Token ids will NOT match "
                "OpenAI CLIP — text embeddings from pretrained checkpoints "
                "will be wrong. Set ARP_TPU_BPE_PATH (or pass bpe_path) to "
                "the original bpe_simple_vocab_16e6.txt.gz for exact ids. "
                "The port looks in arp_tpu_torch/assets/, not in the JAX "
                "package's assets: a file vendored only there is not read, "
                "while ARP_TPU_BPE_PATH is read by both packages.",
                stacklevel=2,
            )

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.vocab_size = len(vocab)
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


def tokenize(
    texts: Union[str, Sequence[str]],
    tokenizer: BPETokenizer,
    context_length: int = MAX_TEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """SOT + bpe + EOT, zero-padded to context_length (one row per text)."""
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tokenizer.sot_token] + tokenizer.encode(text) + [tokenizer.eot_token]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[: context_length - 1] + [tokenizer.eot_token]
            else:
                raise RuntimeError(f"Input {text!r} too long for context length {context_length}")
        result[i, : len(tokens)] = np.asarray(tokens)
    return result


def build_tokenizer(bpe_path: Optional[str] = None, truncate: bool = False):
    """Returns a tokenize fn: texts -> (n, 77) int32 ids.

    Merges-file resolution (first hit wins): explicit ``bpe_path``,
    ``ARP_TPU_BPE_PATH``, the vendored ``arp_tpu_torch/assets/`` dir, the
    ``~/.cache/arp_tpu`` cache.  Exact OpenAI ids whenever any source is
    present; loud fallback vocab otherwise.
    """
    bpe_path = resolve_asset(BPE_FILENAME, explicit=bpe_path, env_var="ARP_TPU_BPE_PATH")
    tok = BPETokenizer(bpe_path)
    fn = functools.partial(tokenize, tokenizer=tok, context_length=MAX_TEXT_LENGTH, truncate=truncate)
    fn.tokenizer = tok
    return fn


class Char97Tokenizer:
    """Deterministic toy char-level tokenizer over a 97-id vocabulary.

    Not a CLIP tokenizer: this backs tiny-CLIP engines whose text tower was
    trained from scratch against these ids.  Engine specs written by
    ``arp_tpu``'s ``ClipRewardEngine.save_npz`` reference it by tag, and
    ``ClipRewardEngine.from_npz`` rebuilds it from that tag.
    """

    identity = "char97"

    def __init__(self):
        # ClipRewardEngine.tokenizer_identity reads .tokenizer.identity
        self.tokenizer = self

    def __call__(self, texts, context_length: int = MAX_TEXT_LENGTH):
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [90] + [1 + (ord(c) % 80) for c in t[: context_length - 47]] + [96]
            out[i, : len(ids)] = ids
        return out
