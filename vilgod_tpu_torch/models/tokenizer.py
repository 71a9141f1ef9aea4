"""Byte-pair-encoding tokenizer for CLIP text prompts; the port's own copy
of ``vilgod_tpu/models/tokenizer.py`` (numpy only).

The public BPE scheme of OpenAI CLIP: byte->unicode remapping, lowercase
and whitespace cleanup, a greedy merge loop over a ranked merge table,
``</w>`` word-end markers, ``<|startoftext|>``/``<|endoftext|>`` specials,
context length 77. The merge table ships with the CLIP checkpoint
(``bpe_simple_vocab_16e6.txt.gz``); pass its path at construction. The
pipeline tokenizes its 24 fixed class prompts once at startup, so
tokenization is never hot. :class:`HashTokenizer` stands in when no table
is available.
"""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path

import numpy as np


@lru_cache()
def bytes_to_unicode():
    """GPT-2 byte -> printable unicode mapping (public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_WORD_RE = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[^\W\d_]+|\d|[^\s\w]+""",
    re.IGNORECASE,
)


class ClipTokenizer:
    def __init__(self, bpe_path: str | Path):
        merges = gzip.open(str(bpe_path), "rt", encoding="utf-8").read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids = []
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def tokenize(self, texts: list[str], context_length: int = 77) -> np.ndarray:
        """-> (len(texts), context_length) int32, SOT ... EOT zero-padded
        (clip.tokenize, third_party/CLIP/clip/clip.py:195-237)."""
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when no BPE table is available (tests,
    random-weight smoke runs): hashes whitespace words to stable ids."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def tokenize(self, texts: list[str], context_length: int | None = None) -> np.ndarray:
        import hashlib

        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot]
            for w in re.sub(r"\s+", " ", text.lower()).strip().split(" "):
                h = int(hashlib.md5(w.encode()).hexdigest(), 16)
                ids.append(h % (self.vocab_size - 2))
            ids.append(self.eot)
            out[i, : min(len(ids), ctx)] = ids[:ctx]
        return out
