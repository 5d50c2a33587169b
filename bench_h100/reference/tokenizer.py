"""CLIP byte-pair-encoding tokenizer (host-side, pure Python), frozen with
the benchmark's reference.

The OpenAI CLIP
``SimpleTokenizer`` behaviour (lower-cased, whitespace-collapsed text split
into words, each byte-mapped to printable unicode and merged with the 48k
learned BPE merges; ``tokenize`` wraps ids in <|startoftext|>/<|endoftext|>
and zero-pads to 77). The merge table is the released CLIP vocabulary file,
read as raw data from the repository (``VOCAB``).

The word split is CLIP's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
written as a scanner over unicode categories, so it needs only the
standard library's ``unicodedata`` (no third-party ``regex`` module).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


# the released CLIP merge table, a data file that the program reads too
VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "rlcf_torch",
                     "assets", "bpe_simple_vocab_16e6.txt.gz")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def split_words(text: str) -> List[str]:
    """CLIP's word split (see the module docstring), left to right, first
    matching alternative wins — the same result as the regex."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        for special in _SPECIALS:
            if text.startswith(special, i):
                words.append(special)
                i += len(special)
                break
        else:
            low = text[i:i + 3].lower()
            contraction = next((c for c in _CONTRACTIONS if low.startswith(c)), None)
            ch = text[i]
            if contraction is not None:
                words.append(text[i:i + len(contraction)])
                i += len(contraction)
            elif _is_letter(ch):
                j = i + 1
                while j < n and _is_letter(text[j]):
                    j += 1
                words.append(text[i:j])
                i = j
            elif _is_number(ch):
                words.append(ch)
                i += 1
            elif ch.isspace():
                i += 1
            else:
                j = i + 1
                while j < n and not (text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])):
                    j += 1
                words.append(text[i:j])
                i = j
    return words


@functools.lru_cache()
def _byte_to_unicode() -> dict:
    """Map raw bytes to printable unicode chars (GPT-2 scheme, reversible)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapped = printable[:]
    offset = 0
    for byte in range(256):
        if byte not in printable:
            printable.append(byte)
            mapped.append(256 + offset)
            offset += 1
    return {b: chr(c) for b, c in zip(printable, mapped)}


def _normalize_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = unicodedata.normalize("NFC", text)
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """BPE tokenizer producing OpenAI-CLIP-compatible token ids (vocab 49408)."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or VOCAB
        self._b2u = _byte_to_unicode()

        with gzip.open(vocab_path, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # Header line + exactly 48894 merges used by the released CLIP vocab.
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]

        base = list(self._b2u.values())
        tokens: List[str] = base + [t + "</w>" for t in base]
        tokens.extend("".join(m) for m in merges)
        tokens.extend(_SPECIALS)

        self.token_to_id = {tok: i for i, tok in enumerate(tokens)}
        self._merge_rank = {m: i for i, m in enumerate(merges)}
        self._cache = {s: (s,) for s in _SPECIALS}
        self.sot_id = self.token_to_id["<|startoftext|>"]
        self.eot_id = self.token_to_id["<|endoftext|>"]

    def _apply_bpe(self, piece: str) -> tuple:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        symbols = tuple(piece[:-1]) + (piece[-1] + "</w>",)
        while len(symbols) > 1:
            # merge the lowest-rank adjacent pair, everywhere it occurs
            ranked = [(self._merge_rank[p], p) for p in zip(symbols[:-1], symbols[1:]) if p in self._merge_rank]
            if not ranked:
                break
            first, second = min(ranked)[1]
            merged: List[str] = []
            i, n = 0, len(symbols)
            while i < n:
                if i < n - 1 and symbols[i] == first and symbols[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = tuple(merged)
        self._cache[piece] = symbols
        return symbols

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in split_words(_normalize_text(text).lower()):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            ids.extend(self.token_to_id[sym] for sym in self._apply_bpe(mapped))
        return ids


@functools.lru_cache()
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """Tokenize text(s) into an int32 [N, context_length] array: <sot> ids
    <eot>, zero padding; over-length sequences raise unless ``truncate``, in
    which case the last position is forced to <eot>."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
            ids = ids[:context_length]
            ids[-1] = tok.eot_id
        out[row, : len(ids)] = ids
    return out
