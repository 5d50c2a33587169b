"""GPT-2 byte-level BPE tokenizer (for OPT captioning), loaded from files.

The port's own copy of ``rlcf_tpu/tokenizer_gpt2.py``. The OPT models use
the GPT-2 byte-level BPE with OPT special tokens (pad=1 ``<pad>``, bos=eos=2
``</s>``); the HF tokenizer prepends BOS. No vocabulary is bundled (the
assets ship with OPT checkpoints: supply ``vocab.json`` + ``merges.txt``
paths); tests build synthetic vocabularies.

The word split is GPT-2's pattern
``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
written as a scanner over unicode categories (``split_words``), so the port
needs only the standard library (no third-party ``regex`` module). Letters
and numbers are the categories of this Python's ``unicodedata``; a character
assigned in a later Unicode version than it knows may split differently.

Reference usage: `caption/capdec_tta.py:111-119` (padding + attention mask),
`caption/image_llm/models/generate_opt.py:53` (newline EOS lookup).
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_space(ch: str) -> bool:
    """The ``regex`` module's ``\\s``: ``str.isspace`` but for the four
    information separators U+001C..U+001F."""
    return ch.isspace() and not "\x1c" <= ch <= "\x1f"


def _is_other(ch: str) -> bool:
    return not (_is_space(ch) or _is_letter(ch) or _is_number(ch))


def split_words(text: str) -> List[str]:
    """GPT-2's word split (see the module docstring), left to right, the
    first matching alternative winning: the same pieces as the regex."""
    words: List[str] = []
    i, n = 0, len(text)

    def run(j, pred):
        while j < n and pred(text[j]):
            j += 1
        return j

    while i < n:
        contraction = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if contraction is not None:
            j = i + len(contraction)
        else:
            start = i + 1 if text[i] == " " and i + 1 < n and not _is_space(text[i + 1]) else i
            ch = text[start]
            if _is_letter(ch):
                j = run(start, _is_letter)
            elif _is_number(ch):
                j = run(start, _is_number)
            elif not _is_space(ch):
                j = run(start, _is_other)
            else:   # a whitespace run: all of it at the end, else all but its last (which leads the next piece)
                end = run(i, _is_space)
                j = end if end == n or end - i == 1 else end - 1
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache()
def _byte_to_unicode():
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


def find_tokenizer_assets() -> Optional[Tuple[str, str]]:
    """Locate GPT-2/OPT ``vocab.json`` + ``merges.txt`` without flags.

    The vocabulary is learned data (~1 MB) that cannot be synthesized, so it
    is discovered rather than bundled. Search order:

    1. ``RLCF_GPT2_VOCAB`` / ``RLCF_GPT2_MERGES`` environment variables,
    2. ``rlcf_torch/assets/gpt2/`` (where a copy of the files may be put),
    3. the HuggingFace hub cache (``HF_HOME``/``~/.cache/huggingface``) for
       any model snapshot carrying both files (opt-125m, gpt2, ...).

    Returns (vocab_path, merges_path) or None.
    """
    import glob

    v, m = os.environ.get("RLCF_GPT2_VOCAB"), os.environ.get("RLCF_GPT2_MERGES")
    if v and m and os.path.isfile(v) and os.path.isfile(m):
        return v, m

    bundled = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "gpt2")
    if os.path.isfile(os.path.join(bundled, "vocab.json")) and os.path.isfile(os.path.join(bundled, "merges.txt")):
        return os.path.join(bundled, "vocab.json"), os.path.join(bundled, "merges.txt")

    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    for vocab in sorted(glob.glob(os.path.join(hf_home, "hub", "models--*", "snapshots", "*", "vocab.json"))):
        merges = os.path.join(os.path.dirname(vocab), "merges.txt")
        if os.path.isfile(merges) and _is_gpt2_vocab(vocab):
            return vocab, merges
    return None


def _is_gpt2_vocab(vocab_path: str) -> bool:
    """True iff ``vocab_path`` is a GPT-2/OPT byte-level BPE vocabulary: the
    HF cache may also hold CLIP's incompatible 49,408-entry BPE (word-final
    ``</w>`` markers, no ``Ġ`` space prefix), which would tokenize silently
    wrong, so gate on the GPT-2 vocab size and a known byte-level token."""
    try:
        with open(vocab_path) as fh:
            vocab = json.load(fh)
    except (OSError, ValueError):
        return False
    # OPT re-indexes ids, so check token presence, not a specific id.
    return len(vocab) >= 50257 and "Ġthe" in vocab


def load_gpt2_tokenizer(vocab_path: Optional[str] = None, merges_path: Optional[str] = None,
                        **kwargs) -> "Gpt2Tokenizer":
    """Build a tokenizer from explicit paths or auto-discovered assets."""
    if not (vocab_path and merges_path):
        found = find_tokenizer_assets()
        if found is None:
            raise FileNotFoundError(
                "GPT-2/OPT tokenizer assets not found. Pass --opt_vocab/--opt_merges, set "
                "RLCF_GPT2_VOCAB/RLCF_GPT2_MERGES, or put vocab.json and merges.txt in rlcf_torch/assets/gpt2/."
            )
        vocab_path, merges_path = found
    return Gpt2Tokenizer(vocab_path, merges_path, **kwargs)


class Gpt2Tokenizer:
    """Byte-level BPE with OPT conventions (BOS prepended, pad=1)."""

    def __init__(self, vocab_path: str, merges_path: str, bos_id: int = 2, pad_id: int = 1):
        with open(vocab_path) as fh:
            self.token_to_id = json.load(fh)
        self.id_to_token = {v: k for k, v in self.token_to_id.items()}
        with open(merges_path) as fh:
            lines = [ln for ln in fh.read().split("\n") if ln and not ln.startswith("#")]
        self._ranks = {tuple(ln.split()): i for i, ln in enumerate(lines)}
        self._b2u = _byte_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._cache: dict = {}
        self.bos_id = bos_id
        self.pad_id = pad_id

    def _bpe(self, piece: str) -> Tuple[str, ...]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        symbols = tuple(piece)
        while len(symbols) > 1:
            best = None
            best_rank = None
            for pair in zip(symbols[:-1], symbols[1:]):
                r = self._ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(symbols):
                if i < len(symbols) - 1 and symbols[i] == first and symbols[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            symbols = tuple(out)
        self._cache[piece] = symbols
        return symbols

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        for word in split_words(text):
            mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
            for sym in self._bpe(mapped):
                tid = self.token_to_id.get(sym)
                if tid is not None:
                    ids.append(tid)
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special and i in (self.bos_id, self.pad_id):
                continue
            tok = self.id_to_token.get(i)
            if tok is not None:
                toks.append(tok)
        text = "".join(toks)
        raw = bytearray(self._u2b[ch] for ch in text if ch in self._u2b)
        return raw.decode("utf-8", errors="replace")

    def batch_encode(self, texts: Sequence[str], pad_to: int | None = None, return_lengths: bool = False):
        """-> (ids [N, L] int32 padded with pad_id, mask [N, L] int32[, true lengths]).

        ``return_lengths`` also yields each text's UNTRUNCATED token count so
        callers can detect pad_to overflow without re-encoding.
        """
        encoded = [self.encode(t) for t in texts]
        L = pad_to or max(len(e) for e in encoded)
        ids = np.full((len(texts), L), self.pad_id, np.int32)
        mask = np.zeros((len(texts), L), np.int32)
        lengths = [len(e) for e in encoded]
        for i, e in enumerate(encoded):
            e = e[:L]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        if return_lengths:
            return ids, mask, lengths
        return ids, mask

    def batch_decode(self, ids_batch, stop_id: int | None = None) -> List[str]:
        out = []
        for row in np.asarray(ids_batch):
            row = row.tolist()
            if stop_id is not None and stop_id in row:
                row = row[: row.index(stop_id)]
            out.append(self.decode(row).strip())
        return out
