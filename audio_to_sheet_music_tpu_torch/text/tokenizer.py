"""Prompt tokenisation for the CLAP text tower.

The reference uses HF ``RobertaTokenizerFast`` from ``laion/clap-htsat-unfused``
(`ATHTDemucs_v2.py:19,239`).  This module provides:

- ``RobertaBpeTokenizer`` — the real byte-level BPE from local files: a
  ``vocab.json`` + ``merges.txt`` pair is read by this module's own
  GPT-2 byte-level BPE (no extra package), a ``tokenizer.json`` by the
  ``tokenizers`` library.  Offline-friendly: no network, just files on
  disk.
- ``HashTokenizer`` — a deterministic fallback for environments without the
  vocab files (tests, random-weight benches): stable per-word ids in the
  RoBERTa id space with the same special-token framing (bos=0, eos=2, pad=1).
  NOT suitable for pretrained weights.

Both expose ``__call__(prompts) -> (input_ids, attention_mask)`` as padded
int32 numpy arrays, the contract ``models.clap_text`` consumes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

BOS, PAD, EOS = 0, 1, 2
VOCAB_SIZE = 50265
# RoBERTa position table is 514 rows with a 2-row offset -> 512 usable token
# positions; HF truncates to model_max_length, and so must we (ids past the
# table would silently gather the clamped last row on TPU).
MAX_TOKENS = 512


def _truncate(ids: List[int]) -> List[int]:
    if len(ids) <= MAX_TOKENS:
        return ids
    return ids[: MAX_TOKENS - 1] + [EOS]


def _pad_batch(seqs: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
    seqs = [_truncate(s) for s in seqs]
    max_len = max(len(s) for s in seqs)
    ids = np.full((len(seqs), max_len), PAD, np.int32)
    mask = np.zeros((len(seqs), max_len), np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask


class HashTokenizer:
    """Deterministic word-hash tokenizer (fallback; see module docstring)."""

    def __call__(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        seqs = []
        for p in prompts:
            ids = [BOS]
            for word in p.lower().split():
                h = int.from_bytes(
                    hashlib.sha256(word.encode()).digest()[:4], "little")
                ids.append(3 + h % (VOCAB_SIZE - 3))
            ids.append(EOS)
            seqs.append(ids)
        return _pad_batch(seqs)


def _bytes_to_unicode() -> dict:
    """GPT-2's byte -> printable character table of byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# GPT-2's pre-tokenisation: contractions, letter runs, digit runs, other
# symbol runs, each with one optional leading space, and whitespace
_PRE = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+"""
                  r"""| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""")


class _ByteLevelBpe:
    """Byte-level BPE over a ``vocab.json`` + ``merges.txt`` pair, with
    RoBERTa's ``<s> ... </s>`` framing."""

    def __init__(self, vocab: Path, merges: Path):
        self.vocab = json.loads(vocab.read_text(encoding="utf-8"))
        lines = merges.read_text(encoding="utf-8").splitlines()
        pairs = [tuple(x.split()) for x in lines
                 if x.strip() and not x.startswith("#version")]
        self.ranks = {p: i for i, p in enumerate(pairs)}
        self.byte_char = _bytes_to_unicode()
        self._cache: dict = {}

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            best = min(zip(parts, parts[1:]),
                       key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids = [BOS]
        for piece in _PRE.findall(text):
            word = "".join(self.byte_char[b] for b in piece.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self._bpe(word)
                       if t in self.vocab)
        ids.append(EOS)
        return ids


def write_bpe_vocab(texts: Sequence[str], out_dir: str | Path) -> Path:
    """Write a small byte-level ``vocab.json`` + ``merges.txt`` to
    ``out_dir``: the special tokens (``<s>`` 0, ``<pad>`` 1, ``</s>`` 2,
    ``<unk>`` 3), the 256 byte characters, and for every pre-token of
    ``texts`` the merges that build it left to right, so each of them
    encodes to one id.  For runs that need real BPE files offline (a
    converted checkpoint refuses the hash fallback); ids stay below
    ``VOCAB_SIZE``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    byte_char = _bytes_to_unicode()
    vocab = {"<s>": BOS, "<pad>": PAD, "</s>": EOS, "<unk>": 3}
    for c in byte_char.values():
        vocab.setdefault(c, len(vocab))
    merges: List[Tuple[str, str]] = []
    words = {"".join(byte_char[b] for b in piece.encode("utf-8"))
             for text in texts for piece in _PRE.findall(text)}
    for word in sorted(words):
        cur = word[0]
        for ch in word[1:]:
            if (cur, ch) not in merges:
                merges.append((cur, ch))
            cur += ch
            vocab.setdefault(cur, len(vocab))
    (out / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (out / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    return out


class RobertaBpeTokenizer:
    """The real RoBERTa BPE from local files (see the module docstring)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        if (path / "tokenizer.json").exists():
            from tokenizers import Tokenizer

            tok = Tokenizer.from_file(str(path / "tokenizer.json"))
            self._encode = lambda p: tok.encode(p).ids  # noqa: E731
        else:
            bpe = _ByteLevelBpe(path / "vocab.json", path / "merges.txt")
            self._encode = bpe.encode

    def __call__(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        return _pad_batch([self._encode(p) for p in prompts])


def default_tokenizer(vocab_path: str | Path | None = None,
                      require_real: bool = False):
    """Real BPE if vocab files are available, else the hash fallback.

    ``require_real=True`` (set when PRETRAINED weights are in play, e.g. a
    reference ``.pt`` checkpoint was imported) refuses the hash fallback:
    hashed ids would silently feed garbage text conditioning to a tower that
    was trained on real RoBERTa BPE ids (reference `ATHTDemucs_v2.py:19,239`).
    """
    candidates = []
    if vocab_path:
        candidates.append(Path(vocab_path))
    env = os.environ.get("ATSM_TOKENIZER_DIR")
    if env:
        candidates.append(Path(env))
    for c in candidates:
        if (c / "tokenizer.json").exists() or (c / "vocab.json").exists():
            return RobertaBpeTokenizer(c)
    if require_real:
        looked = ", ".join(str(c) for c in candidates) or "(none)"
        raise RuntimeError(
            "Pretrained weights are loaded but no real RoBERTa BPE vocabulary "
            f"was found (searched: {looked}). The HashTokenizer fallback "
            "would produce meaningless token ids for a pretrained checkpoint. "
            "Point ATSM_TOKENIZER_DIR (or vocab_path) at a directory holding "
            "tokenizer.json or vocab.json+merges.txt from "
            "laion/clap-htsat-unfused.")
    return HashTokenizer()
