"""CLIP's byte-level BPE tokenizer, in pure Python: a frozen copy of the port's
``micro_diffusion_tpu_torch/utils/clip_bpe.py``, so that the reference tokenizes the
captions on its own. ``write_bpe_vocab`` writes the vocabulary a sampling run makes
from its caption pool; both sides read those files.

The port's notes on the tokenizer follow.

CLIP's byte-level BPE tokenizer over an HF tokenizer directory, in pure Python.

The JAX package tokenizes CLIP captions with ``transformers.CLIPTokenizer``
(micro_diffusion_tpu/models/text_encoders.py:470); the port does not depend on
transformers, so this module reproduces that tokenizer's behaviour on the same
files (``vocab.json``, ``merges.txt``, and the pad token of
``special_tokens_map.json`` / ``tokenizer_config.json`` where present), as
transformers runs it without ``ftfy``:

  * the text is split on the special tokens first (bos, eos, unk, pad), as
    transformers' added-token trie does;
  * each other piece is cleaned as transformers' ``BasicTokenizer(strip_accents=
    False, do_split_on_punc=False)`` does: control characters dropped, whitespace
    runs collapsed to one space, CJK ideographs spaced, NFC, lowercased;
  * the pieces of the pattern ``'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
    are found by a scanner over Unicode categories (Python's ``re`` has no
    ``\\p{...}``), byte-encoded, and merged by rank (``bpe``);
  * ``<|startoftext|>`` + ids + ``<|endoftext|>``, truncated to and padded to the
    maximum length (77).

``write_bpe_vocab`` learns a small merge table from a list of texts and writes such a
directory: tests and the card's smoke script tokenize through it, since no released
vocabulary is in the repository.
"""

import collections
import json
import os
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_MAX_MERGES = 49152 - 256 - 2  # transformers reads merges.txt lines [1, 48895)


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
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


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' BasicTokenizer(strip_accents=False, do_split_on_punc=False),
    joined with single spaces: what CLIPTokenizer does without ftfy."""
    out = []
    for ch in text:
        cp = ord(ch)
        cat = unicodedata.category(ch)
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or cat.startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(" ".join(w.lower() for w in words).split())


def _letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def pre_tokenize(text: str) -> List[str]:
    """The matches of CLIP's pattern (after the special tokens were split off):
    contractions, letter runs, single numbers, runs of anything else but spaces."""
    out, i, n = [], 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if hit is not None:
            j = i + len(hit)
        elif _letter(ch):
            j = i + 1
            while j < n and _letter(text[j]):
                j += 1
        elif _number(ch):
            j = i + 1
        else:
            j = i + 1
            while j < n and not (text[j].isspace() or _letter(text[j]) or _number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _pairs(word: Tuple[str, ...]) -> set:
    return set(zip(word, word[1:]))


def _word(token: str) -> Tuple[str, ...]:
    return tuple(token[:-1]) + (token[-1] + "</w>",)


def _merge(word: Tuple[str, ...], first: str, second: str) -> Tuple[str, ...]:
    out, i = [], 0
    while i < len(word):
        if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
            out.append(first + second)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


def _read_pad_token(tokenizer_dir: str) -> str:
    for name in ("special_tokens_map.json", "tokenizer_config.json"):
        path = os.path.join(tokenizer_dir, name)
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                pad = json.load(f).get("pad_token")
            if isinstance(pad, dict):
                pad = pad.get("content")
            if pad:
                return pad
    return EOS


class CLIPBPETokenizer:
    """transformers' CLIPTokenizer on the files of ``tokenizer_dir``; a call returns
    what it returns with ``padding='max_length', truncation=True,
    return_tensors='np'``."""

    def __init__(self, tokenizer_dir: str):
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:_MAX_MERGES + 1]
        self.bpe_ranks = {tuple(line.split()): i for i, line in enumerate(lines)}
        self.byte_encoder = bytes_to_unicode()
        self.pad_token = _read_pad_token(tokenizer_dir)
        # longest first, so that a special token inside another one is not split off
        self.specials = sorted({BOS, EOS, self.pad_token}, key=len, reverse=True)
        self.cache: Dict[str, Tuple[str, ...]] = {}

    def bpe(self, token: str) -> Tuple[str, ...]:
        """Merge a byte-encoded piece by rank, lowest first, until no pair is ranked."""
        if token in self.cache:
            return self.cache[token]
        word = _word(token)
        pairs = _pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            word = _merge(word, *bigram)
            pairs = _pairs(word) if len(word) > 1 else set()
        self.cache[token] = word
        return word

    def _split_specials(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is_special) in order: the text cut at each special token."""
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((s for s in self.specials if text.startswith(s, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((hit, True))
            i = start = i + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for piece, special in self._split_specials(text):
            if special:
                tokens.append(piece)
                continue
            for tok in pre_tokenize(basic_clean(piece)):
                tokens.extend(self.bpe("".join(self.byte_encoder[b]
                                               for b in tok.encode("utf-8"))))
        return tokens

    def encode(self, text: str) -> List[int]:
        """Token ids without the special tokens; unknown tokens map to eos (unk)."""
        unk = self.encoder[EOS]
        return [self.encoder.get(t, unk) for t in self.tokenize(text)]

    def __call__(self, captions, max_length: int = 77) -> Dict[str, np.ndarray]:
        if isinstance(captions, str):
            captions = [captions]
        ids = np.full((len(captions), max_length), self.encoder[self.pad_token], np.int64)
        mask = np.zeros((len(captions), max_length), np.int64)
        for row, cap in enumerate(captions):
            toks = ([self.encoder[BOS]] + self.encode(cap)[:max_length - 2]
                    + [self.encoder[EOS]])
            ids[row, :len(toks)] = toks
            mask[row, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def write_bpe_vocab(texts: Iterable[str], out_dir: str, num_merges: int = 200) -> str:
    """Learn ``num_merges`` BPE merges from ``texts`` (most frequent pair first,
    ties by the pair itself) and write ``vocab.json`` / ``merges.txt`` in CLIP's
    layout (the 256 byte characters, the same with ``</w>``, the merged tokens, then
    bos and eos) into ``out_dir``, which it returns."""
    byte_enc = bytes_to_unicode()
    counts = collections.Counter(
        _word("".join(byte_enc[b] for b in tok.encode("utf-8")))
        for text in texts for tok in pre_tokenize(basic_clean(text)))
    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pair_counts: collections.Counter = collections.Counter()
        for word, c in counts.items():
            for pair in zip(word, word[1:]):
                pair_counts[pair] += c
        if not pair_counts:
            break
        best = min(pair_counts, key=lambda p: (-pair_counts[p], p))
        merges.append(best)
        merged: collections.Counter = collections.Counter()
        for word, c in counts.items():
            merged[_merge(word, *best)] += c
        counts = merged
    symbols: Sequence[str] = list(byte_enc.values())
    vocab = list(symbols) + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
    vocab += [BOS, EOS]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(dict.fromkeys(vocab))}, f,
                  ensure_ascii=False)
    with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return out_dir
