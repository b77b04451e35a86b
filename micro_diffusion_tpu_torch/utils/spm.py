"""Minimal SentencePiece unigram reader + tokenizer (no sentencepiece dependency).

The port's own copy of micro_diffusion_tpu/utils/spm.py. HF's T5 tokenizer needs
the ``sentencepiece`` C++ library, which the port does not depend on; this module
makes the DeepFloyd/t5-v1_1-xxl tokenize -> encode path self-contained:

  * ``read_model_proto`` parses the spiece.model protobuf with a hand-rolled
    wire-format reader (ModelProto field 1 = repeated SentencePiece{piece=1,
    score=2, type=3}); all other fields are skipped;
  * ``SentencePieceUnigram.encode`` runs the standard unigram Viterbi segmentation
    (max-score path over matching pieces, unknown-character fallback at
    min_score - 10, SentencePiece's unk penalty);
  * normalization approximates SentencePiece's nmt_nfkc: NFKC + whitespace collapse +
    the ``▁`` dummy-prefix convention (add_dummy_prefix / escape_whitespace). This is
    a documented deviation - byte-exact nmt_nfkc needs the vendored normalizer chart;
    for English captions NFKC is equivalent in practice.

``build_model_proto`` is the inverse serializer, used by tests to fabricate tiny
models without the sentencepiece trainer.
"""

import struct
import unicodedata
from typing import Dict, Iterator, List, Sequence, Tuple

WS = "▁"  # '▁' SentencePiece whitespace escape

# SentencePiece piece types
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3


# --------------------------------------------------------------- protobuf wire


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        yield field, wire, val


def read_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """spiece.model bytes -> [(piece, score, type)] in id order."""
    pieces = []
    for field, wire, val in _iter_fields(data):
        if field != 1 or wire != 2:
            continue  # trainer_spec / normalizer_spec / extensions: skipped
        piece, score, ptype = "", 0.0, TYPE_NORMAL
        for f, w, v in _iter_fields(val):
            if f == 1 and w == 2:
                piece = v.decode("utf-8")
            elif f == 2 and w == 5:
                score = struct.unpack("<f", v)[0]
            elif f == 3 and w == 0:
                ptype = int(v)
        pieces.append((piece, score, ptype))
    if not pieces:
        raise ValueError("no sentence pieces found: not a sentencepiece model?")
    return pieces


def build_model_proto(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """Inverse of read_model_proto (test fixture helper)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _write_varint((1 << 3) | 2) + _write_varint(len(pb)) + pb
        body += _write_varint((2 << 3) | 5) + struct.pack("<f", score)
        body += _write_varint((3 << 3) | 0) + _write_varint(ptype)
        out += _write_varint((1 << 3) | 2) + _write_varint(len(body)) + bytes(body)
    return bytes(out)


# ----------------------------------------------------------------- tokenizer


class SentencePieceUnigram:
    """Unigram-LM segmentation over a parsed piece table."""

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {
            p: i for i, (p, _, _) in enumerate(pieces)
        }
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == TYPE_UNKNOWN), 0
        )
        scores = [s for _, s, t in pieces if t == TYPE_NORMAL]
        min_score = min(scores) if scores else 0.0
        self._unk_score = min_score - 10.0  # sentencepiece's unk penalty
        self._max_piece_len = max((len(p) for p, _, _ in pieces), default=1)
        self._scores = {p: s for p, s, t in pieces if t != TYPE_CONTROL}

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            return cls(read_model_proto(f.read()))

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())  # collapse whitespace runs
        return WS + text.replace(" ", WS)  # add_dummy_prefix + escape

    def encode(self, text: str) -> List[int]:
        """Viterbi max-score segmentation into piece ids."""
        s = self.normalize(text)
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_len)
            for j in range(i + 1, hi + 1):
                sub = s[i:j]
                score = self._scores.get(sub)
                if score is not None:
                    cand = best[i] + score
                    if cand > best[j]:
                        best[j] = cand
                        back[j] = (i, self.piece_to_id[sub])
            # unknown single character fallback
            cand = best[i] + self._unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append(pid)
            j = i
        return ids[::-1]


class T5SpmTokenizer:
    """HF-T5Tokenizer-compatible surface over SentencePieceUnigram.

    T5 conventions: ids are the sentencepiece ids (<pad>=0, </s>=1, <unk>=2 in the
    released vocab); an EOS is appended, sequences pad to max_length with <pad>,
    attention_mask marks real tokens (reference utils.py:561-569 semantics).
    """

    def __init__(self, spm_path: str):
        self.sp = SentencePieceUnigram.from_file(spm_path)
        self.pad_id = self.sp.piece_to_id.get("<pad>", 0)
        self.eos_id = self.sp.piece_to_id.get("</s>", 1)

    def __call__(
        self,
        captions,
        padding: str = "max_length",
        max_length: int = 120,
        truncation: bool = True,
        return_attention_mask: bool = True,
        add_special_tokens: bool = True,
        return_tensors: str = "np",
    ):
        import numpy as np

        if isinstance(captions, str):
            captions = [captions]
        ids_batch = []
        for cap in captions:
            ids = self.sp.encode(cap)
            if add_special_tokens:
                if truncation:
                    ids = ids[: max_length - 1]
                ids = ids + [self.eos_id]
            elif truncation:
                ids = ids[:max_length]
            ids_batch.append(ids)
        out_ids = np.full((len(ids_batch), max_length), self.pad_id, np.int32)
        mask = np.zeros((len(ids_batch), max_length), np.int32)
        for i, ids in enumerate(ids_batch):
            out_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1
        return {"input_ids": out_ids, "attention_mask": mask}
