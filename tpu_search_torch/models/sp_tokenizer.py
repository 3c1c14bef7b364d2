"""SentencePiece-unigram tokenizer for the XLM-RoBERTa encoder family.

The multilingual sentence-transformers models (paraphrase-multilingual-
mpnet-base-v2, paraphrase-multilingual-MiniLM-L12-v2, ...) are XLM-RoBERTa
encoders whose tokenizer is a SentencePiece **unigram** model — the
reference reaches it through sentence-transformers -> HF tokenizers
(reference: src/embeddings.py:86).  This module is the dependency-free
host-side replacement:

- Loads either the HF fast-tokenizer ``tokenizer.json`` (Unigram model) or
  the raw ``sentencepiece.bpe.model`` protobuf (parsed with a ~40-line
  varint reader — no protobuf/sentencepiece dependency), applying XLM-R's
  fairseq id remapping for the latter.
- Segmentation is unigram **Viterbi** (max log-prob path) over each
  whitespace word with the ``▁`` metaspace convention, matching HF
  ``tokenizers``' Unigram model including unknown-character penalties and
  consecutive-``<unk>`` fusing.
- When the ``tokenizers`` library is importable and a ``tokenizer.json``
  exists it is used as a fast path (it is the same Rust engine HF uses);
  the pure-Python path is the always-available reference implementation
  and the two are golden-tested for equality (tests/test_sp_tokenizer.py).

Deliberate deviation (documented, PARITY.md): normalization is NFKC +
whitespace collapse.  Real spm models carry a precompiled NMT-NFKC charsmap
whose output differs from NFKC on a handful of exotic codepoints; the fast
path applies the exact charsmap (the Rust engine reads it from
tokenizer.json), the pure path approximates with NFKC.
"""

from __future__ import annotations

import json
import struct
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["UnigramTokenizer", "parse_spm_model", "has_sp_assets"]

_SP_SPACE = "▁"  # ▁ metaspace marker
_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty


# ---------------------------------------------------------------------------
# Minimal protobuf reader for sentencepiece ModelProto
# ---------------------------------------------------------------------------


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


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wire}")
        yield field, wire, value


def parse_spm_model(data: bytes) -> List[Tuple[str, float, int]]:
    """sentencepiece ModelProto bytes -> [(piece, score, type), ...].

    ModelProto field 1 is the repeated ``SentencePiece`` message
    (piece: string = 1, score: float = 2, type: enum = 3; type 1 = NORMAL,
    2 = UNKNOWN, 3 = CONTROL).  Everything else (trainer/normalizer specs)
    is skipped.
    """
    pieces: List[Tuple[str, float, int]] = []
    for field, wire, value in _iter_fields(data):
        if field != 1 or wire != 2:
            continue
        piece, score, ptype = "", 0.0, 1
        for pfield, pwire, pvalue in _iter_fields(value):
            if pfield == 1 and pwire == 2:
                piece = pvalue.decode("utf-8")
            elif pfield == 2 and pwire == 5:
                score = struct.unpack("<f", pvalue)[0]
            elif pfield == 3 and pwire == 0:
                ptype = int(pvalue)
        pieces.append((piece, score, ptype))
    return pieces


def has_sp_assets(model_dir: Path) -> bool:
    """True when the model directory carries a sentencepiece-unigram
    tokenizer (and therefore no WordPiece vocab.txt)."""
    if (model_dir / "sentencepiece.bpe.model").exists():
        return True
    tok_json = model_dir / "tokenizer.json"
    if tok_json.exists() and not (model_dir / "vocab.txt").exists():
        try:
            spec = json.loads(tok_json.read_text())
            return spec.get("model", {}).get("type") == "Unigram"
        except (json.JSONDecodeError, UnicodeDecodeError):
            return False
    return False


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------


class UnigramTokenizer:
    """Unigram (max log-prob Viterbi) segmentation with ▁ word markers.

    ``vocab`` maps piece -> (id, score).  Ids are the final model-input id
    space (fairseq remapping already applied for raw spm loads).
    """

    def __init__(
        self,
        vocab: Dict[str, Tuple[int, float]],
        unk_id: int = 3,
        bos_id: int = 0,
        eos_id: int = 2,
        pad_id: int = 1,
        fast_path: Optional[str] = None,
    ) -> None:
        self.vocab = vocab
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.ids_to_pieces = {i: p for p, (i, _) in vocab.items()}
        self._max_piece_len = max((len(p) for p in vocab), default=1)
        scores = [s for _, s in vocab.values()]
        self._unk_score = (min(scores) if scores else 0.0) - _UNK_PENALTY

        # Optional Rust fast path (HF `tokenizers` is the engine the
        # reference itself runs under sentence-transformers).
        self._fast = None
        if fast_path:
            try:
                from tokenizers import Tokenizer  # type: ignore

                fast = Tokenizer.from_file(fast_path)
                fast.no_truncation()
                fast.no_padding()
                self._fast = fast
            except Exception:
                self._fast = None

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "UnigramTokenizer":
        model_dir = Path(model_dir)
        tok_json = model_dir / "tokenizer.json"
        if tok_json.exists():
            spec = json.loads(tok_json.read_text())
            if spec.get("model", {}).get("type") == "Unigram":
                return cls.from_tokenizer_json(spec, fast_path=str(tok_json))
        spm = model_dir / "sentencepiece.bpe.model"
        if spm.exists():
            return cls.from_spm_file(str(spm))
        raise FileNotFoundError(
            f"No unigram tokenizer (tokenizer.json / sentencepiece.bpe.model) "
            f"under {model_dir}"
        )

    @classmethod
    def from_tokenizer_json(
        cls, spec: Dict, fast_path: Optional[str] = None
    ) -> "UnigramTokenizer":
        """HF fast-tokenizer spec (model.type == "Unigram").  The vocab list
        index IS the final token id (the HF spm converter already folded in
        any offset)."""
        model = spec["model"]
        vocab: Dict[str, Tuple[int, float]] = {}
        for idx, (piece, score) in enumerate(model["vocab"]):
            vocab[piece] = (idx, float(score))
        unk_id = int(model.get("unk_id") or 3)

        def _special(content_options: Sequence[str], default: int) -> int:
            for content in content_options:
                if content in vocab:
                    return vocab[content][0]
            return default

        return cls(
            vocab,
            unk_id=unk_id,
            bos_id=_special(("<s>", "[CLS]"), 0),
            eos_id=_special(("</s>", "[SEP]"), 2),
            pad_id=_special(("<pad>", "[PAD]"), 1),
            fast_path=fast_path,
        )

    @classmethod
    def from_spm_file(cls, path: str) -> "UnigramTokenizer":
        """Raw sentencepiece model with XLM-R's fairseq remapping:
        final ids are ``{<s>:0, <pad>:1, </s>:2, <unk>:3}`` then spm pieces
        from index 3 shifted by +1 (HF XLMRobertaTokenizer semantics)."""
        pieces = parse_spm_model(Path(path).read_bytes())
        vocab: Dict[str, Tuple[int, float]] = {
            "<s>": (0, 0.0),
            "<pad>": (1, 0.0),
            "</s>": (2, 0.0),
            "<unk>": (3, 0.0),
        }
        offset = 1
        for spm_id, (piece, score, ptype) in enumerate(pieces):
            if spm_id < 3 or ptype != 1:  # specials / control rows
                continue
            vocab.setdefault(piece, (spm_id + offset, score))
        vocab.setdefault("<mask>", (len(pieces) + offset, 0.0))
        return cls(vocab, unk_id=3, bos_id=0, eos_id=2, pad_id=1)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- normalization + segmentation ----------------------------------------

    @staticmethod
    def _normalize(text: str) -> str:
        """NFKC + control-char removal + whitespace collapse (the NFKC
        approximation of spm's NMT-NFKC precompiled charsmap)."""
        text = unicodedata.normalize("NFKC", text)
        out: List[str] = []
        prev_space = True  # also strips leading whitespace
        for ch in text:
            cat = unicodedata.category(ch)
            if ch in ("\t", "\n", "\r") or cat == "Zs":
                if not prev_space:
                    out.append(" ")
                    prev_space = True
                continue
            if cat.startswith("C") or ord(ch) in (0, 0xFFFD):
                continue
            out.append(ch)
            prev_space = False
        while out and out[-1] == " ":
            out.pop()
        return "".join(out)

    def _viterbi(self, word: str) -> List[int]:
        """Max log-prob segmentation of one ▁-prefixed word.  Unknown
        characters cost ``min_score - 10`` (spm's unk penalty); consecutive
        unknowns fuse into one ``<unk>`` (HF ``fuse_unk`` semantics)."""
        n = len(word)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, Optional[int]]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        vocab = self.vocab
        max_len = self._max_piece_len
        for end in range(1, n + 1):
            has_single = False
            for start in range(max(0, end - max_len), end):
                if best[start] == NEG:
                    continue
                entry = vocab.get(word[start:end])
                if entry is not None:
                    if start == end - 1:
                        has_single = True
                    cand = best[start] + entry[1]
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, entry[0])
            if not has_single and best[end - 1] != NEG:
                # HF Unigram inserts the single-char <unk> edge whenever no
                # single-character piece covers this position — it competes
                # in the lattice like any other node (unigram/model.rs
                # populate_nodes), it is not just a dead-end rescue.
                cand = best[end - 1] + self._unk_score
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (end - 1, None)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, token_id = back[pos]
            ids.append(self.unk_id if token_id is None else token_id)
            pos = start
        ids.reverse()
        # fuse consecutive unks
        fused: List[int] = []
        for i in ids:
            if i == self.unk_id and fused and fused[-1] == self.unk_id:
                continue
            fused.append(i)
        return fused

    def tokenize(self, text: str) -> List[str]:
        """Text -> piece strings (debugging/tests)."""
        return [
            self.ids_to_pieces.get(i, "<unk>") for i in self._encode_core(text)
        ]

    def _encode_core(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self._normalize(text).split(" "):
            if word:
                ids.extend(self._viterbi(_SP_SPACE + word))
        return ids

    # -- encoding (same surface as WordPieceTokenizer) ------------------------

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """Text -> ``<s> ids </s>`` with truncation to ``max_length``."""
        if self._fast is not None:
            ids = self._fast.encode(text, add_special_tokens=False).ids
        else:
            ids = self._encode_core(text)
        if max_length is not None and len(ids) > max_length - 2:
            ids = ids[: max_length - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int = 384,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch encode -> (ids ``[B, S]`` int32, mask ``[B, S]`` int32)."""
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        width = max(pad_to if pad_to is not None else longest, 2)
        ids = np.full((len(encoded), width), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(encoded), width), dtype=np.int32)
        for row, seq in enumerate(encoded):
            seq = seq[:width]
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        return ids, mask

    def decode(self, ids: Iterable[int]) -> str:
        """Best-effort detokenization (debugging/tests)."""
        specials = {self.bos_id, self.eos_id, self.pad_id}
        text = "".join(
            self.ids_to_pieces.get(int(i), "")
            for i in ids
            if int(i) not in specials
        )
        return text.replace(_SP_SPACE, " ").strip()
