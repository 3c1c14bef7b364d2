"""Byte-level BPE tokenizer (the RoBERTa/DistilRoBERTa family).

Dependency-free GPT-2-style byte-level BPE, completing tokenizer coverage
of the sentence-transformers model zoo next to WordPiece (MPNet/BERT,
models/tokenizer.py) and sentencepiece-unigram (XLM-R,
models/sp_tokenizer.py).  The reference runs these models through HF
``tokenizers`` (Rust) inside sentence-transformers (the reference's
src/embeddings.py:86-97); here the pure-Python engine is
golden-tested id-for-id against that Rust engine
(tests/test_bpe_tokenizer.py), and when the ``tokenizers`` package is
importable it serves as a fast path — the same split as the unigram
tokenizer.

Loads either the HF fast-tokenizer ``tokenizer.json`` (model.type ==
"BPE" with a ByteLevel pre-tokenizer — what all-distilroberta-v1 ships)
or the legacy ``vocab.json`` + ``merges.txt`` pair.

The pre-tokenizer reimplements the GPT-2 split pattern
``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``
as an explicit scanner (no ``regex`` dependency): contractions first at
each start position, a single leading space may attach to a
letter/number/punctuation run, and a whitespace run before a token yields
all but its last character (which attaches to the next token when it is
a plain space).
"""

from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ByteLevelBPETokenizer", "has_bpe_assets", "bytes_to_unicode"]


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char table."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


def has_bpe_assets(model_dir: Path) -> bool:
    """True when the model directory carries a byte-level BPE tokenizer
    (RoBERTa family) rather than WordPiece/unigram assets."""
    model_dir = Path(model_dir)
    if (model_dir / "vocab.json").exists() and (
        model_dir / "merges.txt"
    ).exists():
        return True
    tok_json = model_dir / "tokenizer.json"
    if tok_json.exists():
        try:
            spec = json.loads(tok_json.read_text())
            return spec.get("model", {}).get("type") == "BPE"
        except (json.JSONDecodeError, UnicodeDecodeError):
            return False
    return False


# -- GPT-2 pre-tokenizer -------------------------------------------------

# Case-sensitive, longest first (the pattern's alternation order makes
# 're/'ve/'ll win over 's at the same position anyway — lengths differ).
_CONTRACTIONS = ("'re", "'ve", "'ll", "'s", "'t", "'m", "'d")


def _is_space(c: str) -> bool:
    r"""Unicode White_Space, matching the regex ``\s`` class: Python's
    ``str.isspace()`` additionally accepts U+001C-001F (file/group/
    record/unit separators, category Cc), which the Rust engine treats
    as punctuation — they must ride the ``[^\s\p{L}\p{N}]+`` run."""
    return c.isspace() and c not in "\x1c\x1d\x1e\x1f"


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _pretokenize(text: str) -> List[str]:
    """Split per the GPT-2 pattern (see module docstring)."""
    toks: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            for suf in _CONTRACTIONS:
                if text.startswith(suf, i):
                    toks.append(suf)
                    i += len(suf)
                    break
            else:
                # Plain apostrophe: starts a punctuation run below.
                i = _consume_run(text, i, i, toks)
            continue
        if _is_space(c):
            j = i
            while j < n and _is_space(text[j]):
                j += 1
            if j == n:
                toks.append(text[i:j])  # trailing whitespace, whole run
                i = j
            elif j - i >= 2:
                # \s+(?!\S): all but the last whitespace char; the loop
                # re-enters on that last char (it may attach to the next
                # token when it is a plain space).
                toks.append(text[i : j - 1])
                i = j - 1
            elif c == " ":
                # " X": the optional leading space of the next run.
                i = _consume_run(text, i, i + 1, toks)
            else:
                toks.append(c)  # e.g. "\n" directly before a token
                i += 1
            continue
        i = _consume_run(text, i, i, toks)
    return toks


def _consume_run(text: str, start: int, first: int, toks: List[str]) -> int:
    """Consume ` ?(\\p{L}+|\\p{N}+|[^\\s\\p{L}\\p{N}]+)` where ``first``
    indexes the run's first non-space char; appends the token (including
    the optional leading space at ``start``) and returns the new cursor."""
    n = len(text)
    c = text[first]
    j = first
    if _is_letter(c):
        while j < n and _is_letter(text[j]):
            j += 1
    elif _is_number(c):
        while j < n and _is_number(text[j]):
            j += 1
    else:
        while (
            j < n
            and not _is_space(text[j])
            and not _is_letter(text[j])
            and not _is_number(text[j])
        ):
            j += 1
    toks.append(text[start:j])
    return j


# -- tokenizer ------------------------------------------------------------


class ByteLevelBPETokenizer:
    """Byte-level BPE with RoBERTa post-processing (``<s> ids </s>``).

    Same interface contract as the WordPiece/unigram tokenizers:
    ``encode(text, max_length)``, ``encode_batch``, ``decode``, and a
    ``pad_id`` attribute the encoder pads with.
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        unk_id: Optional[int] = None,
        bos_id: int = 0,
        eos_id: int = 2,
        pad_id: int = 1,
        add_prefix_space: bool = False,
        fast_path: Optional[str] = None,
    ) -> None:
        self.vocab = vocab
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_prefix_space = add_prefix_space
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.ids_to_pieces = {i: p for p, i in vocab.items()}
        self._cache: Dict[str, Tuple[str, ...]] = {}
        # Optional Rust fast path (HF `tokenizers` — the engine the
        # reference's sentence-transformers stack runs on).
        self._fast = None
        if fast_path:
            try:
                from tokenizers import Tokenizer

                fast = Tokenizer.from_file(fast_path)
                fast.no_truncation()
                fast.no_padding()
                self._fast = fast
            except Exception:
                self._fast = None

    # -- loading ----------------------------------------------------------

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "ByteLevelBPETokenizer":
        model_dir = Path(model_dir)
        tok_json = model_dir / "tokenizer.json"
        if tok_json.exists():
            spec = json.loads(tok_json.read_text())
            if spec.get("model", {}).get("type") == "BPE":
                return cls.from_tokenizer_json(
                    spec, fast_path=str(tok_json)
                )
        vocab_json = model_dir / "vocab.json"
        merges_txt = model_dir / "merges.txt"
        if vocab_json.exists() and merges_txt.exists():
            vocab = json.loads(vocab_json.read_text())
            merges: List[Tuple[str, str]] = []
            for line in merges_txt.read_text().splitlines():
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
            return cls(
                vocab,
                merges,
                unk_id=vocab.get("<unk>"),
                bos_id=vocab.get("<s>", 0),
                eos_id=vocab.get("</s>", 2),
                pad_id=vocab.get("<pad>", 1),
            )
        raise FileNotFoundError(
            f"No byte-level BPE assets (tokenizer.json or "
            f"vocab.json+merges.txt) under {model_dir}"
        )

    @classmethod
    def from_tokenizer_json(
        cls, spec: Dict, fast_path: Optional[str] = None
    ) -> "ByteLevelBPETokenizer":
        model = spec["model"]
        vocab: Dict[str, int] = dict(model["vocab"])
        merges = []
        for m in model.get("merges", []):
            if isinstance(m, str):  # older files: "a b"
                a, _, b = m.partition(" ")
                merges.append((a, b))
            else:
                merges.append((m[0], m[1]))
        # Added tokens (specials) may extend past the BPE vocab.
        for tok in spec.get("added_tokens", []):
            vocab.setdefault(tok["content"], tok["id"])

        def _special(names: Tuple[str, ...], default: int) -> int:
            for name in names:
                if name in vocab:
                    return vocab[name]
            return default

        pre = spec.get("pre_tokenizer") or {}
        pres = pre.get("pretokenizers", [pre])
        add_prefix = any(
            p.get("type") == "ByteLevel" and p.get("add_prefix_space")
            for p in pres
        )
        bos = _special(("<s>", "[CLS]"), 0)
        eos = _special(("</s>", "[SEP]"), 2)
        post = spec.get("post_processor") or {}
        if post.get("type") == "RobertaProcessing":
            # Explicit ids win over name lookup: ["<s>", id] pairs.
            bos = int(post.get("cls", [None, bos])[1])
            eos = int(post.get("sep", [None, eos])[1])
        return cls(
            vocab,
            merges,
            unk_id=vocab.get("<unk>"),
            bos_id=bos,
            eos_id=eos,
            pad_id=_special(("<pad>", "[PAD]"), 1),
            add_prefix_space=add_prefix,
            fast_path=fast_path,
        )

    # -- BPE core ----------------------------------------------------------

    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(
                pairs, key=lambda p: self.ranks.get(p, float("inf"))
            )
            if best not in self.ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        if len(self._cache) < 50_000:
            self._cache[token] = word
        return word

    def _encode_core(self, text: str) -> List[int]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        ids: List[int] = []
        for tok in _pretokenize(text):
            mapped = "".join(
                self.byte_encoder[b] for b in tok.encode("utf-8")
            )
            for piece in self._bpe(mapped):
                pid = self.vocab.get(piece)
                if pid is None:
                    # Unreachable with a full byte alphabet; mirror HF's
                    # fuse_unk=False behavior for partial vocabs.
                    if self.unk_id is not None:
                        ids.append(self.unk_id)
                    continue
                ids.append(pid)
        return ids

    # -- public API ---------------------------------------------------------

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
        data = bytes(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace")
