"""The port's copies of the JAX-free host modules (parser, chunker,
WordPiece tokenizer, filters) give output identical to ``tpu_search``'s on
the verify-skill fixture; the port imports neither jax, click nor
ml_dtypes; and asking for CUDA where there is none raises.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_search.ingest.chunker import ConversationChunker as JaxChunker
from tpu_search.ingest.parser import JSONLParser as JaxParser
from tpu_search.models.tokenizer import WordPieceTokenizer as JaxWordPiece
from tpu_search.storage import filters as jax_filters
from tpu_search.storage.metadata import MetadataStore as JaxMetadataStore
from tpu_search_torch.ingest.chunker import ConversationChunker
from tpu_search_torch.ingest.parser import JSONLParser
from tpu_search_torch.models.tokenizer import WordPieceTokenizer
from tpu_search_torch.storage import filters

REPO = Path(__file__).resolve().parent.parent
VOCAB = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + [
    f"tok{i}" for i in range(59)
]


def write_transcripts(root: Path) -> list:
    """The verify-skill fixture: a user/assistant pair (>100 chars each),
    a code block of >= 5 lines, tool calls and results, a malformed JSON
    line and a hook-noise line, in two projects and three sessions."""
    files = []
    for project, session, offset in (("-root-myproj", "s1", 0),
                                     ("-root-myproj", "s2", 7),
                                     ("-root-other", "s3", 20)):
        def words(i, n=14):
            return " ".join(f"tok{(offset + i + j) % 59}" for j in range(n))

        lines = [
            {"uuid": "u1", "sessionId": session,
             "timestamp": "2025-07-01T09:15:00Z",
             "message": {"role": "user", "content": [
                 {"type": "text", "text": words(0) + " " + words(3)}]}},
            {"uuid": "a1", "sessionId": session,
             "timestamp": "2025-07-01T09:16:00Z",
             "message": {"role": "assistant", "content": [
                 {"type": "text", "text": words(5) + " " + words(9)},
                 {"type": "code", "language": "python",
                  "text": "\n".join(f"tok{k} = tok{k + 1}" for k in range(6))},
             ]}},
            {"uuid": "u2", "sessionId": session,
             "timestamp": "2025-07-02T10:00:00Z",
             "message": {"role": "user", "content": words(11) * 2},
             "toolCalls": [{"name": "Read", "input": {"path": "tok1"}}],
             "tool_results": [{"output": words(2)}]},
            {"uuid": "a2", "sessionId": session,
             "timestamp": "2025-07-02T10:01:00Z",
             "message": {"role": "assistant", "content": [
                 {"type": "text", "text": words(13) + " " + words(17)}]}},
        ]
        path = root / "claude-projects" / project / f"{session}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        text = "\n".join(json.dumps(line) for line in lines)
        path.write_text(text + '\n{"broken json\nPreToolUse hook fired\n')
        files.append(path)
    return files


def chunk_records(chunks):
    return [(c.id, c.text, c.metadata) for c in chunks]


def test_parser_and_chunker_identical(tmp_path):
    files = write_transcripts(tmp_path)
    port_chunker, jax_chunker = ConversationChunker(), JaxChunker()
    for path in files:
        port = JSONLParser().parse_file(str(path))
        ref = JaxParser().parse_file(str(path))
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert len(port.messages) == 4
        assert chunk_records(port_chunker.chunk_conversation(port)) == (
            chunk_records(jax_chunker.chunk_conversation(ref))
        )


def test_wordpiece_identical(tmp_path):
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    port = WordPieceTokenizer.from_pretrained_dir(str(tmp_path))
    ref = JaxWordPiece.from_pretrained_dir(str(tmp_path))
    for text in ("tok1 tok2 tok58", "Tok3, tok4! unknown-word ΣΑΣ", "",
                 "tok7 " * 500):
        for limit in (8, 384):
            assert port.encode(text, limit) == ref.encode(text, limit)
    assert port.pad_id == ref.pad_id


def test_filters_identical(tmp_path):
    files = write_transcripts(tmp_path)
    store = JaxMetadataStore(str(tmp_path / "meta.db"))
    store.open()
    chunker = JaxChunker()
    rows = []
    for path in files:
        conv = JaxParser().parse_file(str(path))
        for chunk in chunker.chunk_conversation(conv):
            chunk.metadata.setdefault("project_name", conv.project_name)
            chunk.metadata.setdefault("session_id", conv.session_id)
            rows.append((chunk, len(rows)))
    store.upsert_chunks(rows)
    conn = store._conn()
    for spec in (None, {"project_name": "myproj"}, {"has_code": True},
                 {"session_id": "s2"},
                 {"timestamp": {"gte": "2025-07-02T00:00:00+00:00"}},
                 {"project_name": "other", "has_code": True}):
        port = filters.mask_for_filters(conn, spec, len(rows))
        ref = jax_filters.mask_for_filters(conn, spec, len(rows))
        if ref is None:
            assert port is None
        else:
            assert port.tolist() == ref.tolist()
            assert 0 < port.sum() < len(rows) or spec == {}
    store.close()


@pytest.mark.parametrize("module", [
    "tpu_search_torch",
    "tpu_search_torch.interfaces.cli",
    "tpu_search_torch.interfaces.query_server",
    "tpu_search_torch.interfaces.http_server",
    "tpu_search_torch.interfaces.mcp_server",
    "tpu_search_torch.interfaces.watcher",
    "tpu_search_torch.models.cross_encoder",
    "tpu_search_torch.models.setup",
    "tpu_search_torch.utils.profiling",
    "chip_smoke",
])
def test_port_imports_no_jax_click_or_ml_dtypes(module):
    code = (
        f"import sys, {module}\n"
        "bad = [m for m in ('jax', 'jaxlib', 'click', 'ml_dtypes', "
        "'tpu_search') if m in sys.modules]\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", [
    "interfaces/query_server.py",
    "interfaces/http_server.py",
    "interfaces/mcp_server.py",
    "interfaces/fswatch.py",
    "storage/filters.py",
])
def test_verbatim_copies(path):
    """The warm server's wire protocol and socket path, its HTTP front,
    the MCP stdio server, the file watcher and the filter compiler are
    shared with the JAX package, not forked: the port's files are its
    files, byte for byte."""
    ref = (REPO / "tpu_search" / path).read_bytes()
    assert (REPO / "tpu_search_torch" / path).read_bytes() == ref


def test_cuda_without_cuda_raises(monkeypatch, tmp_path):
    from tpu_search_torch.devices.capability import resolve_device
    from tpu_search_torch.storage.hybrid import HybridStorage, StorageConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CLAUDE_SEARCH_DEVICE", raising=False)
    for name in ("cuda", None, "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(name)
    storage = HybridStorage(StorageConfig(data_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        storage.initialize()
    monkeypatch.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
    assert resolve_device(None) == torch.device("cpu")


# -- tokenizers and the hashing encoder (verbatim copies) --------------------


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE trained in-test by ``tests/test_bpe_tokenizer.py``'s
    recipe: ``tokenizer.json`` and ``vocab.json`` + ``merges.txt``."""
    pytest.importorskip("tokenizers")
    from test_bpe_tokenizer import CORPUS
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import processors, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=600,
        special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    ))
    tok.post_processor = processors.RobertaProcessing(
        sep=("</s>", tok.token_to_id("</s>")),
        cls=("<s>", tok.token_to_id("<s>")),
    )
    tok.decoder = decoders.ByteLevel()
    root = tmp_path_factory.mktemp("bpe")
    tok.save(str(root / "tokenizer.json"))
    tok.model.save(str(root))
    return root


@pytest.fixture(scope="module")
def sp_dir(tmp_path_factory):
    """The unigram ``tokenizer.json`` of ``tests/test_sp_tokenizer.py``."""
    pytest.importorskip("tokenizers")
    from test_sp_tokenizer import VOCAB as SP_VOCAB
    from tokenizers import Regex, Tokenizer, models, normalizers
    from tokenizers import pre_tokenizers

    tok = Tokenizer(models.Unigram(SP_VOCAB, unk_id=3, byte_fallback=False))
    tok.normalizer = normalizers.Sequence([
        normalizers.Replace(Regex("[\\t\\n\\r]"), " "),
        normalizers.NFKC(),
        normalizers.Replace(Regex(" {2,}"), " "),
        normalizers.Strip(),
    ])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="always")
    root = tmp_path_factory.mktemp("sp")
    tok.save(str(root / "tokenizer.json"))
    return root


@pytest.mark.parametrize("fast", [True, False])
def test_bpe_tokenizer_identical(bpe_dir, fast):
    """The copy equals ``tpu_search``'s, with the ``tokenizers`` fast path
    and on the pure path (``fast_path=None``: the card's machine has no
    ``tokenizers``), which also equals the Rust engine."""
    from test_bpe_tokenizer import BATTERY
    from tokenizers import Tokenizer
    from tpu_search.models.bpe_tokenizer import (
        ByteLevelBPETokenizer as JaxBPE,
    )
    from tpu_search_torch.models.bpe_tokenizer import ByteLevelBPETokenizer

    if fast:
        port = ByteLevelBPETokenizer.from_pretrained_dir(str(bpe_dir))
        ref = JaxBPE.from_pretrained_dir(str(bpe_dir))
        assert port._fast is not None
    else:
        spec = json.loads((bpe_dir / "tokenizer.json").read_text())
        port = ByteLevelBPETokenizer.from_tokenizer_json(spec, fast_path=None)
        ref = JaxBPE.from_tokenizer_json(spec, fast_path=None)
        assert port._fast is None
    engine = Tokenizer.from_file(str(bpe_dir / "tokenizer.json"))
    for text in BATTERY:
        for limit in (6, 512):
            assert port.encode(text, limit) == ref.encode(text, limit), text
        assert port.encode(text, 512) == engine.encode(text).ids, text
    assert port.pad_id == ref.pad_id


@pytest.mark.parametrize("fast", [True, False])
def test_sp_tokenizer_identical(sp_dir, fast):
    from test_sp_tokenizer import TEXT_MATRIX
    from tpu_search.models.sp_tokenizer import UnigramTokenizer as JaxUnigram
    from tpu_search_torch.models.sp_tokenizer import UnigramTokenizer

    if fast:
        port = UnigramTokenizer.from_pretrained_dir(str(sp_dir))
        ref = JaxUnigram.from_pretrained_dir(str(sp_dir))
    else:
        spec = json.loads((sp_dir / "tokenizer.json").read_text())
        port = UnigramTokenizer.from_tokenizer_json(spec, fast_path=None)
        ref = JaxUnigram.from_tokenizer_json(spec, fast_path=None)
        assert port._fast is None
    for text in TEXT_MATRIX:
        for limit in (4, 512):
            assert port.encode(text, limit) == ref.encode(text, limit), text
    assert port.pad_id == ref.pad_id


def test_tokenizer_dispatch_follows_the_assets(tmp_path, bpe_dir, sp_dir):
    """BPE assets first, then ``arch="xlmr"`` or sentencepiece assets, else
    WordPiece (``tpu_search``'s order)."""
    from tpu_search_torch.models.bpe_tokenizer import ByteLevelBPETokenizer
    from tpu_search_torch.models.encoder import load_tokenizer
    from tpu_search_torch.models.mpnet import MPNetConfig
    from tpu_search_torch.models.sp_tokenizer import UnigramTokenizer

    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    bert, xlmr = MPNetConfig(arch="bert"), MPNetConfig(arch="xlmr")
    assert isinstance(load_tokenizer(tmp_path, bert), WordPieceTokenizer)
    assert isinstance(load_tokenizer(bpe_dir, xlmr), ByteLevelBPETokenizer)
    assert isinstance(load_tokenizer(sp_dir, bert), UnigramTokenizer)
    assert isinstance(load_tokenizer(sp_dir, xlmr), UnigramTokenizer)


def test_wordpiece_pairs_identical(tmp_path):
    """``encode_pair`` / ``encode_pair_batch`` (the cross-encoder's input)
    equal ``tpu_search``'s, longest-first truncation included."""
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + VOCAB[5:]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    port = WordPieceTokenizer.from_pretrained_dir(str(tmp_path))
    ref = JaxWordPiece.from_pretrained_dir(str(tmp_path))
    pairs = [("tok1 tok2", "tok3 " * 40), ("tok9 " * 30, "tok4 tok5"),
             ("", "tok7"), ("Tok1, unknown!", "tok2 ΣΑΣ")]
    for a, b in pairs:
        for limit in (7, 34, 512):
            assert port.encode_pair(a, b, limit) == ref.encode_pair(a, b, limit)
    for got, want in zip(port.encode_pair_batch(pairs, 34, pad_to=64),
                         ref.encode_pair_batch(pairs, 34, pad_to=64)):
        assert got.tolist() == want.tolist()


def test_hashing_encoder_bit_for_bit():
    from tpu_search.models.hashing import HashingEncoder as JaxHashing
    from tpu_search_torch.models.hashing import HashingEncoder

    texts = ["install jax on a tpu", "", "Ünïcödé 🙂 tok1", "a" * 500, None]
    for dim, normalize in ((768, True), (256, False), (32, True)):
        got = HashingEncoder(dim).encode(texts, normalize=normalize)
        want = JaxHashing(dim).encode(texts, normalize=normalize)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
