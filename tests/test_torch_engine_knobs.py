"""The port's ``SearchEngine`` takes the JAX engine's constructor and reads
its environment knobs as the JAX engine does:

- the constructor's parameter names, order and defaults are the JAX
  class's, with ``device`` keyword-only after them;
- ``CLAUDE_SEARCH_EMBED_WAVE`` and ``CLAUDE_SEARCH_PREFETCH_FILES`` are
  read from the environment when the module loads, and a lookahead of 0
  runs ingest serially, with no worker thread; the wave size and the
  lookahead change neither the chunk ids nor the stored vectors, bit for
  bit;
- ``CLAUDE_SEARCH_SHARD_DEVICES`` raises the JAX engine's ``ValueError`` on
  a non-integer; 8 shards a flat store over the 8 CPU devices in both
  packages, and with ``CLAUDE_SEARCH_INDEX_TYPE=ivf`` the port's engine
  builds an 8-shard ``ShardedIVFIndex``.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_engine import write_model
from test_torch_host_copies import write_transcripts
from tpu_search.api.engine import SearchEngine as JaxSearchEngine
from tpu_search_torch.api import engine as port_engine_mod
from tpu_search_torch.api.engine import SearchEngine

REPO = Path(__file__).resolve().parent.parent


def test_constructor_matches_the_jax_engine():
    jax_params = list(inspect.signature(JaxSearchEngine).parameters.values())
    port_params = list(inspect.signature(SearchEngine).parameters.values())
    assert port_params[-1].name == "device"
    assert port_params[-1].kind is inspect.Parameter.KEYWORD_ONLY
    assert port_params[-1].default is None
    assert [(p.name, p.kind, p.default) for p in port_params[:-1]] == [
        (p.name, p.kind, p.default) for p in jax_params]


def test_constructor_takes_the_jax_calls(tmp_path):
    engine = SearchEngine(str(tmp_path / "a"), True, "hash-768", 5.0, False,
                          device="cpu")
    assert engine.use_gpu is True and engine.use_warm_server is False
    assert engine.embedder.config.model_name == "hash-768"
    assert engine.storage.config.save_interval_s == 5.0
    engine = SearchEngine(data_dir=str(tmp_path / "b"), use_warm_server=False,
                          model_name="hash-768", device="cpu")
    assert engine.use_gpu is False and engine.use_warm_server is False


def test_ingest_knobs_are_read_from_the_environment():
    env = dict(os.environ, CLAUDE_SEARCH_EMBED_WAVE="7",
               CLAUDE_SEARCH_PREFETCH_FILES="0")
    out = subprocess.run(
        [sys.executable, "-c",
         "import tpu_search_torch.api.engine as e; "
         "print(e._EMBED_WAVE_CHUNKS, e._PREFETCH_FILES)"],
        cwd=REPO, env=env, capture_output=True, text=True, check=True,
    ).stdout.split()
    assert out == ["7", "0"]
    assert port_engine_mod._EMBED_WAVE_CHUNKS == int(
        os.environ.get("CLAUDE_SEARCH_EMBED_WAVE", 2048))
    assert port_engine_mod._PREFETCH_FILES == int(
        os.environ.get("CLAUDE_SEARCH_PREFETCH_FILES", 256))


def index_with(root: Path, files, name: str):
    write_model(root / name / "models")
    engine = SearchEngine(str(root / name), model_name="tiny-mpnet",
                          device="cpu")
    stats = engine.index_conversations(files)
    assert stats["errors"] == []
    storage = engine.storage
    ids = storage.chunk_id_to_faiss_id
    rows = storage.index._rows_f32().numpy()
    return stats["chunks_indexed"], ids, rows


@pytest.mark.parametrize("wave,prefetch", [(2048, 0), (3, 256), (3, 0)])
def test_wave_and_lookahead_change_no_result(tmp_path, monkeypatch, wave,
                                             prefetch):
    files = write_transcripts(tmp_path)
    base = index_with(tmp_path, files, "default")
    assert base[0] > 6
    monkeypatch.setattr(port_engine_mod, "_EMBED_WAVE_CHUNKS", wave)
    monkeypatch.setattr(port_engine_mod, "_PREFETCH_FILES", prefetch)
    if prefetch == 0:
        def no_pool(*args, **kwargs):
            raise AssertionError("serial ingest started a worker thread")
        monkeypatch.setattr(port_engine_mod, "ThreadPoolExecutor", no_pool)
    got = index_with(tmp_path, files, f"w{wave}_p{prefetch}")
    assert got[0] == base[0]
    assert got[1] == base[1]
    np.testing.assert_array_equal(got[2], base[2])


def test_shard_devices_is_validated_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CLAUDE_SEARCH_SHARD_DEVICES", "abc")
    with pytest.raises(ValueError) as jax_err:
        JaxSearchEngine(str(tmp_path / "jax"), model_name="hash-768",
                        use_warm_server=False)
    with pytest.raises(ValueError) as port_err:
        SearchEngine(str(tmp_path / "port"), model_name="hash-768",
                     device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setenv("CLAUDE_SEARCH_SHARD_DEVICES", "8")
    jax8 = JaxSearchEngine(str(tmp_path / "jax8"), model_name="hash-768",
                           use_warm_server=False)
    port8 = SearchEngine(str(tmp_path / "port8"), model_name="hash-768",
                         device="cpu")
    for engine in (jax8, port8):
        assert engine.storage.config.shard_devices == 8
        engine.storage.initialize()
        index = engine.storage.index
        assert type(index).__name__ == "ShardedFlatIndex"
        assert index.n_shards == 8
        engine.storage.close()
    monkeypatch.setenv("CLAUDE_SEARCH_INDEX_TYPE", "ivf")
    ivf8 = SearchEngine(str(tmp_path / "ivf8"), model_name="hash-768",
                        device="cpu")
    ivf8.storage.initialize()
    index = ivf8.storage.index
    assert type(index).__name__ == "ShardedIVFIndex"
    assert index.n_shards == 8
    ivf8.storage.close()
    monkeypatch.delenv("CLAUDE_SEARCH_INDEX_TYPE")
    for value in ("0", "1"):
        monkeypatch.setenv("CLAUDE_SEARCH_SHARD_DEVICES", value)
        engine = SearchEngine(str(tmp_path / f"port{value}"),
                              model_name="hash-768", device="cpu")
        assert engine.storage.config.shard_devices == int(value)
