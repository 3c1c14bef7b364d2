"""``HybridStorage`` of the port with a sharded flat index over 8 shards
on the CPU (``shard_devices=8``; the host counted 8 times, as
``XLA_FLAGS`` gives the JAX package's CPU mesh): the cases of
``tests/test_storage_sharded.py`` on the port (collected from their source
with ``tpu_search.`` pointed at ``tpu_search_torch.``).

Added: the JAX warning when fewer devices exist than asked for, auto
(``shard_devices=0``) keeping one card, and a restore back onto the mesh.
"""

import logging

import numpy as np
import pytest

from test_torch_pq_codec import port_cases
from tpu_search_torch.storage import HybridStorage, SearchConfig, StorageConfig


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLAUDE_SEARCH_DEVICE", "cpu")
        yield


_CASES = port_cases("test_storage_sharded")
globals().update({k: v for k, v in _CASES.items()
                  if k in ("storage", "make_chunk", "normed")})


class TestShardedStorage(_CASES["TestShardedStorage"]):
    def test_too_few_devices_warns_and_does_not_shard(self, tmp_path, caplog):
        config = StorageConfig(data_dir=str(tmp_path), embedding_dim=16,
                               auto_save=False, shard_devices=9)
        with caplog.at_level(logging.WARNING):
            with HybridStorage(config) as s:
                assert type(s.index).__name__ == "FlatIndex"
        assert "shard_devices=9 but only 8 devices; not sharding" in (
            caplog.text)

    def test_auto_keeps_one_card(self, tmp_path, monkeypatch):
        """``shard_devices=0`` (auto) on a host of 4 cards keeps the index
        on one device (shards across cards are not yet proven on a
        machine of several cards); 4 asks for all of them."""
        import torch

        from tpu_search_torch.storage import hybrid

        cards = [torch.device("cuda", i) for i in range(4)]
        monkeypatch.setattr(hybrid, "platform_devices",
                            lambda platform: cards if platform == "cuda"
                            else [])
        for n, want in ((0, None), (1, None), (4, cards)):
            config = StorageConfig(data_dir=str(tmp_path / str(n)),
                                   embedding_dim=16, auto_save=False,
                                   shard_devices=n)
            s = HybridStorage(config)
            s._device = torch.device("cuda")  # no card is asked
            mesh = s._index_mesh()
            assert (mesh if mesh is None
                    else list(mesh.devices[:, 0])) == want
            s.close()

    def test_backup_restore_sharded(self, storage, tmp_path):
        """``restore`` loads a backup back onto the mesh."""
        vecs = normed(np.random.default_rng(6), 40, 16)
        storage.add_chunks([make_chunk(f"c{i}", vecs[i]) for i in range(40)])
        backup = str(tmp_path / "bk")
        storage.backup(backup)
        storage.delete_chunks_by_session("s1")
        storage.restore(backup)
        assert storage.index.n_shards == 8 and storage.index.live == 40
        results = storage.search(vecs[11], SearchConfig(top_k=1))
        assert results[0].chunk_id == "c11"
