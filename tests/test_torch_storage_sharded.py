"""``HybridStorage`` of the port with a sharded flat index over 8 shards
on the CPU (``shard_devices=8``; the host counted 8 times, as
``XLA_FLAGS`` gives the JAX package's CPU mesh): the cases of
``tests/test_storage_sharded.py`` on the port (collected from their source
with ``tpu_search.`` pointed at ``tpu_search_torch.``).

Added: the JAX warning when fewer devices exist than asked for, auto
(``shard_devices=0``) sharding over every card of the process, and over
every process's cards under a process group (the same mesh for N equal to
that global count, and the ``ValueError`` for any other N), and a restore
back onto the mesh.
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

    @pytest.mark.parametrize("index_type", ["flat", "ivf"])
    def test_auto_shards_over_every_card(self, tmp_path, monkeypatch,
                                         index_type):
        """The JAX package's rule: ``shard_devices=0`` (auto) on a host of
        4 cards shards a flat or IVF index over all four, 1 keeps one
        device and 4 asks for all of them; auto with one card, or on the
        CPU (however many host devices), keeps one device."""
        import torch

        from tpu_search_torch.storage import hybrid

        cards = [torch.device("cuda", i) for i in range(4)]
        for host, device, n, want in (
                (cards, "cuda", 0, cards), (cards, "cuda", 1, None),
                (cards, "cuda", 4, cards), (cards[:1], "cuda", 0, None),
                ([], "cpu", 0, None)):
            monkeypatch.setattr(hybrid, "platform_devices",
                                lambda platform, host=host: (
                                    host if platform == "cuda"
                                    else [torch.device("cpu")] * 8))
            config = StorageConfig(data_dir=str(tmp_path / f"{n}{device}"),
                                   embedding_dim=16, auto_save=False,
                                   shard_devices=n, index_type=index_type)
            s = HybridStorage(config)
            s._device = torch.device(device)  # no card is asked
            mesh = s._index_mesh()
            assert (mesh if mesh is None
                    else list(mesh.devices[:, 0])) == want
            s.close()

    def test_auto_shards_no_other_index_type(self, tmp_path, monkeypatch):
        """Any ``index_type`` but flat or IVF keeps one device, auto or
        not (``hnsw`` resolves to flat before the rule, so the rule is
        read on the config as set)."""
        import torch

        from tpu_search_torch.storage import hybrid

        cards = [torch.device("cuda", i) for i in range(4)]
        monkeypatch.setattr(hybrid, "platform_devices",
                            lambda platform: cards)
        for n in (0, 4):
            config = StorageConfig(data_dir=str(tmp_path / str(n)),
                                   embedding_dim=16, auto_save=False,
                                   shard_devices=n)
            s = HybridStorage(config)
            s._device = torch.device("cuda")
            s.config.index_type = "hnsw"
            assert s._index_mesh() is None
            s.close()

    @pytest.mark.parametrize("platform, local", [("cuda", 2), ("cpu", 4)])
    def test_mesh_over_processes(self, tmp_path, monkeypatch, platform,
                                 local):
        """Under a group of 2 processes, each with ``local`` devices
        (``process_count``, ``process_index`` and ``platform_devices``
        patched): auto on cards, and N = 2 x ``local`` on either platform,
        build ``build_mesh(n_data=2 * local, dcn_data=2)`` over this
        process's devices, process-major (process 1 owns the second
        half); auto on the CPU keeps one device, 1 keeps one device, and
        any other N > 1 raises, naming N, the processes and the local
        count."""
        import torch

        from tpu_search_torch.parallel import mesh as mesh_mod
        from tpu_search_torch.storage import hybrid

        devices = [torch.device(platform, i) for i in range(local)]
        monkeypatch.setattr(hybrid, "platform_devices",
                            lambda p: devices if p == platform else [])
        for module in (hybrid, mesh_mod):
            monkeypatch.setattr(module, "process_count", lambda: 2)
        monkeypatch.setattr(mesh_mod, "process_index", lambda: 1)
        total = 2 * local
        for n in (0, total, 1, 2, total - 1, total + 1):
            config = StorageConfig(data_dir=str(tmp_path / f"{platform}{n}"),
                                   embedding_dim=16, auto_save=False,
                                   shard_devices=n)
            s = HybridStorage(config)
            s._device = torch.device(platform)  # no card is asked
            if n == 1 or (n == 0 and platform == "cpu"):
                assert s._index_mesh() is None
            elif n in (0, total):
                mesh = s._index_mesh()
                assert mesh.shape == {"data": total, "model": 1}
                assert mesh.processes == 2
                assert mesh.ranks[:, 0].tolist() == [0] * local + [1] * local
                assert list(mesh.devices[:, 0]) == devices * 2
                assert mesh.local_shards() == tuple(range(local, total))
            else:
                with pytest.raises(ValueError) as err:
                    s._index_mesh()
                for word in (f"shard_devices={n}", "2 processes",
                             f"{local} {platform} devices", str(total)):
                    assert word in str(err.value)
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
