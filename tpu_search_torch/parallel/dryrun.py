"""The multi-device dry run of the port.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: on an ``n``-device ``(data, model)`` mesh it runs,
at tiny shapes, the training step (dp over 'data', tp over 'model' when
``n`` is even and at least 4), a dp encode with the trained parameters,
the sharded exact scan with a predicate mask, the sharded IVF index (its
self-hit at full probe), sharded pq with its int8 refine tier, the fused
encode + sharded scan, and warm serving over sharded storage through the
``QueryServer``; the same asserts, and the same closing line.

The mesh repeats one device ``n`` times (the CPU, or one card): the
shards share it, as ``chip_smoke.py``'s sharded phases share ``cuda:0``.

    python -m tpu_search_torch.parallel.dryrun [N] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from ..devices.capability import resolve_device
from ..models.convert import model_from_params, save_checkpoint
from ..models.mpnet import MPNetConfig, init_params
from .encode import make_sharded_encode, pad_for_kernels
from .mesh import build_mesh
from .sharded_index import ShardedFlatIndex, sharded_scan
from .sharded_ivf import ShardedIVFIndex
from .train import init_train_state, make_train_step

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> str:
    """Run the distributed steps on ``n_devices`` shards of one device
    (``device``: ``"cpu"`` or ``"cuda"``, default ``resolve_device``'s);
    returns (and prints) the ``dryrun_multichip OK`` line."""
    dev = resolve_device(device)
    devices = [dev] * n_devices
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    mesh = build_mesh(n_data=n_data, n_model=n_model, devices=devices)

    config = MPNetConfig(
        vocab_size=128,
        hidden_size=32,
        num_layers=2,
        num_heads=4,
        intermediate_size=64,
        max_position=96,
    )
    params = init_params(config, seed=0)
    model = model_from_params(params, config)

    rng = np.random.default_rng(0)
    batch = n_data * 2
    seq = 16

    def make_batch():
        ids = rng.integers(4, config.vocab_size, size=(batch, seq))
        return ids.astype(np.int32), np.ones((batch, seq), dtype=np.int32)

    # 1) Training step: dp over 'data', tp over 'model' (when n_model > 1).
    state, optimizer = init_train_state(
        model, mesh, learning_rate=1e-3, tensor_parallel=(n_model > 1))
    train_step = make_train_step(mesh, config, optimizer,
                                 compute_dtype=torch.float32)
    q_ids, q_mask = make_batch()
    d_ids, d_mask = make_batch()
    state, loss = train_step(state, q_ids, q_mask, d_ids, d_mask)
    assert np.isfinite(float(loss)), f"non-finite training loss: {loss}"

    # 2) Data-parallel inference encode with the trained params.
    encode_fn = make_sharded_encode(mesh, config, compute_dtype=torch.float32)
    embeddings = encode_fn(state.params, q_ids, q_mask).cpu().numpy()
    assert embeddings.shape == (batch, config.hidden_size)

    # 3) Sharded corpus scan: a scan per shard and one merge, with a
    #    predicate mask.
    index_mesh = build_mesh(n_data=n_devices, n_model=1, devices=devices)
    index = ShardedFlatIndex(dim=config.hidden_size, mesh=index_mesh,
                             dtype="float32")
    corpus = rng.standard_normal((64, config.hidden_size)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    index.add(corpus)
    mask = np.ones(64, dtype=bool)
    mask[::3] = False
    scores, ids = index.search(embeddings[:2], k=5, mask=mask)
    assert ids.shape == (2, 5)
    assert (ids[ids >= 0] % 3 != 0).all() or not mask.any()

    # 4) Sharded IVF: replicated centroids, slot-sharded cluster blocks,
    #    a probe scan per shard, one merge.
    ivf = ShardedIVFIndex(dim=config.hidden_size, mesh=index_mesh,
                          dtype="float32", nlist=4)
    ivf.add(corpus)
    ivf_scores, ivf_ids = ivf.search(corpus[:2], k=5, nprobe=4)
    assert ivf_ids.shape == (2, 5)
    # exhaustive probe: each query's own row must be its top hit
    assert ivf_ids[0, 0] == 0 and ivf_ids[1, 0] == 1

    # 4b) Sharded IVF-PQ + refine tier: replicated codebooks, a probe scan
    #     per shard, the merge, then the id-sharded refine rescore.
    pq = ShardedIVFIndex(
        dim=config.hidden_size, mesh=index_mesh, dtype="pq", nlist=4,
        refine_dtype="int8", refine_factor=4,
    )
    pq.add(corpus)
    assert pq._refine.count == pq.ntotal
    _, pq_ids = pq.search(corpus[:2], k=5, nprobe=4)
    assert pq_ids.shape == (2, 5)
    assert pq_ids[0, 0] == 0 and pq_ids[1, 0] == 1

    # 5) The fused serving program: encode with the trained params, then
    #    the shards' scans and the merge on the embeddings it produced.
    scan_key, buffers = index.make_scan_fn()
    f_ids8 = np.zeros((8, seq), np.int64)
    f_ids8[:2] = q_ids[:2]
    f_attn8 = np.zeros((8, seq), np.int64)
    f_attn8[:2] = 1
    with torch.no_grad():
        ids_t, attn_t = pad_for_kernels(
            torch.from_numpy(f_ids8).to(dev), torch.from_numpy(f_attn8).to(dev),
            config.pad_token_id)
        emb = state.params(ids_t, attn_t).float()
        fs, fi = sharded_scan(scan_key, buffers, index.device_mask(mask),
                              emb[:8], 5)
    assert fi.shape == (8, 5)
    fi_np = fi[:2].cpu().numpy()
    assert (fi_np[fi_np >= 0] % 3 != 0).all() or not mask.any()

    # 6) Warm serving over sharded storage: the production QueryServer
    #    answers socket requests from a HybridStorage whose index is sharded
    #    over the whole mesh: socket -> worker -> fused encode + shard
    #    scans + merge -> hydrate -> wire response.
    from ..api.engine import SearchEngine
    from ..interfaces.query_server import QueryServer
    from ..interfaces.query_server import request as qs_request

    tmp = tempfile.mkdtemp(prefix="dryrun_sharded_serving_")
    try:
        model_dir = os.path.join(tmp, "models", "tiny-mpnet")
        os.makedirs(model_dir)
        save_checkpoint(os.path.join(model_dir, "model.tpu.npz"), params,
                        config)
        vocab = ["<s>", "<pad>", "</s>", "[UNK]", "<mask>"] + [
            f"tok{i}" for i in range(config.vocab_size - 5)
        ]
        with open(os.path.join(model_dir, "vocab.txt"), "w") as fh:
            fh.write("\n".join(vocab) + "\n")
        engine = SearchEngine(data_dir=tmp, model_name="tiny-mpnet",
                              use_warm_server=False, device=dev.type)
        engine.storage.config.storage_dtype = "float32"
        engine.storage.config.auto_save = False
        claude_dir = os.path.join(tmp, "projects", "-proj")
        os.makedirs(claude_dir)
        lines = []
        for i in range(8):
            lines.append(json.dumps({
                "uuid": f"u{i}", "sessionId": "s1",
                "timestamp": f"2025-07-01T09:0{i}:00Z",
                "message": {
                    "role": "user" if i % 2 == 0 else "assistant",
                    "content": [{
                        "type": "text",
                        "text": f"tok{i} tok{i+1} tok{i+2} " * 12,
                    }],
                },
            }))
        fixture = os.path.join(claude_dir, "s1.jsonl")
        with open(fixture, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        engine.index_conversations([fixture])
        # the index, saved and loaded over the mesh's shards
        storage = engine.storage
        storage.save_index()
        storage.index = ShardedFlatIndex.load(str(storage.index_path),
                                              mesh=index_mesh)
        storage._data_version += 1
        assert engine.storage.index.n_shards == n_devices

        server = QueryServer(engine, tmp)
        server.start()
        try:
            query = "tok1 tok2 tok3"
            expected = [
                r["chunk_id"]
                for r in engine.search_conversations(query, top_k=2)
            ]
            response = qs_request(
                tmp, {"op": "search", "query": query, "top_k": 2},
                timeout=600.0,
            )
            assert response and response.get("ok"), response
            served = [r["chunk_id"] for r in response["results"]]
            assert served == expected, (served, expected)
        finally:
            server.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    line = (
        f"dryrun_multichip OK: mesh={mesh.shape} loss={float(loss):.4f} "
        f"search ids sample={ids[0][:3].tolist()} "
        f"ivf ids sample={ivf_ids[0][:3].tolist()} "
        f"fused ids sample={fi_np[0][:3].tolist()} "
        f"sharded serving top1={served[0]}"
    )
    print(line, flush=True)
    return line


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
