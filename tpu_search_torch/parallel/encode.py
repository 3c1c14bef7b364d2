"""Data-parallel (+ optional tensor-parallel) batch embedding over a mesh.

Counterpart of ``tpu_search/parallel/encode.py``.  Where JAX jits one SPMD
program and lets GSPMD insert the collectives, the port runs each local
data shard's slice of the batch on its device and joins the rows itself:

- the batch splits over ``data`` (B must divide by its size);
- :func:`shard_params` places one replica of the encoder on each distinct
  device of the mesh (a repeated device shares one), or, with
  ``tensor_parallel``, cuts its weights by :func:`~.mesh.encoder_param_specs`
  into one column a ``model`` device: heads split over ``model``, each
  column runs the attention kernel on its own heads, and the partial
  products of ``o`` and ``ff_out`` and the vocab-split word lookup are
  summed on the column-0 device.  The model axis stays inside a process,
  as JAX's layout keeps it inside a host;
- across processes (``dcn_data > 1``) each process takes the global
  batch, encodes its own rows and ``all_gather``s them, so every process
  returns the global ``[B, H]``.

On the card S pads up to the kernels' multiple of 64 with pad ids and mask
0: a masked key weighs exactly 0, and the pooling skips the pad rows.
The trainer (``parallel/train.py``) runs the same placement from its f32
master weights, through differentiable casts and copies.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.mpnet import (
    MPNetConfig,
    MPNetModel,
    attention_context,
    embed_tokens,
    layer_norm,
)
from ..ops.mpnet_attention import attention_layout
from .mesh import Mesh, encoder_param_specs
from .sharded_index import _current, _gathers

__all__ = ["ShardedParams", "make_sharded_encode", "shard_params"]

# S on the card: a multiple of the bf16 attention kernels' 64-key tile.
SEQ_MULTIPLE = 64


def as_tensor(x) -> torch.Tensor:
    """A tensor of ids or a mask, from a tensor or an array."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def pad_sequences(ids: torch.Tensor, mask: torch.Tensor, pad_id: int):
    """``(ids, mask)`` with S padded up to a multiple of
    :data:`SEQ_MULTIPLE` by pad ids and mask 0."""
    extra = -ids.shape[1] % SEQ_MULTIPLE
    if extra == 0:
        return ids, mask
    return (F.pad(ids, (0, extra), value=pad_id),
            F.pad(mask, (0, extra), value=0))


def pad_for_kernels(ids: torch.Tensor, mask: torch.Tensor, pad_id: int):
    """:func:`pad_sequences` on a CUDA device (the bf16 attention kernels
    take S in multiples of 64); as they are elsewhere."""
    if ids.device.type != "cuda":
        return ids, mask
    return pad_sequences(ids, mask, pad_id)


def _replica(model: MPNetModel, device: torch.device,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every parameter on ``device``, the layers' in ``dtype`` and the
    rest in f32: differentiable copies and casts (none where nothing
    changes)."""
    return {name: p.to(device=device,
                       dtype=dtype if name.startswith("layers.")
                       else torch.float32)
            for name, p in model.named_parameters()}


def _split(n: int, parts: int, j: int) -> slice:
    """Part ``j`` of ``parts`` near-equal runs of ``range(n)``."""
    bounds = np.linspace(0, n, parts + 1).round().astype(int)
    return slice(int(bounds[j]), int(bounds[j + 1]))


def _column(model: MPNetModel, j: int, n_model: int, device: torch.device,
            dtype: torch.dtype) -> Dict[str, Any]:
    """Tensor-parallel column ``j`` of ``n_model`` on ``device``: the
    weights :func:`~.mesh.encoder_param_specs` splits, cut to this column
    (heads ``j``-th share of q, k, v and o's input; the ``j``-th share of
    the intermediate dim; the ``j``-th run of vocab rows), and the
    replicated ones on column 0 alone, where the partial sums meet."""
    cfg = model.config
    if cfg.num_heads % n_model or cfg.intermediate_size % n_model:
        raise ValueError(
            f"tensor parallelism over {n_model} needs heads "
            f"({cfg.num_heads}) and the intermediate size "
            f"({cfg.intermediate_size}) to divide by it")
    specs = encoder_param_specs(model)
    heads = cfg.num_heads // n_model
    hd = cfg.head_dim
    inner = slice(j * heads * hd, (j + 1) * heads * hd)
    ff = _split(cfg.intermediate_size, n_model, j)
    vocab = _split(cfg.vocab_size, n_model, j)

    def part(name: str, p: torch.Tensor) -> torch.Tensor:
        spec = specs[name]
        for dim, axis in enumerate(spec):
            if axis == "model":
                if name == "word.weight":
                    rows = vocab
                elif ".ff_" in name:
                    rows = ff
                else:
                    rows = inner
                p = p.narrow(dim, rows.start, rows.stop - rows.start)
        wanted = dtype if name.startswith("layers.") else torch.float32
        return p.to(device=device, dtype=wanted)

    out: Dict[str, Any] = {"device": device, "heads": heads, "vocab": vocab,
                           "layout": attention_layout(heads * hd, heads)}
    for name, p in model.named_parameters():
        split = "model" in specs[name]
        if split or j == 0:
            out[name] = part(name, p)
    return out


def place(model: MPNetModel, mesh: Mesh, tensor_parallel: bool,
          dtype: torch.dtype) -> Dict[int, Any]:
    """This process's data shards -> their placement: a replica's
    parameter dict (shared by the shards of one device), or with
    ``tensor_parallel`` the list of the shard's ``model`` columns.  Under
    grad the tensors stay differentiable functions of ``model``'s."""
    n_model = mesh.shape["model"]
    by_device: Dict[Any, Any] = {}
    out: Dict[int, Any] = {}
    for shard in mesh.local_shards():
        if not tensor_parallel:
            device = mesh.devices[shard, 0]
            if str(device) not in by_device:
                by_device[str(device)] = _replica(model, device, dtype)
            out[shard] = by_device[str(device)]
            continue
        cols = []
        for j in range(n_model):
            device = mesh.devices[shard, j]
            key = (str(device), j)
            if key not in by_device:
                by_device[key] = _column(model, j, n_model, device, dtype)
            cols.append(by_device[key])
        out[shard] = cols
    return out


class ShardedParams:
    """An encoder placed on a mesh (:func:`shard_params`): the f32 model,
    and its placement for each compute dtype, made once and kept."""

    def __init__(self, model: MPNetModel, mesh: Mesh,
                 tensor_parallel: bool) -> None:
        self.model, self.mesh = model, mesh
        self.tensor_parallel = tensor_parallel
        self._placed: Dict[torch.dtype, Dict[int, Any]] = {}

    @property
    def config(self) -> MPNetConfig:
        return self.model.config

    def placement(self, dtype: torch.dtype) -> Dict[int, Any]:
        if dtype not in self._placed:
            with torch.no_grad():
                self._placed[dtype] = place(self.model, self.mesh,
                                            self.tensor_parallel, dtype)
        return self._placed[dtype]


def shard_params(model: MPNetModel, mesh: Mesh,
                 tensor_parallel: bool = False) -> ShardedParams:
    """Place an encoder on the mesh: replicated, or tensor-parallel over
    'model' (:func:`~.mesh.encoder_param_specs`)."""
    return ShardedParams(model, mesh, tensor_parallel)


def _vocab_rows(c: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    """Column ``c``'s share of the word lookup: its rows where the id is in
    its vocab run, zero elsewhere."""
    local = ids.to(c["device"]) - c["vocab"].start
    hit = (local >= 0) & (local < c["vocab"].stop - c["vocab"].start)
    return F.embedding(local.clamp(min=0) * hit, c["word.weight"]) * hit[
        ..., None]


def _tp_hidden(model: MPNetModel, cols: List[Dict[str, Any]],
               ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The last hidden state through ``cols``' tensor-parallel layers, on
    column 0's device: each column's partial products summed there."""
    cfg = model.config
    c0 = cols[0]
    dev0 = c0["device"]
    word = sum(_vocab_rows(c, ids).to(dev0) for c in cols)
    x = embed_tokens(cfg, ids, word, c0["position.weight"], c0["tt0"],
                     c0["ln_scale"], c0["ln_bias"])
    x = x.to(c0["layers.0.q.weight"].dtype)
    s = ids.shape[1]
    if cfg.arch == "mpnet":
        bias = c0["rel_bias"].float()[model.buckets(s, dev0)].permute(2, 0, 1)
    else:
        bias = torch.zeros((cfg.num_heads, s, s), device=dev0)
    key_mask_add = model.key_mask(mask)
    operands = [(c, bias[j * c["heads"]:(j + 1) * c["heads"]].to(
        c["device"]).contiguous(), key_mask_add.to(c["device"]))
        for j, c in enumerate(cols)]
    eps = cfg.layer_norm_eps
    approx = "none" if x.dtype == torch.float32 else "tanh"
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."

        def attend(c, b_c, m_c):
            with _current(c["device"]):  # the kernel launches there
                xc = x.to(c["device"])
                q, k, v = (F.linear(xc, c[pre + f"{n}.weight"],
                                    c[pre + f"{n}.bias"]) for n in "qkv")
                ctx = attention_context(q, k, v, b_c, m_c, c["heads"],
                                        c["layout"])
                return F.linear(ctx, c[pre + "o.weight"]).to(dev0)

        def ffn(c):
            h = F.gelu(F.linear(x.to(c["device"]), c[pre + "ff_in.weight"],
                                c[pre + "ff_in.bias"]), approximate=approx)
            return F.linear(h, c[pre + "ff_out.weight"]).to(dev0)

        attn = sum(attend(*o) for o in operands) + c0[pre + "o.bias"]
        x = layer_norm(attn + x, c0[pre + "attn_ln_scale"],
                       c0[pre + "attn_ln_bias"], eps)
        ff = sum(ffn(c) for c in cols) + c0[pre + "ff_out.bias"]
        x = layer_norm(ff + x, c0[pre + "ff_ln_scale"],
                       c0[pre + "ff_ln_bias"], eps)
    return x


def embed_rows(model: MPNetModel, placed: Any, ids: torch.Tensor,
               mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """One data shard's ``[b, S]`` rows -> ``[b, H]`` f32 embeddings on its
    (column-0) device, through its placement (:func:`place`), with that
    device current: the attention kernels launch on the current device."""
    cols = placed if isinstance(placed, list) else None
    device = cols[0]["device"] if cols else next(iter(placed.values())).device
    ids, mask = pad_for_kernels(ids.to(device), mask.to(device),
                                model.config.pad_token_id)
    with _current(device):
        if cols is None:
            return torch.func.functional_call(model, placed, (ids, mask),
                                              {"normalize": normalize})
        hidden = _tp_hidden(model, cols, ids, mask)
        return model.pool(hidden, mask, normalize)


class _GatherRows(torch.autograd.Function):
    """All processes' ``[b, H]`` rows, rank-major, with a gradient: each
    process computes the same loss from the gathered rows, so the
    backward keeps its own rows' share of the gradient and adds nothing
    from the other ranks (their copies of the loss give them theirs); the
    trainer's all-reduce of the parameter gradients then sums the
    processes' contributions once."""

    @staticmethod
    def forward(ctx, rows):
        world = dist.get_world_size()
        ctx.rank, ctx.b = dist.get_rank(), rows.shape[0]
        parts = [torch.empty_like(rows) for _ in range(world)]
        dist.all_gather(parts, rows.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.b:(ctx.rank + 1) * ctx.b]


def sharded_embed(model: MPNetModel, placement: Dict[int, Any], mesh: Mesh,
                  ids, mask, normalize: bool = True,
                  out_device: Optional[torch.device] = None) -> torch.Tensor:
    """The global batch ``[B, S]`` -> ``[B, H]`` f32 embeddings: each local
    data shard's rows on its placement, joined on ``out_device`` (default:
    this process's first shard's device), then across the processes of a
    group as wide as the mesh (a one-rank group included)."""
    ids, mask = as_tensor(ids).long(), as_tensor(mask)
    n = mesh.shape["data"]
    b = ids.shape[0]
    if b % n:
        raise ValueError(
            f"input_ids was given the sharding of data over {n} shards, "
            f"which implies that the global size of its dimension 0 should "
            f"be divisible by {n}, but it is equal to {b} (full shape: "
            f"{tuple(ids.shape)})")
    per = b // n
    local = mesh.local_shards()
    out_device = out_device or mesh.devices[local[0], 0]
    rows = [embed_rows(model, placement[s], ids[s * per:(s + 1) * per],
                       mask[s * per:(s + 1) * per], normalize).to(out_device)
            for s in local]
    out = torch.cat(rows)
    if _gathers(mesh):
        out = _GatherRows.apply(out)
    return out


def make_sharded_encode(
    mesh: Mesh,
    config: MPNetConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    normalize: bool = True,
):
    """``(params, ids [B, S], mask [B, S]) -> embeddings [B, H]`` (f32, on
    this process's first data device), the batch sharded over 'data'.
    ``params``: :func:`shard_params`'s placement, or an ``MPNetModel``
    (replicated on the fly).  B must be divisible by the data-axis size."""

    def fn(params, input_ids, attention_mask) -> torch.Tensor:
        if isinstance(params, MPNetModel):
            params = shard_params(params, mesh)
        if params.model.config != config:
            raise ValueError("params were built for another config")
        with torch.no_grad():
            return sharded_embed(params.model, params.placement(compute_dtype),
                                 mesh,
                                 input_ids, attention_mask, normalize)

    return fn
