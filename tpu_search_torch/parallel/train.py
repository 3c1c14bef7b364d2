"""Distributed contrastive fine-tuning step for the encoder.

Counterpart of ``tpu_search/parallel/train.py``: the bi-encoder InfoNCE
objective over in-batch negatives, one step at a time.

- The parameters are an f32 ``MPNetModel`` (the master weights); a step
  runs the layers in ``compute_dtype`` through differentiable casts, so
  the gradients land in f32, as JAX casts inside ``encode``
  (``tpu_search/models/mpnet.py:423``); the embeddings, the pooling and
  the loss stay f32.
- The batch splits over ``data`` (``parallel/encode.py``'s placement:
  replicas, or tensor-parallel columns); the logits need the global
  in-batch negatives, so the query and document embeddings of every data
  shard meet on one device, and across processes in an ``all_gather``
  with a gradient.  Every process then computes the same global loss;
  the gather's backward keeps each process's own rows' gradient, and one
  all-reduce sums the parameter gradients of the processes, so a step in
  N processes is one process's step on the global batch.
- The optimizer is ``torch.optim.AdamW`` with optax ``adamw``'s defaults
  (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter);
  the update is in place (the JAX step returns new arrays).
- Checkpoints are the port's own (no orbax on the card): a directory with
  the parameters as the shared ``model.tpu.npz`` (a fine-tuned model loads
  in both packages and in ``SearchEngine``) and AdamW's moments and step
  in the same layout (``opt_state.npz``).  :func:`train_state_from_numpy`
  carries a JAX ``TrainState`` (params, optax ``ScaleByAdamState`` and
  step) into the port's, so both packages continue from one state.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.convert import (
    _flatten,
    _unflatten,
    load_checkpoint,
    model_from_params,
    params_from_numpy,
    params_to_numpy,
    save_checkpoint,
)
from ..models.mpnet import MPNetConfig, MPNetModel
from .encode import as_tensor, embed_rows, place, sharded_embed
from .mesh import Mesh, build_mesh
from .sharded_index import _gathers

__all__ = [
    "TrainState",
    "make_train_step",
    "init_train_state",
    "infonce_loss",
    "save_train_state",
    "load_train_state",
    "train_state_from_numpy",
]


@dataclasses.dataclass
class TrainState:
    """``params`` the f32 master ``MPNetModel``, ``opt_state`` the AdamW
    optimizer that holds its moments, ``step`` the steps taken;
    ``tensor_parallel`` whether the step splits the layers over 'model'
    (JAX reads it from the params' shardings)."""

    params: MPNetModel
    opt_state: torch.optim.Optimizer
    step: int = 0
    tensor_parallel: bool = False


def _contrastive(q: torch.Tensor, d: torch.Tensor,
                 temperature: float) -> torch.Tensor:
    logits = (q @ d.T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def infonce_loss(
    params: MPNetModel,
    query_ids,
    query_mask,
    doc_ids,
    doc_mask,
    config: Optional[MPNetConfig] = None,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives, on the model's device,
    the layers in ``compute_dtype`` through differentiable casts."""
    if config is not None and config != params.config:
        raise ValueError("config is not the model's")
    device = params.rel_bias.device
    placed = place(params, _one_device_mesh(device), False, compute_dtype)[0]
    q = embed_rows(params, placed, as_tensor(query_ids).long(),
                   as_tensor(query_mask))
    d = embed_rows(params, placed, as_tensor(doc_ids).long(),
                   as_tensor(doc_mask))
    return _contrastive(q, d, temperature)


def _one_device_mesh(device) -> Mesh:
    return build_mesh(n_data=1, devices=[device])


def _master_device(mesh: Mesh) -> torch.device:
    return mesh.devices[mesh.local_shards()[0], 0]


def init_train_state(
    params: MPNetModel,
    mesh: Mesh,
    learning_rate: float = 2e-5,
    tensor_parallel: bool = False,
) -> Tuple[TrainState, torch.optim.Optimizer]:
    """An f32 copy of ``params`` on this process's first data device and
    its AdamW (optax ``adamw``'s defaults) over every parameter."""
    model = copy.deepcopy(params).float().to(_master_device(mesh))
    model._bias_cache.clear()
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4)
    return TrainState(model, optimizer, 0, tensor_parallel), optimizer


def _all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the processes, in one call."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(
    mesh: Mesh,
    config: MPNetConfig,
    optimizer: torch.optim.Optimizer,
    temperature: float = 0.05,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """``step(state, query_ids, query_mask, doc_ids, doc_mask) ->
    (state, loss)``: the batch sharded on 'data', the layers replicated
    or (``state.tensor_parallel``) split over 'model'; ``state.params``
    is updated in place and returned in a state whose ``step`` is one
    more."""

    def step_fn(state: TrainState, query_ids, query_mask, doc_ids,
                doc_mask) -> Tuple[TrainState, torch.Tensor]:
        model = state.params
        if model.config != config:
            raise ValueError("the state's model has another config")
        placed = place(model, mesh, state.tensor_parallel, compute_dtype)
        out = _master_device(mesh)
        q = sharded_embed(model, placed, mesh, query_ids, query_mask,
                          out_device=out)
        d = sharded_embed(model, placed, mesh, doc_ids, doc_mask,
                          out_device=out)
        loss = _contrastive(q, d, temperature)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = list(model.parameters())
        for p in params:  # optax decays every leaf, used or not
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if _gathers(mesh):
            _all_reduce_grads(params)
        optimizer.step()
        return (TrainState(model, optimizer, state.step + 1,
                           state.tensor_parallel), loss.detach())

    return step_fn


# -- checkpoints ---------------------------------------------------------------

_PARAMS_FILE = "model.tpu.npz"
_OPT_FILE = "opt_state.npz"


def _moments(optimizer: torch.optim.Optimizer, model: MPNetModel):
    """``(mu, nu, count)``: AdamW's moments as JAX-layout numpy trees and
    its step count (0 before the first step)."""
    names = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for name, p in names.items():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        if "step" in st:
            count = int(float(st["step"]))
    return (params_to_numpy(mu, model.config),
            params_to_numpy(nu, model.config), count)


def _set_moments(optimizer: torch.optim.Optimizer, model: MPNetModel, mu,
                 nu, count: int) -> None:
    """Load JAX-layout moment trees and the step count into AdamW."""
    mu_state = params_from_numpy(mu, model.config)
    nu_state = params_from_numpy(nu, model.config)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu_state[name].to(p.device).clone(),
            "exp_avg_sq": nu_state[name].to(p.device).clone(),
        }


def save_train_state(state: TrainState, path: str) -> None:
    """Checkpoint params + optimizer moments + step into the directory
    ``path`` (made if missing; its files replaced)."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    model = state.params
    save_checkpoint(str(out / _PARAMS_FILE), params_to_numpy(model),
                    model.config)
    mu, nu, count = _moments(state.opt_state, model)
    flat = {f"mu/{k}": v for k, v in _flatten(mu).items()}
    flat.update({f"nu/{k}": v for k, v in _flatten(nu).items()})
    flat["__meta__"] = np.frombuffer(json.dumps({
        "count": count, "step": int(state.step),
        "tensor_parallel": bool(state.tensor_parallel),
    }).encode(), dtype=np.uint8)
    np.savez(out / _OPT_FILE, **flat)


def load_train_state(
    path: str,
    optimizer: torch.optim.Optimizer,
    template: TrainState,
) -> TrainState:
    """Restore a checkpoint written by :func:`save_train_state` into
    ``template``'s model (in place) and ``optimizer``."""
    tree, config = load_checkpoint(str(Path(path) / _PARAMS_FILE))
    model = template.params
    if config != model.config:
        raise ValueError("the checkpoint is of another config")
    state_dict = params_from_numpy(tree, config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state_dict[name])
    with np.load(Path(path) / _OPT_FILE, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(flat.pop("__meta__").tobytes())
    moments = _unflatten(flat)
    _set_moments(optimizer, model, moments["mu"], moments["nu"],
                 meta["count"])
    return TrainState(model, optimizer, meta["step"],
                      meta.get("tensor_parallel", template.tensor_parallel))


def train_state_from_numpy(
    params: Dict[str, Any],
    mu: Dict[str, Any],
    nu: Dict[str, Any],
    count: int,
    step: int,
    config: MPNetConfig,
    mesh: Mesh,
    learning_rate: float = 2e-5,
    tensor_parallel: bool = False,
) -> Tuple[TrainState, torch.optim.Optimizer]:
    """A JAX ``TrainState`` carried into the port's: its params tree, its
    optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, JAX-layout
    trees) and its step, as numpy; the returned state's next step is the
    one the JAX state would take."""
    state, optimizer = init_train_state(model_from_params(params, config),
                                        mesh, learning_rate, tensor_parallel)
    _set_moments(optimizer, state.params, mu, nu, int(count))
    state.step = int(step)
    return state, optimizer
