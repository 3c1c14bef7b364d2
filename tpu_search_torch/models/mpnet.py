"""The encoder families as one PyTorch ``nn.Module``.

Counterpart of ``tpu_search/models/mpnet.py`` (``forward_hidden``,
``encode``, ``classify``):

- ``arch="mpnet"`` (HF ``MPNetModel``): learned absolute positions from
  ``pad + 1`` and one relative-attention bias table shared by every layer
  (T5-style log buckets);
- ``arch="bert"`` (BERT, DistilBERT; all-MiniLM-*, the ms-marco
  cross-encoders): absolute positions from 0 and the token-type-0 row;
- ``arch="xlmr"`` (XLM-RoBERTa, RoBERTa): MPNet's positions from
  ``pad + 1`` with BERT's token-type-0 row;

BERT and XLM-R take a zero ``[heads, S, S]`` bias.  Post-LN blocks; the
sentence-transformers pooling head (masked mean, CLS or masked max, then
L2 normalization) in :meth:`MPNetModel.forward`; with ``num_labels > 0``
pair inputs add the token-type table and :meth:`MPNetModel.classify` is
``BertForSequenceClassification``'s head (CLS hidden, tanh pooler,
classifier), in f32.  Position ids are clamped to ``max_position - 1``, as
the JAX gather clamps them: a bucket longer than the position table (the
tiny-overlap reranker's 34 positions in the 64 bucket) reads the last row
for pad tokens, which the mask hides.

Numerics follow the JAX graph: the embedding LayerNorm runs in f32, the
layers run in their parameter dtype (bf16 by default) with f32 LayerNorm
statistics and f32 softmax, and bf16 compute selects the tanh gelu.  The
attention core is ``ops.mpnet_attention`` in the ``[B, S, H]`` layout, or
``ops.mpnet_attention_bhsd`` in ``[B, heads, S, hd]`` for the shapes
:func:`~tpu_search_torch.ops.mpnet_attention.attention_layout` sends there
(the CUDA kernels on the card, their plain versions on the CPU); with
``int8_ffn`` the post-attention half of each layer is ``ops.int8_ffn_ln``.

``attention_impl`` takes the JAX values.  ``"dense"`` (the default) and
``"pallas"`` both run the attention above: the port has one kernel per
layout where the JAX package has a dense XLA graph and a Pallas kernel of
one contract.  ``"flash"`` is the JAX stock flash mode
(``ops.flash_attention``): the bias rounded to the compute dtype and added
before the scale, padding as segment ids (a pad query attends to the pad
keys), S a multiple of 128.  No caller of the port selects it, as no
caller of the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.int8_ffn import int8_ffn_ln, quantize_weight_columns
from ..ops.mpnet_attention import (
    attention_layout,
    mpnet_attention,
    mpnet_attention_bhsd,
)

__all__ = [
    "ARCHS",
    "ATTENTION_IMPLS",
    "MPNetConfig",
    "MPNetModel",
    "POOLINGS",
    "init_params",
    "relative_position_bucket",
]

ARCHS = ("mpnet", "bert", "xlmr")
ATTENTION_IMPLS = ("dense", "pallas", "flash")
POOLINGS = ("mean", "cls", "max")


@dataclasses.dataclass(frozen=True)
class MPNetConfig:
    """Architecture hyperparameters (defaults = all-mpnet-base-v2); the
    same fields as the JAX package's ``MPNetConfig``, so one checkpoint
    config serves both."""

    vocab_size: int = 30527
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 514
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    arch: str = "mpnet"  # "mpnet" | "bert" | "xlmr"
    pooling: str = "mean"  # "mean" | "cls" | "max"
    num_labels: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def init_params(config: MPNetConfig, seed: int = 0) -> Dict[str, Any]:
    """Random-normal parameters (std 0.02) as a numpy tree in the JAX
    package's layout: ``[in, out]`` weights, layers stacked on a leading
    ``[L]`` axis, ``rel_bias [buckets, heads]``; for BERT and XLM-R a
    random ``tt0`` row, and with ``num_labels > 0`` the token-type table
    and the ``head`` subtree, as the JAX package's ``init_params``."""
    h, i, n = config.hidden_size, config.intermediate_size, config.num_layers
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return (rng.standard_normal(shape, dtype=np.float32) * 0.02)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    params = {
        "embeddings": {
            "word": normal(config.vocab_size, h),
            "position": normal(config.max_position, h),
            "tt0": zeros(h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "rel_bias": normal(config.relative_attention_num_buckets,
                           config.num_heads),
        "layers": {
            "q_w": normal(n, h, h), "q_b": zeros(n, h),
            "k_w": normal(n, h, h), "k_b": zeros(n, h),
            "v_w": normal(n, h, h), "v_b": zeros(n, h),
            "o_w": normal(n, h, h), "o_b": zeros(n, h),
            "attn_ln_scale": ones(n, h), "attn_ln_bias": zeros(n, h),
            "ff_in_w": normal(n, h, i), "ff_in_b": zeros(n, i),
            "ff_out_w": normal(n, i, h), "ff_out_b": zeros(n, h),
            "ff_ln_scale": ones(n, h), "ff_ln_bias": zeros(n, h),
        },
    }
    if config.arch in ("bert", "xlmr"):
        params["embeddings"]["tt0"] = normal(h)
    if config.num_labels > 0:
        params["embeddings"]["tt_table"] = normal(2, h)
        params["head"] = {
            "pooler_w": normal(h, h), "pooler_b": zeros(h),
            "cls_w": normal(h, config.num_labels),
            "cls_b": zeros(config.num_labels),
        }
    return params


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in ``x``'s dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """T5-style log-spaced buckets (HF MPNetEncoder.relative_position_bucket)."""
    num_buckets //= 2
    n = -relative_position
    ret = (n < 0).to(torch.int32) * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    safe_n = n.clamp(min=1).to(torch.float32)
    val_if_large = max_exact + (
        torch.log(safe_n / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class MPNetLayer(nn.Module):
    """One post-LN transformer block."""

    def __init__(self, config: MPNetConfig) -> None:
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.config = config
        self.layout = attention_layout(h, config.num_heads)
        self.q = nn.Linear(h, h)
        self.k = nn.Linear(h, h)
        self.v = nn.Linear(h, h)
        self.o = nn.Linear(h, h)
        self.attn_ln_scale = nn.Parameter(torch.ones(h))
        self.attn_ln_bias = nn.Parameter(torch.zeros(h))
        self.ff_in = nn.Linear(h, i)
        self.ff_out = nn.Linear(i, h)
        self.ff_ln_scale = nn.Parameter(torch.ones(h))
        self.ff_ln_bias = nn.Parameter(torch.zeros(h))
        # W8A8 FFN weights ([out, in] int8 + f32 column scales), made from
        # the layer's own (compute-dtype) weights by quantize_ffn().
        self.ff_in_wq: Optional[torch.Tensor] = None
        self.ff_in_ws: Optional[torch.Tensor] = None
        self.ff_out_wq: Optional[torch.Tensor] = None
        self.ff_out_ws: Optional[torch.Tensor] = None

    @torch.no_grad()
    def quantize_ffn(self) -> None:
        wq, ws = quantize_weight_columns(self.ff_in.weight.T)
        self.ff_in_wq, self.ff_in_ws = wq.T.contiguous(), ws
        wq, ws = quantize_weight_columns(self.ff_out.weight.T)
        self.ff_out_wq, self.ff_out_ws = wq.T.contiguous(), ws

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                key_mask_add: torch.Tensor, int8_ffn: bool,
                attention_impl: str = "dense",
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One block.  ``"dense"`` / ``"pallas"``: ``bias`` is the f32
        ``[heads, S, S]`` position bias and ``key_mask_add`` the additive
        ``[B, S]`` key mask; ``"flash"``: ``bias`` is ``ab`` in the compute
        dtype and ``segment_ids`` the ``[B, S]`` int32 mask."""
        cfg = self.config
        b, s, h = x.shape
        nh, scale = cfg.num_heads, 1.0 / math.sqrt(cfg.head_dim)

        def heads(t):
            return t.reshape(b, s, nh, -1).transpose(1, 2).contiguous()

        if attention_impl == "flash":
            ctx = flash_attention(
                heads(self.q(x)), heads(self.k(x)), heads(self.v(x)), bias,
                segment_ids, segment_ids, scale,
            ).transpose(1, 2).reshape(b, s, h)
        elif self.layout == "bsh":
            ctx = mpnet_attention(self.q(x), self.k(x), self.v(x), bias,
                                  key_mask_add, num_heads=nh, scale=scale)
        else:
            ctx = mpnet_attention_bhsd(
                heads(self.q(x)), heads(self.k(x)), heads(self.v(x)), bias,
                key_mask_add, scale=scale,
            ).transpose(1, 2).reshape(b, s, h)
        attn = self.o(ctx)
        eps = cfg.layer_norm_eps
        if int8_ffn:
            if self.ff_in_wq is None:
                raise RuntimeError("int8 FFN requested before quantize_ffn()")
            out = int8_ffn_ln(
                (attn + x).reshape(b * s, h),
                self.ff_in_wq, self.ff_in_ws, self.ff_in.bias,
                self.ff_out_wq, self.ff_out_ws, self.ff_out.bias,
                self.attn_ln_scale, self.attn_ln_bias,
                self.ff_ln_scale, self.ff_ln_bias,
                eps=eps, out_dtype=x.dtype,
            )
            return out.reshape(b, s, h)
        x = layer_norm(attn + x, self.attn_ln_scale, self.attn_ln_bias, eps)
        approx = "none" if x.dtype == torch.float32 else "tanh"
        ff = self.ff_out(F.gelu(self.ff_in(x), approximate=approx))
        return layer_norm(ff + x, self.ff_ln_scale, self.ff_ln_bias, eps)


class MPNetModel(nn.Module):
    """Token ids -> sentence embeddings (or, with a classification head,
    pair logits).  The embeddings and the head stay f32; the layers compute
    in their own parameter dtype (``model.layers.to(torch.bfloat16)``
    selects bf16 compute)."""

    def __init__(self, config: MPNetConfig) -> None:
        super().__init__()
        if config.arch not in ARCHS:
            raise ValueError(f"arch={config.arch!r} is not one of {ARCHS}")
        if config.pooling not in POOLINGS:
            raise ValueError(
                f"pooling={config.pooling!r} is not one of {POOLINGS}"
            )
        self.config = config
        h = config.hidden_size
        self.word = nn.Embedding(config.vocab_size, h)
        self.position = nn.Embedding(config.max_position, h)
        self.tt0 = nn.Parameter(torch.zeros(h))
        self.ln_scale = nn.Parameter(torch.ones(h))
        self.ln_bias = nn.Parameter(torch.zeros(h))
        self.rel_bias = nn.Parameter(
            torch.zeros(config.relative_attention_num_buckets,
                        config.num_heads)
        )
        self.layers = nn.ModuleList(
            MPNetLayer(config) for _ in range(config.num_layers)
        )
        if config.num_labels > 0:
            self.tt_table = nn.Parameter(torch.zeros(2, h))
            self.pooler = nn.Linear(h, h)
            self.classifier = nn.Linear(h, config.num_labels)
        self._bias_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.layers[0].q.weight.dtype

    @torch.no_grad()
    def quantize_ffn(self) -> None:
        for layer in self.layers:
            layer.quantize_ffn()

    def position_bias(self, seq_len: int) -> torch.Tensor:
        """``[heads, S, S]`` f32 bias, shared by the batch and every layer
        (cached per sequence length); zero for BERT and XLM-R."""
        dev = self.rel_bias.device
        key = (seq_len, str(dev))
        cached = self._bias_cache.get(key)
        if cached is None and self.config.arch != "mpnet":
            cached = torch.zeros((self.config.num_heads, seq_len, seq_len),
                                 device=dev)
            self._bias_cache[key] = cached
        elif cached is None:
            pos = torch.arange(seq_len, dtype=torch.int32, device=dev)
            buckets = relative_position_bucket(
                pos[None, :] - pos[:, None],
                self.config.relative_attention_num_buckets,
                self.config.relative_attention_max_distance,
            )
            values = self.rel_bias.detach().float()[buckets.long()]
            cached = values.permute(2, 0, 1).contiguous()
            self._bias_cache[key] = cached
        return cached

    def forward_hidden(self, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor,
                       int8_ffn: bool = False,
                       token_type_ids: Optional[torch.Tensor] = None,
                       attention_impl: str = "dense",
                       ) -> torch.Tensor:
        """``[B, S]`` ids and mask -> the last hidden state ``[B, S, H]``.
        ``token_type_ids`` (pair input) select rows of the token-type
        table where the model has one; otherwise the ``tt0`` row is added
        to every token.  ``attention_impl``: see the module docstring."""
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl={attention_impl!r} is not one "
                             f"of {ATTENTION_IMPLS}")
        cfg = self.config
        pad = cfg.pad_token_id
        if cfg.arch == "bert":
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device
            ).expand_as(input_ids)
        else:
            live = (input_ids != pad).to(torch.int32)
            position_ids = torch.cumsum(live, dim=1) * live + pad
        position_ids = position_ids.clamp(max=cfg.max_position - 1)
        x = self.word(input_ids) + self.position(position_ids)
        if token_type_ids is not None and hasattr(self, "tt_table"):
            x = x + self.tt_table[token_type_ids]
        else:
            x = x + self.tt0[None, None, :]
        x = layer_norm(x, self.ln_scale, self.ln_bias, cfg.layer_norm_eps)
        x = x.to(self.compute_dtype)
        bias = self.position_bias(input_ids.shape[1])
        segment_ids = key_mask_add = None
        if attention_impl == "flash":
            # the JAX flash operands: ab in the compute dtype, pads as
            # segment 0 (tpu_search/models/mpnet.py:409-417)
            bias = bias.to(self.compute_dtype)
            segment_ids = attention_mask.to(torch.int32).contiguous()
        else:
            neg = torch.finfo(torch.float32).min
            key_mask_add = ((1.0 - attention_mask.float()) * neg).contiguous()
        for layer in self.layers:
            x = layer(x, bias, key_mask_add, int8_ffn, attention_impl,
                      segment_ids)
        return x

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                normalize: bool = True, int8_ffn: bool = False,
                attention_impl: str = "dense") -> torch.Tensor:
        """``[B, S]`` ids and mask -> ``[B, H]`` f32 embeddings (the
        config's pooling, then L2 normalization)."""
        hidden = self.forward_hidden(input_ids, attention_mask, int8_ffn,
                                     attention_impl=attention_impl)
        hidden = hidden.float()
        if self.config.pooling == "cls":
            pooled = hidden[:, 0, :]
        elif self.config.pooling == "max":
            neg = torch.finfo(torch.float32).min
            live = attention_mask.bool()[:, :, None]
            pooled = torch.where(live, hidden, neg).amax(dim=1)
        else:
            mask = attention_mask.float()[:, :, None]
            summed = (hidden * mask).sum(dim=1)
            counts = mask.sum(dim=1).clamp(min=1e-9)
            pooled = summed / counts
        if normalize:
            norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
            pooled = pooled / norm.clamp(min=1e-12)
        return pooled

    def classify(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 token_type_ids: torch.Tensor,
                 attention_impl: str = "dense") -> torch.Tensor:
        """Pair ids, mask and token types -> ``[B, num_labels]`` f32 logits:
        CLS hidden state, tanh pooler, classifier, all in f32."""
        if self.config.num_labels < 1:
            raise ValueError("this model has no classification head")
        hidden = self.forward_hidden(input_ids, attention_mask,
                                     token_type_ids=token_type_ids,
                                     attention_impl=attention_impl)
        pooled = torch.tanh(self.pooler(hidden[:, 0, :].float()))
        return self.classifier(pooled)
