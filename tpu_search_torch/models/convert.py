"""Native checkpoint I/O, HF checkpoint conversion, and the bridge from
the JAX parameter layout.

The checkpoint format is the JAX package's ``model.tpu.npz``
(``tpu_search/models/convert.py``): one ``np.savez`` archive whose keys are
'/'-joined paths into the parameter tree, plus a ``__config__`` entry
holding the ``MPNetConfig`` as JSON bytes.  One file serves both packages.

:func:`convert_pretrained_dir` turns a downloaded HF / sentence-transformers
directory (MPNet, BERT, DistilBERT, XLM-R; with a sequence-classification
head for the cross-encoders) into that tree and file, as the JAX package
does (the same code, on the port's ``MPNetConfig``).

:func:`params_from_numpy` maps the tree (``[in, out]`` weights, layers
stacked on a leading ``[L]`` axis, ``rel_bias [32, heads]``, the optional
``tt_table`` and ``head`` subtree) onto the state dict of
:class:`~tpu_search_torch.models.mpnet.MPNetModel`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .mpnet import MPNetConfig, MPNetModel

__all__ = [
    "config_from_hf",
    "convert_pretrained_dir",
    "int8_operands_from_numpy",
    "load_checkpoint",
    "model_from_params",
    "params_from_bert_state_dict",
    "params_from_numpy",
    "params_from_state_dict",
    "params_to_numpy",
    "save_checkpoint",
]

# JAX stacked-layer leaf -> (module attribute, transpose to [out, in])
_LAYER_LEAVES = {
    "q_w": ("q.weight", True), "q_b": ("q.bias", False),
    "k_w": ("k.weight", True), "k_b": ("k.bias", False),
    "v_w": ("v.weight", True), "v_b": ("v.bias", False),
    "o_w": ("o.weight", True), "o_b": ("o.bias", False),
    "attn_ln_scale": ("attn_ln_scale", False),
    "attn_ln_bias": ("attn_ln_bias", False),
    "ff_in_w": ("ff_in.weight", True), "ff_in_b": ("ff_in.bias", False),
    "ff_out_w": ("ff_out.weight", True), "ff_out_b": ("ff_out.bias", False),
    "ff_ln_scale": ("ff_ln_scale", False),
    "ff_ln_bias": ("ff_ln_bias", False),
}

_EMBED_LEAVES = {
    "word": "word.weight",
    "position": "position.weight",
    "tt0": "tt0",
    "ln_scale": "ln_scale",
    "ln_bias": "ln_bias",
}

# JAX ``head`` leaf -> (module attribute, transpose to [out, in])
_HEAD_LEAVES = {
    "pooler_w": ("pooler.weight", True), "pooler_b": ("pooler.bias", False),
    "cls_w": ("classifier.weight", True), "cls_b": ("classifier.bias", False),
}


# -- HF checkpoints -> the JAX-layout tree (as tpu_search/models/convert.py)


def _strip_prefixes(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Normalize key prefixes from MPNetModel / MPNetForMaskedLM /
    sentence-transformers exports down to bare module paths."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        for prefix in (
            "0.auto_model.", "auto_model.", "mpnet.", "bert.", "roberta.",
            "distilbert.", "model.",
        ):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        arr = np.asarray(
            value.detach().cpu().numpy() if hasattr(value, "detach") else value
        )
        out[key] = arr
    return out


def params_from_state_dict(
    state_dict: Mapping[str, Any], config: MPNetConfig
) -> Dict[str, Any]:
    """Torch MPNet state dict -> stacked-layer JAX pytree.

    Torch Linear weights are ``[out, in]``; ours are ``[in, out]``.
    """
    sd = _strip_prefixes(state_dict)

    def get(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(
                f"Missing weight '{name}' (have e.g. {list(sd)[:5]}...)"
            )
        return sd[name].astype(np.float32)

    def stack(fmt: str, transpose: bool) -> np.ndarray:
        mats = [get(fmt.format(i)) for i in range(config.num_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return np.stack(mats)

    a = "encoder.layer.{}.attention"
    return {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "rel_bias": get("encoder.relative_attention_bias.weight"),
        "layers": {
            "q_w": stack(a + ".attn.q.weight", True),
            "q_b": stack(a + ".attn.q.bias", False),
            "k_w": stack(a + ".attn.k.weight", True),
            "k_b": stack(a + ".attn.k.bias", False),
            "v_w": stack(a + ".attn.v.weight", True),
            "v_b": stack(a + ".attn.v.bias", False),
            "o_w": stack(a + ".attn.o.weight", True),
            "o_b": stack(a + ".attn.o.bias", False),
            "attn_ln_scale": stack(a + ".LayerNorm.weight", False),
            "attn_ln_bias": stack(a + ".LayerNorm.bias", False),
            "ff_in_w": stack("encoder.layer.{}.intermediate.dense.weight", True),
            "ff_in_b": stack("encoder.layer.{}.intermediate.dense.bias", False),
            "ff_out_w": stack("encoder.layer.{}.output.dense.weight", True),
            "ff_out_b": stack("encoder.layer.{}.output.dense.bias", False),
            "ff_ln_scale": stack("encoder.layer.{}.output.LayerNorm.weight", False),
            "ff_ln_bias": stack("encoder.layer.{}.output.LayerNorm.bias", False),
        },
    }


def config_from_hf(hf_config: Mapping[str, Any]) -> MPNetConfig:
    """HF config.json dict -> MPNetConfig (mpnet, bert, distilbert AND
    xlm-roberta)."""
    model_type = hf_config.get("model_type", "mpnet")
    # Sequence-classification checkpoints (the sentence-transformers
    # CrossEncoder rerankers, cross-encoder/ms-marco-*) carry a pooler +
    # classifier head; num_labels from id2label (HF convention), else 1.
    architectures = hf_config.get("architectures") or []
    num_labels = 0
    if any("ForSequenceClassification" in a for a in architectures):
        num_labels = len(hf_config.get("id2label") or {}) or 1
    if model_type == "distilbert":
        # DistilBERT is the BERT graph minus token-type embeddings (the
        # converter synthesizes tt0 = 0), with its own HF config field
        # names and a hardcoded LayerNorm eps (HF DistilBertModel uses
        # nn.LayerNorm(..., eps=1e-12) unconditionally).
        return MPNetConfig(
            vocab_size=hf_config.get("vocab_size", 30522),
            hidden_size=hf_config.get("dim", 768),
            num_layers=hf_config.get("n_layers", 6),
            num_heads=hf_config.get("n_heads", 12),
            intermediate_size=hf_config.get("hidden_dim", 3072),
            max_position=hf_config.get("max_position_embeddings", 512),
            layer_norm_eps=1e-12,
            pad_token_id=hf_config.get("pad_token_id", 0),
            arch="bert",
            num_labels=num_labels,
        )
    if model_type == "bert":
        arch = "bert"
    elif model_type in ("xlm-roberta", "roberta", "camembert"):
        arch = "xlmr"
    else:
        arch = "mpnet"
    return MPNetConfig(
        vocab_size=hf_config.get("vocab_size", 30527),
        hidden_size=hf_config.get("hidden_size", 768),
        num_layers=hf_config.get("num_hidden_layers", 12),
        num_heads=hf_config.get("num_attention_heads", 12),
        intermediate_size=hf_config.get("intermediate_size", 3072),
        max_position=hf_config.get("max_position_embeddings", 514),
        layer_norm_eps=hf_config.get("layer_norm_eps", 1e-5),
        pad_token_id=hf_config.get("pad_token_id", 0 if arch == "bert" else 1),
        relative_attention_num_buckets=hf_config.get(
            "relative_attention_num_buckets", 32
        ),
        arch=arch,
        num_labels=num_labels,
    )


_DISTILBERT_LAYER_KEYS = {
    "attention.q_lin": "attention.self.query",
    "attention.k_lin": "attention.self.key",
    "attention.v_lin": "attention.self.value",
    "attention.out_lin": "attention.output.dense",
    "sa_layer_norm": "attention.output.LayerNorm",
    "ffn.lin1": "intermediate.dense",
    "ffn.lin2": "output.dense",
    "output_layer_norm": "output.LayerNorm",
}


def _distilbert_to_bert_keys(
    sd: Mapping[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """Rename DistilBERT module paths (transformer.layer.N.attention.q_lin
    etc.) onto the BERT naming the shared stacker reads.  The two graphs
    are identical once token types are zeroed."""
    out: Dict[str, np.ndarray] = {}
    for key, value in sd.items():
        if key.startswith("transformer.layer."):
            rest = key[len("transformer.layer."):]
            idx, _, tail = rest.partition(".")
            for theirs, ours in _DISTILBERT_LAYER_KEYS.items():
                if tail.startswith(theirs + "."):
                    tail = ours + tail[len(theirs):]
                    break
            key = f"encoder.layer.{idx}.{tail}"
        out[key] = value
    return out


def params_from_bert_state_dict(
    state_dict: Mapping[str, Any], config: MPNetConfig
) -> Dict[str, Any]:
    """Torch BERT/XLM-RoBERTa/DistilBERT state dict (all-MiniLM-*,
    paraphrase-multilingual-*, multi-qa-distilbert-* and friends) -> the
    same stacked pytree the encoder consumes (token_type row 0 kept as
    the ``tt0`` vector — synthesized as zeros for DistilBERT, which has
    no token types; no relative bias)."""
    sd = _strip_prefixes(state_dict)
    if any(".q_lin." in key for key in sd):
        sd = _distilbert_to_bert_keys(sd)

    def get(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(
                f"Missing weight '{name}' (have e.g. {list(sd)[:5]}...)"
            )
        return sd[name].astype(np.float32)

    def stack(fmt: str, transpose: bool) -> np.ndarray:
        mats = [get(fmt.format(i)) for i in range(config.num_layers)]
        if transpose:
            mats = [m.T for m in mats]
        return np.stack(mats)

    a = "encoder.layer.{}.attention"
    h = config.hidden_size
    params: Dict[str, Any] = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "tt0": (
                get("embeddings.token_type_embeddings.weight")[0]
                if "embeddings.token_type_embeddings.weight" in sd
                else np.zeros((h,), np.float32)  # DistilBERT
            ),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "rel_bias": np.zeros(
            (config.relative_attention_num_buckets, config.num_heads),
            np.float32,
        ),
        "layers": {
            "q_w": stack(a + ".self.query.weight", True),
            "q_b": stack(a + ".self.query.bias", False),
            "k_w": stack(a + ".self.key.weight", True),
            "k_b": stack(a + ".self.key.bias", False),
            "v_w": stack(a + ".self.value.weight", True),
            "v_b": stack(a + ".self.value.bias", False),
            "o_w": stack(a + ".output.dense.weight", True),
            "o_b": stack(a + ".output.dense.bias", False),
            "attn_ln_scale": stack(a + ".output.LayerNorm.weight", False),
            "attn_ln_bias": stack(a + ".output.LayerNorm.bias", False),
            "ff_in_w": stack("encoder.layer.{}.intermediate.dense.weight", True),
            "ff_in_b": stack("encoder.layer.{}.intermediate.dense.bias", False),
            "ff_out_w": stack("encoder.layer.{}.output.dense.weight", True),
            "ff_out_b": stack("encoder.layer.{}.output.dense.bias", False),
            "ff_ln_scale": stack("encoder.layer.{}.output.LayerNorm.weight", False),
            "ff_ln_bias": stack("encoder.layer.{}.output.LayerNorm.bias", False),
        },
    }
    if config.num_labels > 0:
        # Cross-encoder (BertForSequenceClassification): pair inputs need
        # the full token-type table, and the head is BERT's pooler (kept
        # inside the base model state dict) + the top-level classifier.
        if "embeddings.token_type_embeddings.weight" in sd:
            params["embeddings"]["tt_table"] = get(
                "embeddings.token_type_embeddings.weight"
            )[:2]
        else:
            # DistilBERT-based sequence classifiers are NOT supported as
            # cross-encoders: DistilBertForSequenceClassification has no
            # tanh pooler (it uses pre_classifier + ReLU), so its head
            # cannot be mapped onto the tanh-pooler classify graph below
            # — a zero tt_table plus a key remap would silently compute
            # the wrong score.  All registered ms-marco rerankers are
            # BERT/MiniLM-based; fail loud for anything else.
            raise ValueError(
                "cross-encoder conversion requires a BERT-style pooler "
                "(tanh) head; DistilBERT-based sequence classifiers "
                "(pre_classifier + ReLU) are unsupported"
            )
        params["head"] = {
            "pooler_w": get("pooler.dense.weight").T,
            "pooler_b": get("pooler.dense.bias"),
            "cls_w": get("classifier.weight").T,
            "cls_b": get("classifier.bias"),
        }
    return params


# -- native checkpoint format


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_checkpoint(
    path: str, params: Dict[str, Any], config: MPNetConfig
) -> None:
    """Write a numpy parameter tree in the shared ``model.tpu.npz`` format."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    flat["__config__"] = np.frombuffer(
        json.dumps(config.__dict__).encode(), dtype=np.uint8
    )
    np.savez(path, **flat)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], MPNetConfig]:
    """``(numpy parameter tree, config)`` from a ``model.tpu.npz``."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    config_bytes = flat.pop("__config__").tobytes()
    config = MPNetConfig(**json.loads(config_bytes))
    return _unflatten(flat), config


def params_from_numpy(
    tree: Dict[str, Any], config: MPNetConfig
) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy parameter tree -> ``MPNetModel`` state dict (f32)."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    state: Dict[str, torch.Tensor] = {}
    emb = tree["embeddings"]
    for leaf, name in _EMBED_LEAVES.items():
        if leaf in emb:
            state[name] = t(emb[leaf])
        elif leaf == "tt0":
            state[name] = torch.zeros(config.hidden_size)
    if "rel_bias" in tree:
        state["rel_bias"] = t(tree["rel_bias"])
    else:  # BERT / XLM-R trees need none
        state["rel_bias"] = torch.zeros(
            config.relative_attention_num_buckets, config.num_heads)
    if config.num_labels > 0:
        # Without a token-type table, the JAX graph adds tt0 to every
        # token whatever its type: a table of two tt0 rows does the same.
        table = emb.get("tt_table")
        state["tt_table"] = (t(table) if table is not None
                             else state["tt0"].expand(2, -1).clone())
        head = tree.get("head")
        if head is None:
            raise ValueError("num_labels > 0 but the tree has no head")
        for leaf, (name, transpose) in _HEAD_LEAVES.items():
            value = np.asarray(head[leaf], np.float32)
            state[name] = t(value.T if transpose else value)
    layers = tree["layers"]
    for leaf, (name, transpose) in _LAYER_LEAVES.items():
        stacked = np.asarray(layers[leaf], np.float32)
        if stacked.shape[0] != config.num_layers:
            raise ValueError(
                f"layers/{leaf}: {stacked.shape[0]} layers, config says "
                f"{config.num_layers}"
            )
        for i in range(config.num_layers):
            value = stacked[i].T if transpose else stacked[i]
            state[f"layers.{i}.{name}"] = t(value)
    return state


def params_to_numpy(
    state, config: Optional[MPNetConfig] = None
) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: an ``MPNetModel`` (or a
    mapping of its parameter names to tensors of their shapes, such as
    AdamW's moments) -> the JAX-layout numpy tree (f32, ``[in, out]``
    weights, layers stacked), which ``save_checkpoint`` writes and both
    packages load."""
    if isinstance(state, torch.nn.Module):
        config = config or state.config
        state = dict(state.named_parameters())
    if config is None:
        raise ValueError("params_to_numpy needs the model's config")

    def a(name: str) -> np.ndarray:
        return state[name].detach().float().cpu().numpy()

    emb = {leaf: a(name) for leaf, name in _EMBED_LEAVES.items()}
    tree: Dict[str, Any] = {"embeddings": emb, "rel_bias": a("rel_bias")}
    if config.num_labels > 0:
        emb["tt_table"] = a("tt_table")
        tree["head"] = {leaf: (a(name).T if transpose else a(name))
                        for leaf, (name, transpose) in _HEAD_LEAVES.items()}
    tree["layers"] = {
        leaf: np.stack([
            a(f"layers.{i}.{name}").T if transpose
            else a(f"layers.{i}.{name}")
            for i in range(config.num_layers)])
        for leaf, (name, transpose) in _LAYER_LEAVES.items()
    }
    return tree


def int8_operands_from_numpy(
    w_q, scale, bias, device=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX int8 kernels' weight operands as the port's: a ``[K, N]``
    int8 weight (``tpu_search/ops/pallas_int8_gemm.py``'s layout) becomes
    ``[N, K]`` int8 rows (``[out, in]``, what ``ops/int8_gemm.py`` and
    ``ops/int8_ffn.py`` take), its ``[N]`` column scales and bias f32
    tensors, on ``device`` (default: ``resolve_device``, the card)."""
    from ..devices.capability import resolve_device

    dev = resolve_device(device)
    w = np.ascontiguousarray(np.asarray(w_q, dtype=np.int8).T)
    n = w.shape[0]

    def vec(a):
        v = np.asarray(a, dtype=np.float32).reshape(-1)
        if v.shape != (n,):
            raise ValueError(f"expected {n} values, got {v.shape}")
        return torch.from_numpy(v.copy()).to(dev)

    return torch.from_numpy(w).to(dev), vec(scale), vec(bias)


def model_from_params(
    tree: Dict[str, Any], config: MPNetConfig
) -> MPNetModel:
    """Build an ``MPNetModel`` (f32, on the CPU) holding ``tree``."""
    model = MPNetModel(config)
    model.load_state_dict(params_from_numpy(tree, config), strict=True)
    return model.eval()


# -- directories of downloaded checkpoints


def _find_torch_weights(model_dir: Path) -> Optional[Path]:
    """The weights file, ``model.safetensors`` first where the
    ``safetensors`` package is importable, then ``pytorch_model.bin``."""
    names = ["pytorch_model.bin", "0_Transformer/pytorch_model.bin"]
    patterns = ["pytorch_model.bin"]
    if importlib.util.find_spec("safetensors") is not None:
        names.insert(0, "model.safetensors")
        patterns.insert(0, "model.safetensors")
    for name in names:
        candidate = model_dir / name
        if candidate.exists():
            return candidate
    for pattern in patterns:
        hits = sorted(model_dir.rglob(pattern))
        if hits:
            return hits[0]
    return None


def _find_config(model_dir: Path, weights_path: Path) -> Mapping[str, Any]:
    for candidate in (weights_path.parent / "config.json",
                      model_dir / "config.json"):
        if candidate.exists():
            return json.loads(candidate.read_text())
    return {}


def _find_pooling_mode(model_dir: Path) -> str:
    """sentence-transformers pooling head -> "mean" | "cls" | "max".

    ST model dirs carry ``1_Pooling/config.json`` with boolean
    ``pooling_mode_*`` flags (the reference reads it through the
    SentenceTransformer loader, src/embeddings.py:86).  Plain HF dirs have
    no pooling module — mean is the sentence-embedding convention there.
    """
    hits = sorted(model_dir.glob("*_Pooling/config.json")) or sorted(
        model_dir.rglob("*_Pooling/config.json")
    )
    if not hits:
        return "mean"
    try:
        spec = json.loads(hits[0].read_text())
    except (json.JSONDecodeError, UnicodeDecodeError):
        return "mean"
    if spec.get("pooling_mode_cls_token"):
        return "cls"
    if spec.get("pooling_mode_max_tokens"):
        return "max"
    return "mean"


def convert_pretrained_dir(
    model_dir: str, output_path: str
) -> Tuple[Dict[str, Any], MPNetConfig]:
    """Convert a downloaded HF / sentence-transformers model directory into
    the native checkpoint: ``pytorch_model.bin`` through
    ``torch.load(weights_only=True)``, ``model.safetensors`` through the
    ``safetensors`` package where it is importable."""
    model_dir = Path(model_dir)
    weights = _find_torch_weights(model_dir)
    if weights is None:
        raise FileNotFoundError(
            f"No torch/safetensors weights under {model_dir}"
        )
    if weights.suffix == ".safetensors":
        from safetensors.numpy import load_file

        state_dict = load_file(str(weights))
    else:
        state_dict = torch.load(
            str(weights), map_location="cpu", weights_only=True
        )
    config = config_from_hf(_find_config(model_dir, weights))
    pooling = _find_pooling_mode(model_dir)
    if pooling != config.pooling:
        config = dataclasses.replace(config, pooling=pooling)
    if config.arch in ("bert", "xlmr"):
        params = params_from_bert_state_dict(state_dict, config)
    else:
        params = params_from_state_dict(state_dict, config)
    save_checkpoint(output_path, params, config)
    return params, config
