"""The port's BERT, DistilBERT and XLM-R encoders against the JAX package's
``encode`` on the CPU, with the same numpy-made weights reaching both, for
the three poolings; the HF-checkpoint converters of both packages on the
same synthetic state dicts; and ``EmbeddingGenerator`` end to end on a
BERT checkpoint with a WordPiece ``[CLS]`` vocabulary.

Tolerances (embedding cosine, per row):
- f32 compute, erf gelu: > 0.99999 (same math, sums in another order);
- bf16 compute, tanh gelu: > 0.999, with and without the int8 FFN (the
  JAX side runs its Pallas FFN in interpret mode): bf16 rounds at slightly
  different places in the two frameworks.
Converted trees are compared exactly (the same numpy code in both).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_search.models import convert as jax_convert
from tpu_search.models import mpnet as jm
from tpu_search.models.encoder import EmbeddingConfig as JaxEmbeddingConfig
from tpu_search.models.encoder import EmbeddingGenerator as JaxGenerator
from tpu_search_torch.models import convert
from tpu_search_torch.models.encoder import EmbeddingConfig, EmbeddingGenerator
from tpu_search_torch.models.mpnet import MPNetConfig, init_params

H, I, L = 128, 256, 2


def config(arch, pooling, heads=4, hidden=H, max_position=70):
    return MPNetConfig(
        vocab_size=100, hidden_size=hidden, num_layers=L, num_heads=heads,
        intermediate_size=I, max_position=max_position, arch=arch,
        pooling=pooling, pad_token_id=0 if arch == "bert" else 1,
        layer_norm_eps=1e-12 if arch == "bert" else 1e-5,
    )


def perturbed(cfg, seed=0):
    """``init_params`` with non-trivial LayerNorm and bias leaves, so every
    leaf matters."""
    p = init_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for key in ("ln_scale", "ln_bias"):
        p["embeddings"][key] = p["embeddings"][key] + (
            0.1 * rng.standard_normal(p["embeddings"][key].shape)
        ).astype(np.float32)
    for key, leaf in p["layers"].items():
        if key.endswith("_b") or "ln" in key:
            p["layers"][key] = leaf + (
                0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return p


def batch(cfg, seed=1, b=4, s=64):
    rng = np.random.default_rng(seed)
    pad = cfg.pad_token_id
    ids = rng.integers(4, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    for row, length in ((1, 40), (2, 5)):
        ids[row, length:] = pad
        mask[row, length:] = 0
    return ids, mask


def encode_both(cfg, p, dtype, int8, s=64):
    ids, mask = batch(cfg, s=s)
    jcfg = jm.MPNetConfig(**dataclasses.asdict(cfg))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # jitted, as the JAX package runs it (its gather clamps under jit)
    fn = jax.jit(functools.partial(jm.encode, config=jcfg, compute_dtype=jdt,
                                   int8_ffn=int8))
    ref = np.asarray(fn(p, jnp.asarray(ids), jnp.asarray(mask)))
    model = convert.model_from_params(p, cfg)
    model.layers.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    if int8:
        model.quantize_ffn()
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    int8_ffn=int8).numpy()
    return got, ref


def distilbert_state_dict(cfg, seed=7):
    """A random DistilBERT state dict (HF ``DistilBertModel`` key names)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    h, i = cfg.hidden_size, cfg.intermediate_size
    sd = {
        "distilbert.embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
        "distilbert.embeddings.position_embeddings.weight":
            w(cfg.max_position, h),
        "distilbert.embeddings.LayerNorm.weight": 1 + w(h),
        "distilbert.embeddings.LayerNorm.bias": w(h),
    }
    for n in range(cfg.num_layers):
        pre = f"distilbert.transformer.layer.{n}."
        for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
            sd[pre + f"attention.{lin}.weight"] = w(h, h)
            sd[pre + f"attention.{lin}.bias"] = w(h)
        sd[pre + "sa_layer_norm.weight"] = 1 + w(h)
        sd[pre + "sa_layer_norm.bias"] = w(h)
        sd[pre + "ffn.lin1.weight"] = w(i, h)
        sd[pre + "ffn.lin1.bias"] = w(i)
        sd[pre + "ffn.lin2.weight"] = w(h, i)
        sd[pre + "ffn.lin2.bias"] = w(h)
        sd[pre + "output_layer_norm.weight"] = 1 + w(h)
        sd[pre + "output_layer_norm.bias"] = w(h)
    return sd


def bert_state_dict(cfg, seed=8, prefix="bert.", head=False):
    """A random BERT / RoBERTa state dict (HF ``BertModel`` key names),
    with the pooler and classifier when ``head``."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return torch.from_numpy(
            (0.02 * rng.standard_normal(shape)).astype(np.float32))

    h, i = cfg.hidden_size, cfg.intermediate_size
    sd = {
        prefix + "embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
        prefix + "embeddings.position_embeddings.weight":
            w(cfg.max_position, h),
        prefix + "embeddings.token_type_embeddings.weight": w(2, h),
        prefix + "embeddings.LayerNorm.weight": 1 + w(h),
        prefix + "embeddings.LayerNorm.bias": w(h),
    }
    for n in range(cfg.num_layers):
        pre = f"{prefix}encoder.layer.{n}."
        for name in ("self.query", "self.key", "self.value", "output.dense"):
            sd[pre + f"attention.{name}.weight"] = w(h, h)
            sd[pre + f"attention.{name}.bias"] = w(h)
        sd[pre + "attention.output.LayerNorm.weight"] = 1 + w(h)
        sd[pre + "attention.output.LayerNorm.bias"] = w(h)
        sd[pre + "intermediate.dense.weight"] = w(i, h)
        sd[pre + "intermediate.dense.bias"] = w(i)
        sd[pre + "output.dense.weight"] = w(h, i)
        sd[pre + "output.dense.bias"] = w(h)
        sd[pre + "output.LayerNorm.weight"] = 1 + w(h)
        sd[pre + "output.LayerNorm.bias"] = w(h)
    if head:
        sd[prefix + "pooler.dense.weight"] = w(h, h)
        sd[prefix + "pooler.dense.bias"] = w(h)
        sd["classifier.weight"] = w(cfg.num_labels, h)
        sd["classifier.bias"] = w(cfg.num_labels)
    return sd


DTYPES = [("float32", False, 0.99999), ("bfloat16", False, 0.999),
          ("bfloat16", True, 0.999)]


@pytest.mark.parametrize("dtype,int8,min_cos", DTYPES)
@pytest.mark.parametrize("arch,pooling", [
    ("bert", "mean"), ("bert", "cls"), ("bert", "max"),
    ("xlmr", "mean"), ("xlmr", "cls"), ("xlmr", "max"),
])
def test_encode_matches_jax(arch, pooling, dtype, int8, min_cos):
    cfg = config(arch, pooling)
    got, ref = encode_both(cfg, perturbed(cfg), dtype, int8)
    assert got.shape == ref.shape == (4, H)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > min_cos, cos


@pytest.mark.parametrize("dtype,int8,min_cos", DTYPES)
def test_distilbert_matches_jax(dtype, int8, min_cos):
    hf = {"model_type": "distilbert", "vocab_size": 100, "dim": H,
          "n_layers": L, "n_heads": 4, "hidden_dim": I,
          "max_position_embeddings": 70}
    cfg = convert.config_from_hf(hf)
    assert cfg == dataclasses.replace(
        config("bert", "mean"), layer_norm_eps=1e-12)
    sd = distilbert_state_dict(cfg)
    p = convert.params_from_bert_state_dict(sd, cfg)
    jp = jax_convert.params_from_bert_state_dict(
        sd, jm.MPNetConfig(**dataclasses.asdict(cfg)))
    for a, b in zip(jax_convert._flatten(jp).items(),
                    convert._flatten(p).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    assert not p["embeddings"]["tt0"].any()  # DistilBERT has no token types
    got, ref = encode_both(cfg, p, dtype, int8)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > min_cos, cos


@pytest.mark.parametrize("heads", [3, 6])
def test_bhsd_head_sizes_match_jax(heads):
    """hd 26 (TinyBERT-312's head size) and hd 13: head sizes outside
    {32, 64, 128} take the bhsd layout in the port."""
    cfg = config("bert", "cls", heads=heads, hidden=78)
    got, ref = encode_both(cfg, perturbed(cfg), "float32", False)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > 0.99999, cos


@pytest.mark.parametrize("arch", ["bert", "xlmr"])
def test_positions_past_the_table_clamp(arch):
    """A bucket longer than the position table (the tiny-overlap
    reranker's 34 positions in the 64 bucket): the jitted JAX gather clamps
    the ids, and so does the port (no IndexError)."""
    cfg = config(arch, "cls", max_position=34)
    got, ref = encode_both(cfg, perturbed(cfg), "float32", False)
    cos = (got * ref).sum(axis=1)
    assert cos.min() > 0.99999, cos


def test_init_params_tree_matches_jax_shapes():
    """The port's numpy ``init_params`` builds the JAX package's tree
    (token-type table and head included), so one checkpoint serves both."""
    cfg = dataclasses.replace(config("bert", "cls"), num_labels=2)
    p = init_params(cfg, 0)
    jp = jm.init_params(jm.MPNetConfig(**dataclasses.asdict(cfg)),
                        jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in jax_convert._flatten(jp).items()}
    assert {k: v.shape for k, v in convert._flatten(p).items()} == want
    assert p["embeddings"]["tt0"].any()


@pytest.mark.parametrize("pooling_flag,pooling", [
    ("pooling_mode_cls_token", "cls"), ("pooling_mode_max_tokens", "max"),
    ("pooling_mode_mean_tokens", "mean"),
])
def test_convert_pretrained_dir_same_npz(tmp_path, pooling_flag, pooling):
    """A ``torch.save``d BERT state dict with its ``config.json`` and
    sentence-transformers pooling config converts to the same
    ``model.tpu.npz`` in both packages."""
    cfg = config("bert", pooling)
    model_dir = tmp_path / "st-bert"
    model_dir.mkdir()
    torch.save(bert_state_dict(cfg), model_dir / "pytorch_model.bin")
    (model_dir / "config.json").write_text(json.dumps({
        "model_type": "bert", "vocab_size": 100, "hidden_size": H,
        "num_hidden_layers": L, "num_attention_heads": 4,
        "intermediate_size": I, "max_position_embeddings": 70,
        "layer_norm_eps": 1e-12, "pad_token_id": 0,
    }))
    (model_dir / "1_Pooling").mkdir()
    (model_dir / "1_Pooling" / "config.json").write_text(
        json.dumps({pooling_flag: True}))
    _, got_cfg = convert.convert_pretrained_dir(
        str(model_dir), str(tmp_path / "port.npz"))
    _, want_cfg = jax_convert.convert_pretrained_dir(
        str(model_dir), str(tmp_path / "jax.npz"))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg == cfg
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in got.files:
            np.testing.assert_array_equal(got[key], want[key])


def test_convert_classifier_and_roberta_prefix():
    """A RoBERTa-prefixed sequence classifier converts to the same tree
    (token-type table and head included) in both packages, and an XLM-R
    config maps to ``arch="xlmr"``."""
    hf = {"model_type": "xlm-roberta", "vocab_size": 100, "hidden_size": H,
          "num_hidden_layers": L, "num_attention_heads": 4,
          "intermediate_size": I, "max_position_embeddings": 70,
          "architectures": ["XLMRobertaForSequenceClassification"],
          "id2label": {"0": "a", "1": "b"}}
    cfg = convert.config_from_hf(hf)
    assert (cfg.arch, cfg.num_labels, cfg.pad_token_id) == ("xlmr", 2, 1)
    sd = bert_state_dict(cfg, prefix="roberta.", head=True)
    p = convert.params_from_bert_state_dict(sd, cfg)
    jp = jax_convert.params_from_bert_state_dict(
        sd, jm.MPNetConfig(**dataclasses.asdict(cfg)))
    flat, jflat = convert._flatten(p), jax_convert._flatten(jp)
    assert sorted(flat) == sorted(jflat)
    for key in flat:
        np.testing.assert_array_equal(flat[key], jflat[key])
    model = convert.model_from_params(p, cfg)
    np.testing.assert_array_equal(model.classifier.weight.detach().numpy(),
                                  p["head"]["cls_w"].T)


def write_bert_model(model_dir, cfg, seed=3):
    """A BERT checkpoint and a bare ``[CLS]`` WordPiece vocabulary."""
    model_dir.mkdir(parents=True)
    convert.save_checkpoint(str(model_dir / "model.tpu.npz"),
                            perturbed(cfg, seed), cfg)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"tok{i}" for i in range(cfg.vocab_size - 5)]
    (model_dir / "vocab.txt").write_text("\n".join(vocab) + "\n")


def test_embedding_generator_bert_matches_jax(tmp_path):
    """The slice as a whole: ``EmbeddingGenerator`` on a BERT checkpoint
    with CLS pooling (WordPiece ``[CLS]`` vocabulary, bucketing, pad rows,
    bf16 compute) agrees with the JAX package's generator."""
    cfg = config("bert", "cls")
    write_bert_model(tmp_path / "models" / "tiny-bert", cfg)
    texts = ["tok1 tok2 tok3", "tok50 " * 30, "TOK7, tok8! unknownword", ""]
    port = EmbeddingGenerator(EmbeddingConfig(
        model_name="tiny-bert", cache_dir=str(tmp_path / "models"),
        device="cpu", show_progress=False))
    ref = JaxGenerator(JaxEmbeddingConfig(
        model_name="tiny-bert", cache_dir=str(tmp_path / "models"),
        device="cpu", show_progress=False))
    for gen in (port, ref):
        gen.load_model()
    assert port._tokenizer.bos_id == 2 and port._tokenizer.pad_id == 0
    got = port._encode_texts(port._validated(texts))
    want = ref._generate_embeddings_batch(texts)
    assert got.shape == want.shape == (4, H)
    cos = (got * want).sum(axis=1)
    assert cos.min() > 0.999, cos
