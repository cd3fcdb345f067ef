"""RoFormer in the text encoder (K8): the port's `roformer` model type
(models/roformer.py: no position embedding, the sinusoidal table read or
built, the interleaved rotation of Q and K, and of V with
`rotary_value`), its weight names, the refusal of RoFormer's jieba
tokenizer class, and the encoder against transformers and the JAX
package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny RoFormers (hidden 32, 4 heads of 8,
intermediate 64, 256 positions) are built from a `RoFormerConfig` with
weights drawn with numpy from a seed (LayerNorm scales and every bias off
their defaults, Q and K with a standard deviation of 0.15):
- `plain`: rotary on Q and K, `embedding_size` = `hidden_size`;
- `rv`: `rotary_value` and 16-wide embeddings through
  `embeddings_project`.
Each is saved as pytorch_model.bin (the JAX package's torch branch), as
model.safetensors, and as the port's `write_checkpoint` writes it, beside
a WordPiece vocab.txt with CJK characters and BertTokenizer's class
(`AutoTokenizer` raises on RoFormerTokenizer without `rjieba`); `nopos`
is `plain` with the sinusoidal table taken out of the file, as
transformers then builds it. A directory with transformers' own
flax_model.msgpack makes the JAX package's Flax branch raise at `encode`
(fault 3.23); the port embeds it as the torch branch does."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from transformers.models.roformer import modeling_roformer as hf_roformer  # noqa: E402

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, hf_encoder, roformer  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "机器", "学习", "搜索", "引擎", "数据库"]
CJK = "机器学习搜索引擎数据库的是在中文相似度"
VOCAB = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS[:8] + list(CJK)
    + list("abcdefghijklmnopqrstuvwxyz0123456789.,!?'-")
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]))
TEXTS = ["Hello, World!", "机器学习的搜索引擎", "中文 相似度 search", "", "[MASK] 数据库 [SEP]",
         "the cloud of machine learning " * 4]
KINDS = {"plain": dict(), "rv": dict(rotary_value=True, embedding_size=16)}


def _config(kind):
    return transformers.RoFormerConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=256, type_vocab_size=2,
        layer_norm_eps=1e-12, pad_token_id=0, **KINDS[kind])


def _draw_weights(model, seed):
    """Every parameter but the sinusoidal table drawn with numpy:
    LayerNorm scales near 1, Q and K normal(0, 0.15), everything else
    normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("embed_positions.weight"):
                continue
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path):
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in VOCAB))
    transformers.BertTokenizerFast(os.path.join(path, "vocab.txt"),
                                   do_lower_case=True).save_pretrained(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`{kind}` pytorch_model.bin, `{kind}_st` model.safetensors,
    `{kind}_port` the port's write_checkpoint; `nopos`: `plain` without
    the table in its file; `flax`: `plain` with flax_model.msgpack beside
    its pytorch_model.bin."""
    root = tmp_path_factory.mktemp("roformer")
    out = {}
    for i, kind in enumerate(KINDS):
        model = transformers.RoFormerModel(_config(kind))
        _draw_weights(model, seed=41 + i)
        for name, safe in ((kind, False), (f"{kind}_st", True)):
            out[name] = str(root / name)
            model.save_pretrained(out[name], safe_serialization=safe)
            _write_tokenizer(out[name])
        c = checkpoint.load_checkpoint(out[kind])
        out[f"{kind}_port"] = str(root / f"{kind}_port")
        checkpoint.write_checkpoint(out[f"{kind}_port"], c.config, c.state_dict, VOCAB)
    out["nopos"] = str(root / "nopos")
    shutil.copytree(out["plain"], out["nopos"])
    path = os.path.join(out["nopos"], "pytorch_model.bin")
    state = torch.load(path, weights_only=True)
    del state[roformer.POSITIONS]
    torch.save(state, path)
    out["flax"] = str(root / "flax")
    shutil.copytree(out["plain"], out["flax"])
    transformers.FlaxRoFormerModel.from_pretrained(out["plain"], from_pt=True).save_pretrained(
        out["flax"])
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops on one thread: seconds, not minutes, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, hi, n)]


def _batch():
    return _texts(5, seed=9) + TEXTS + [" ".join(WORDS * 8)]


# -- the table, the rotation, configs and weight names ---------------------------------


@pytest.mark.parametrize("n, dim", [(1536, 64), (256, 8), (512, 7), (33, 5)])
def test_the_sinusoidal_table_is_transformers_bit_for_bit(n, dim):
    """`sinusoidal_table` equals `RoFormerSinusoidalPositionalEmbedding`'s
    own `_init_weight` (junnyu/roformer_chinese_base: 1536 x 64; an odd
    width too)."""
    ref = hf_roformer.RoFormerSinusoidalPositionalEmbedding(n, dim)
    ref._init_weight()
    assert torch.equal(roformer.sinusoidal_table(n, dim), ref.weight.data)


def test_the_file_holds_the_table_and_a_file_without_it_gets_it_built(ckpt):
    """save_pretrained writes the table; the port reads it, and builds the
    same one for a file that lacks it, as transformers does on load."""
    with_table = checkpoint.load_checkpoint(ckpt["plain"]).state_dict[roformer.POSITIONS]
    raw = torch.load(os.path.join(ckpt["nopos"], "pytorch_model.bin"), weights_only=True)
    assert roformer.POSITIONS not in raw
    built = checkpoint.load_checkpoint(ckpt["nopos"]).state_dict[roformer.POSITIONS]
    ref = transformers.AutoModel.from_pretrained(ckpt["nopos"]).encoder.embed_positions.weight
    assert torch.equal(built, with_table) and torch.equal(built, ref.data)


def test_the_rotation_is_interleaved():
    """x cos + [-x1, x0, -x3, x2, ...] sin with sin and cos repeated in
    pairs: transformers' `apply_rotary_position_embeddings` bit for bit,
    and not the half split."""
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(2, 4, 11, 8, generator=g), torch.randn(2, 4, 11, 8, generator=g)
    model = roformer.RoFormerModel(_config("plain").to_dict())
    with torch.no_grad():
        model.encoder.embed_positions.weight.copy_(roformer.sinusoidal_table(256, 8))
    sin, cos = model.rotary(11)
    table = model.encoder.embed_positions.weight[:11][None, None]
    want_q, want_k = hf_roformer.RoFormerSelfAttention.apply_rotary_position_embeddings(
        table, q, k)
    assert torch.equal(roformer.rotate(q, sin, cos), want_q)
    assert torch.equal(roformer.rotate(k, sin, cos), want_k)
    half = torch.cat([-q[..., 4:], q[..., :4]], dim=-1)
    assert not torch.allclose(q * cos + half * sin, want_q, atol=1e-3)


@pytest.mark.parametrize("kind", ["plain", "rv"])
def test_the_module_names_are_transformers(ckpt, kind):
    c = checkpoint.load_checkpoint(ckpt[kind])
    model = checkpoint.build_model(c)
    theirs = transformers.AutoModel.from_pretrained(ckpt[kind]).state_dict()
    assert set(model.state_dict()) == set(theirs)
    assert (model.embeddings_project is not None) == (kind == "rv")
    assert model.config["rotary_value"] == (kind == "rv")


@pytest.mark.parametrize("change, match", [
    ({"hidden_act": "gelu_10"}, "hidden_act"),
    ({"position_embedding_type": "relative_key"}, "position_embedding_type"),
])
def test_unread_roformer_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["plain"]).config, **change}
    with pytest.raises(ValueError, match=match):
        roformer.RoFormerModel(config)


@pytest.mark.parametrize("cls", ["RoFormerTokenizer", "RoFormerTokenizerFast"])
def test_roformer_tokenizer_class_is_refused_by_name(ckpt, tmp_path, cls):
    """RoFormer's tokenizer pre-tokenizes with jieba, which the port does
    not run (and AutoTokenizer raises on without rjieba): refused by name,
    where a vocab.txt read as BERT's would give other ids."""
    path = tmp_path / "rf"
    shutil.copytree(ckpt["plain"], path)
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": cls, "do_lower_case": True}, f)
    with pytest.raises(ValueError, match=cls):
        checkpoint.load_checkpoint(str(path))


def test_masked_lm_checkpoints_load_under_the_base_names(ckpt):
    """The `roformer.` prefix and the `cls.` head are dropped."""
    state = checkpoint.read_weights(ckpt["rv"])
    named = transformers.RoFormerForMaskedLM.from_pretrained(ckpt["rv"]).state_dict()
    assert any(k.startswith("cls.") for k in named)
    got = checkpoint.hf_to_state_dict(named)
    assert set(got) == set(state)
    for name in state:
        assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "rv", "nopos"])
def test_forward_matches_automodel(ckpt, kind):
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    assert type(ref).__name__ == "RoFormerModel"
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("kind", ["plain_port", "rv_port"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == "RoFormerModel"
    assert not info["missing_keys"] and not info["unexpected_keys"]


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["plain", "plain_st", "plain_port", "rv", "rv_st", "rv_port",
                                  "nopos"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory
    against each weight route, pooled and normalized."""
    texts = _batch()
    jax_enc = FlaxTextEncoder(ckpt[kind.split("_")[0]], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_fault_323_the_jax_flax_branch_raises_on_roformer(ckpt):
    """With flax_model.msgpack, FlaxAutoModel loads RoFormer and the JAX
    package's `module.apply(params, input_ids, attention_mask)` lacks
    FlaxRoFormerModule's token_type_ids and head_mask: it raises. The port
    embeds that directory as the torch branch embeds the
    pytorch_model.bin one."""
    jax_enc = FlaxTextEncoder(ckpt["flax"], "useModel")
    with pytest.raises(TypeError, match="token_type_ids|head_mask"):
        jax_enc.encode(["hello world"])
    assert jax_enc._flax is not None
    texts = _batch()
    want = FlaxTextEncoder(ckpt["plain"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt["flax"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL
