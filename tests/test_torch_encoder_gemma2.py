"""Gemma 2 and Gemma in the text encoder (K8): the port's `gemma2` model type
(models/gemma2.py: Gemma 3's stack without Q/K norms, one rotary,
causal, sliding and full layers) and `gemma` (models/decoder.py: Llama's
layout with Gemma's `(1 + w)` RMSNorm, the scaled embedding and
`hidden_act`), their weight names, and the encoder against transformers
and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny stacks (hidden 64, 4 heads of 16 over 2 KV
heads, intermediate 96) are built from transformers' `Gemma2Config` and
`GemmaConfig`, their weights drawn with numpy from a seed: the `(1 + w)`
norm weights at 0 +- 0.3, Q and K at 0.15 so attention is peaked and an
off-by-one window or a scale otherwise shows. They are saved by
transformers as pytorch_model.bin (a Gemma model.safetensors breaks the
JAX package's Flax branch, fault 3.17) beside models/fixtures.py's seeded
tokenizer in Gemma's layout (GemmaTokenizerFast: left padding by class
default, `<bos> $A`). Gemma 2 has no Flax class, and Flax Gemma is not
read from pytorch_model.bin, so the JAX package's encoder runs
transformers' torch model (its AutoModel branch, `sdpa`). The port is
held against it within 1e-5 on normalized vectors, for both poolings and
both padding sides, and against `AutoModel` on every row of the last
hidden state under `sdpa`, and on the real rows under `eager` (the same
products; Gemma 2's without the softcap that only `eager` applies)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    activations,
    bpe,
    checkpoint,
    decoder,
    fixtures,
    gemma2,
    hf_encoder,
    rope,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-4  # a trap undone must move the last hidden state this far (10 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文"]
TEXTS = ["hello world", "", "😀 中文 é", "<start_of_turn>user hi<end_of_turn>",
         " ".join(WORDS * 3), "x<table>y  z", "tab\there\nnew line"]
SMALL = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16)
# BAAI/bge-multilingual-gemma2's config.json widths (gemma-2-9b's)
BGE_MULTILINGUAL_GEMMA2 = {
    "model_type": "gemma2", "vocab_size": 256_000, "hidden_size": 3584,
    "intermediate_size": 14_336, "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "query_pre_attn_scalar": 256,
    "sliding_window": 4096, "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "rope_theta": 10_000.0, "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh",
    "max_position_embeddings": 8192,
}
# google/gemma-2b's config.json widths: one KV head
GEMMA_2B = {"model_type": "gemma", "vocab_size": 256_000, "hidden_size": 2048,
            "intermediate_size": 16_384, "num_hidden_layers": 18, "num_attention_heads": 8,
            "num_key_value_heads": 1, "head_dim": 256, "hidden_act": "gelu",
            "hidden_activation": "gelu_pytorch_tanh"}
# name -> (model type, config arguments, saved from *ForCausalLM)
CONFIGS = {
    "gemma2": ("gemma2", dict(num_hidden_layers=2, sliding_window=6, query_pre_attn_scalar=16),
               False),
    # layer_types left out of config.json: derived, sliding then full
    "gemma2-derived": ("gemma2", dict(num_hidden_layers=4, sliding_window=6,
                                      query_pre_attn_scalar=16), False),
    # gemma-2-27b's ratio: query_pre_attn_scalar 144 is not head_dim
    "gemma2-144": ("gemma2", dict(num_hidden_layers=2, sliding_window=6,
                                  query_pre_attn_scalar=144), False),
    "gemma2-lm": ("gemma2", dict(num_hidden_layers=2, sliding_window=6,
                                 query_pre_attn_scalar=16), True),
    # the MLP reads hidden_act (the erf GELU), never hidden_activation
    "gemma": ("gemma", dict(num_hidden_layers=2, hidden_act="gelu",
                            hidden_activation="gelu_pytorch_tanh"), False),
    "gemma-silu": ("gemma", dict(num_hidden_layers=2, hidden_act="silu",
                                 hidden_activation="gelu_pytorch_tanh"), False),
    "gemma-mqa": ("gemma", dict(num_hidden_layers=2, num_key_value_heads=1), False),
    "gemma-lm": ("gemma", dict(num_hidden_layers=2), True),
}
SHALLOW = ("gemma2", "gemma")
CLASSES = {("gemma2", False): "Gemma2Model", ("gemma2", True): "Gemma2ForCausalLM",
           ("gemma", False): "GemmaModel", ("gemma", True): "GemmaForCausalLM"}


def _texts(n, seed, lo=0, hi=40):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops on one thread: seconds, not minutes, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            sd = 0.3 if "norm" in name else 0.15 if ("q_proj" in name or "k_proj" in name) \
                else 0.05
            p.copy_(torch.from_numpy(rng.normal(0.0, sd, tuple(p.shape)).astype(np.float32)))


def _tokenizer_files(path, spec, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.gemma_tokenizer_config(spec, padding_side=side), f)


def _with_config(src, dst, **changes):
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "config.json")) as f:
        config = json.load(f)
    config.update(changes)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config, f)
    return str(dst)


@pytest.fixture(scope="module")
def spec():
    return fixtures.gemma_tokenizer_json(_texts(200, seed=1) + TEXTS, 1200, seed=15)


@pytest.fixture(scope="module")
def ckpt(spec, tmp_path_factory):
    """`{name}` for each of CONFIGS, left-padded (GemmaTokenizerFast's
    default) as pytorch_model.bin; `{name}-right` with padding_side right
    for the shallow ones; `gemma-st`: gemma as model.safetensors."""
    root = tmp_path_factory.mktemp("gemma2")
    out = {}
    for i, (name, (kind, kwargs, causal_lm)) in enumerate(CONFIGS.items()):
        config = transformers.AutoConfig.for_model(
            kind, vocab_size=len(spec["model"]["vocab"]), **{**SMALL, **kwargs})
        model = getattr(transformers, CLASSES[kind, causal_lm])(config)
        _draw_weights(model, 90 + i)
        for side in ("left", "right") if name in SHALLOW else ("left",):
            key = name if side == "left" else f"{name}-right"
            path = out[key] = str(root / key)
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, spec, None if side == "left" else "right")
            if name == "gemma2-derived":
                with open(os.path.join(path, "config.json")) as f:
                    saved = json.load(f)
                del saved["layer_types"]
                with open(os.path.join(path, "config.json"), "w") as f:
                    json.dump(saved, f)
        if name == "gemma":
            path = out["gemma-st"] = str(root / "gemma-st")
            model.save_pretrained(path)
            _tokenizer_files(path, spec)
    return out


def _reference(path, impl="sdpa"):
    ref = transformers.AutoModel.from_pretrained(path, attn_implementation=impl).eval()
    assert ref.config._attn_implementation == impl
    return ref


def _forward(path, texts, impl="sdpa"):
    """(port, reference, mask): the last hidden states of `texts` in one
    padded batch."""
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(path, impl)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    return got, want, mask


# -- config, layers and weights --------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_the_config_reads_as_transformers(ckpt, name):
    """The module, its layer types and window as transformers' config
    object holds them, and GemmaTokenizerFast's left padding."""
    kind = CONFIGS[name][0]
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[name])
    if kind == "gemma2":
        assert isinstance(model, gemma2.Gemma2Model)
        assert model.config["layer_types"] == want.layer_types
        assert [layer.sliding for layer in model.layers] == [
            t == "sliding_attention" for t in want.layer_types]
        assert model.config["window"] == want.sliding_window and model.config["causal"]
        assert not hasattr(model.layers[0].self_attn, "q_norm")
        assert model.local_rope is model.rope
    else:
        assert isinstance(model, decoder.DecoderModel)
        assert model.config["window"] is None
        assert set(model.config["layer_types"]) == {"full_attention"}
        assert isinstance(model.norm, decoder.GemmaRMSNorm)
    assert model.config["num_key_value_heads"] == want.num_key_value_heads
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and tok.byte_fallback and tok.padding_side == "left"


def test_gemma2_layer_types_are_derived_as_gemma2config_derives_them(ckpt):
    """A config.json without layer_types: layer i slides iff (i + 1) is
    odd, as Gemma2Config builds it."""
    c = checkpoint.load_checkpoint(ckpt["gemma2-derived"])
    assert "layer_types" not in c.config
    want = transformers.Gemma2Config(num_hidden_layers=7).layer_types
    assert want == ["sliding_attention", "full_attention"] * 3 + ["sliding_attention"]
    assert gemma2.check_config({**c.config, "num_hidden_layers": 7})["layer_types"] == want
    model = checkpoint.build_model(c)
    assert [layer.sliding for layer in model.layers] == [True, False, True, False]
    got, ref, _mask = _forward(ckpt["gemma2-derived"], _texts(4, seed=20, lo=10) + TEXTS)
    assert float((got - ref).abs().max()) <= ATOL


def test_the_published_widths():
    """bge-multilingual-gemma2 (gemma-2-9b's widths): Q 16 x 256 = 4,096
    wide on a 3,584-wide model, 198.18 M Linear weights a layer, 792.7 M
    at 4 layers, a 917.5 M-weight embedding; gemma-2b: one KV head of 256."""
    config = gemma2.check_config(BGE_MULTILINGUAL_GEMMA2)
    assert config["layer_types"] == ["sliding_attention", "full_attention"] * 21
    with torch.device("meta"):
        model = gemma2.Gemma2Model({**BGE_MULTILINGUAL_GEMMA2, "num_hidden_layers": 4})
    assert [layer.sliding for layer in model.layers] == [True, False] * 2
    attn = model.layers[0].self_attn
    assert tuple(attn.q_proj.weight.shape) == (4096, 3584)
    assert tuple(attn.k_proj.weight.shape) == (2048, 3584)
    assert tuple(attn.o_proj.weight.shape) == (3584, 4096)
    linear = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert linear == 4 * 198_180_864 == 792_723_456
    assert model.embed_tokens.weight.numel() == 917_504_000
    with torch.device("meta"):
        small = decoder.DecoderModel({**GEMMA_2B, "num_hidden_layers": 1})
    attn = small.layers[0].self_attn
    assert tuple(attn.k_proj.weight.shape) == tuple(attn.v_proj.weight.shape) == (256, 2048)
    assert attn.heads // attn.kv_heads == 8


def test_defaults_fill_what_a_config_leaves_out():
    """A config with only the widths resolves as Gemma2Config and
    GemmaConfig do."""
    widths = {"vocab_size": 100, "hidden_size": 64, "intermediate_size": 96,
              "num_hidden_layers": 3, "num_attention_heads": 4}
    got = gemma2.check_config({"model_type": "gemma2", **widths})
    want = transformers.Gemma2Config(**widths)
    for key in ("num_key_value_heads", "head_dim", "hidden_activation", "rms_norm_eps",
                "rope_theta", "attention_bias", "query_pre_attn_scalar", "layer_types",
                "attn_logit_softcapping", "final_logit_softcapping", "max_position_embeddings"):
        assert got[key] == getattr(want, key), key
    assert got["window"] == want.sliding_window == 4096
    for heads in (16, 32):  # GemmaConfig's 16 KV heads, whatever the query heads
        widths["num_attention_heads"] = heads
        got = decoder.check_config({"model_type": "gemma", **widths})
        want = transformers.GemmaConfig(**widths)
        for key in ("num_key_value_heads", "head_dim", "hidden_act", "rms_norm_eps",
                    "rope_theta", "attention_bias", "max_position_embeddings"):
            assert got[key] == getattr(want, key), (heads, key)
        assert got["num_key_value_heads"] == 16


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """Gemma2ForCausalLM's and GemmaForCausalLM's names (`model.` prefix,
    the tied `lm_head.`) map onto the port's modules."""
    for name, module in (("gemma2-lm", gemma2.Gemma2Model),
                         ("gemma-lm", decoder.DecoderModel)):
        c = checkpoint.load_checkpoint(ckpt[name])
        kind = CONFIGS[name][0]
        lm = getattr(transformers, CLASSES[kind, True]).from_pretrained(ckpt[name]).state_dict()
        assert all(k.startswith(("model.", "lm_head.")) for k in lm) and "lm_head.weight" in lm
        got = checkpoint.hf_to_state_dict(lm)
        with torch.device("meta"):
            names = set(module(c.config).state_dict())
        assert set(got) == set(c.state_dict) == names
        assert all(torch.equal(got[k], c.state_dict[k]) for k in got)


@pytest.mark.parametrize("kind", ["gemma2", "gemma"])
def test_partial_rotary_factor_is_refused_as_the_reference_raises(kind):
    """partial_rotary_factor 0.5: the rotary tables cover half the head and
    transformers' apply_rotary_pos_emb raises on the sizes; the port
    refuses the config by name."""
    config = transformers.AutoConfig.for_model(kind, vocab_size=100, num_hidden_layers=1,
                                               **SMALL, partial_rotary_factor=0.5)
    model = transformers.AutoModel.from_config(config).eval()
    ids = torch.arange(12)[None]
    with pytest.raises(RuntimeError, match="size of tensor"), torch.no_grad():
        model(input_ids=ids, attention_mask=torch.ones_like(ids))
    with pytest.raises(ValueError, match="partial_rotary_factor"):
        checkpoint.check_config({"model_type": kind, "vocab_size": 100, "num_hidden_layers": 1,
                                 **SMALL, "partial_rotary_factor": 0.5})


REFUSED = [
    ("gemma2", {"layer_types": ["chunked_attention"] * 2}, "layer_types"),
    ("gemma2", {"sliding_window": None}, "sliding_window"),
    ("gemma2", {"num_key_value_heads": 3}, "num_key_value_heads"),
    ("gemma2", {"hidden_activation": "gelu_10"}, "hidden_activation"),
    ("gemma2", {"rope_scaling": {"rope_type": "mrope", "factor": 2.0}}, "rope_type"),
    ("gemma", {"hidden_act": "gelu_10"}, "hidden_act"),
    ("gemma", {"rope_scaling": {"rope_type": "longrope", "short_factor": [1.0] * 8,
                                "long_factor": [1.0] * 8}}, "longrope"),
]


@pytest.mark.parametrize("kind, change, match", REFUSED)
def test_unread_configs_are_refused(kind, change, match):
    config = {"model_type": kind, "vocab_size": 100, "num_hidden_layers": 2, **SMALL, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


@pytest.mark.parametrize("kind", ["gemma2", "gemma"])
@pytest.mark.parametrize("scaling", [{"rope_type": "linear", "factor": 4.0},
                                     {"type": "linear", "factor": 4.0},
                                     {"rope_type": "yarn", "factor": 4.0}])
def test_a_rope_scaling_in_config_json_is_honoured(kind, scaling):
    """Neither config class names rope_scaling, yet both rotary modules read
    it (a bare `type` too): the port's tables equal theirs bit for bit."""
    from transformers.models.gemma.modeling_gemma import GemmaRotaryEmbedding
    from transformers.models.gemma2.modeling_gemma2 import Gemma2RotaryEmbedding

    config = transformers.AutoConfig.for_model(kind, vocab_size=100, num_hidden_layers=2,
                                               **SMALL, rope_scaling=dict(scaling))
    cls = Gemma2RotaryEmbedding if kind == "gemma2" else GemmaRotaryEmbedding
    with torch.device("meta"):
        model = checkpoint.new_model({"model_type": kind, "vocab_size": 100,
                                      "num_hidden_layers": 2, **SMALL,
                                      "rope_scaling": dict(scaling)})
    assert model.rope.kind == rope.rope_type(scaling)
    for L in (1, 7, 200):
        want_cos, want_sin = cls(config)(torch.zeros(1, L, 64), torch.arange(L)[None])
        cos, sin = model.rope.tables(L, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L


# -- the forward and its traps -------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", SHALLOW)
def test_forward_matches_transformers_on_every_row(ckpt, name, side, tmp_path):
    """Padded batches of texts of 1 to 40 words: every row of the last
    hidden state, padded ones included, equals AutoModel's default (sdpa)
    within ATOL, and the real rows equal `eager` (Gemma 2's without its
    softcap, which only `eager` applies)."""
    path = ckpt[name if side == "left" else f"{name}-right"]
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(path, texts)
    assert int((mask == 0).sum()) > 0 and mask.shape[1] > 20
    assert bool((mask[:, -1 if side == "left" else 0] == 1).all())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL
    plain = path if name == "gemma" else _with_config(path, tmp_path / "plain",
                                                      attn_logit_softcapping=None)
    _got, eager, _mask = _forward(plain, texts, "eager")
    assert float((got - eager)[mask.bool()].abs().max()) <= ATOL


def test_fault_320_gemma2_softcapping_is_ignored(ckpt, tmp_path):
    """transformers' sdpa attention drops attn_logit_softcapping, which only
    its `eager` function applies: a cap of 0.5 leaves AutoModel's output
    and the JAX package's vectors as they are without one (while `eager`
    moves past BITES); the port ignores it too."""
    capped = _with_config(ckpt["gemma2"], tmp_path / "capped", attn_logit_softcapping=0.5)
    plain = _with_config(ckpt["gemma2"], tmp_path / "plain", attn_logit_softcapping=None)
    texts = _texts(6, seed=4) + TEXTS
    got, want, mask = _forward(capped, texts)
    _got, want_plain, _mask = _forward(plain, texts)
    assert torch.equal(want, want_plain)
    _got, eager, _mask = _forward(capped, texts, "eager")
    assert float((eager - want)[mask.bool()].abs().max()) > BITES
    assert float((got - want).abs().max()) <= ATOL
    jax_capped = FlaxTextEncoder(capped, "useModel").encode(texts)
    np.testing.assert_array_equal(jax_capped, FlaxTextEncoder(plain, "useModel").encode(texts))
    port = hf_encoder.TextEncoder(capped, "useModel", device=None).encode(texts)
    assert float(np.abs(port - jax_capped).max()) <= ATOL


def test_the_window_bites(ckpt):
    """Mutation guard: one token more or less of reach moves Gemma 2's last
    hidden state past BITES on texts longer than the window."""
    c = checkpoint.load_checkpoint(ckpt["gemma2"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=11, lo=20), 512)
    window = model.config["window"]
    with torch.no_grad():
        want = model(ids, mask)
        for moved in (-1, 1):
            model.config["window"] = window + moved
            assert float((model(ids, mask) - want).abs().max()) > BITES, moved
    model.config["window"] = window


def test_query_pre_attn_scalar_144_scales_the_scores(ckpt):
    """gemma-2-27b's ratio: scores times 144 ** -0.5 on 16-wide heads. The
    port equals the reference, and scaling by head_dim ** -0.5 instead
    moves past BITES."""
    texts = _texts(6, seed=13) + TEXTS
    got, want, _mask = _forward(ckpt["gemma2-144"], texts)
    assert float((got - want).abs().max()) <= ATOL
    c = checkpoint.load_checkpoint(ckpt["gemma2-144"])
    model = checkpoint.build_model(c)
    assert model.config["query_pre_attn_scalar"] == 144 and model.config["head_dim"] == 16
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    model.config["query_pre_attn_scalar"] = 16
    with torch.no_grad():
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_gemma_reads_hidden_act_not_hidden_activation(ckpt):
    """GemmaMLP reads hidden_act (the erf GELU here, SiLU in `gemma-silu`);
    hidden_activation (the tanh GELU) is read by nothing. The port equals
    the reference, and running hidden_activation moves past BITES."""
    for name, act in (("gemma", "gelu"), ("gemma-silu", "silu")):
        ref = _reference(ckpt[name])
        assert ref.config.hidden_act == act
        assert ref.config.hidden_activation == "gelu_pytorch_tanh"
        c = checkpoint.load_checkpoint(ckpt[name])
        model = checkpoint.build_model(c)
        assert all(layer.mlp.act is activations.ACTIVATIONS[act] for layer in model.layers)
        texts = _texts(6, seed=14) + TEXTS
        ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
        with torch.no_grad():
            want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
            got = model(ids, mask)
            assert float((got - want).abs().max()) <= ATOL
            if act == "silu":
                for layer in model.layers:
                    layer.mlp.act = activations.ACTIVATIONS["gelu_pytorch_tanh"]
                assert float((model(ids, mask) - want).abs().max()) > BITES


def test_gemma_single_kv_head(ckpt):
    """gemma-2b's layout at small widths: every query head reads the one KV
    head; the port equals the reference on every row."""
    c = checkpoint.load_checkpoint(ckpt["gemma-mqa"])
    attn = checkpoint.build_model(c).layers[0].self_attn
    assert attn.kv_heads == 1 and tuple(attn.k_proj.weight.shape) == (16, 64)
    got, want, _mask = _forward(ckpt["gemma-mqa"], _texts(6, seed=15) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_the_embedding_is_scaled_by_float32_sqrt_hidden(ckpt):
    """GemmaModel multiplies the embedding by sqrt(hidden_size) rounded to
    float32 (its `normalizer`); without it the port moves past BITES."""
    c = checkpoint.load_checkpoint(ckpt["gemma"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=16) + TEXTS, 512)
    scale = decoder.embed_scale(64, torch.device("cpu"))
    assert scale.dtype == torch.float32 and float(scale) == float(np.float32(8.0))
    with torch.no_grad():
        want = _reference(ckpt["gemma"])(input_ids=ids, attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        model.config["model_type"] = "llama"
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_a_left_pad_position_attends_to_nothing_but_is_not_zero(ckpt):
    """Hazard 3.18 under left padding: a pad query of Gemma 2 sees no key,
    so its attention output is exactly 0, as sdpa gives it; the residual
    and the MLP still run on it, so its last hidden state (what forceCls
    pools for a short text) is not 0, and equals the reference's."""
    c = checkpoint.load_checkpoint(ckpt["gemma2"])
    model = checkpoint.build_model(c)
    texts = ["rust", " ".join(WORDS)]
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    n_pad = int((mask[0] == 0).sum())
    assert n_pad > 4
    seen = []
    hook = model.layers[1].self_attn.o_proj.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    try:
        with torch.no_grad():
            got = model(ids, mask)
    finally:
        hook.remove()
    assert bool((seen[0][0, :n_pad] == 0).all())
    assert float(got[0, :n_pad].abs().min()) > 0
    with torch.no_grad():
        want = _reference(ckpt["gemma2"])(input_ids=ids, attention_mask=mask).last_hidden_state
    assert float((got[0, :n_pad] - want[0, :n_pad]).abs().max()) <= ATOL


def test_causal_lm_checkpoints_run_as_their_model(ckpt):
    """Gemma2ForCausalLM's and GemmaForCausalLM's files: the port's forward
    equals the class's own `model` on every row; their base-model prefix
    is `model`, so the JAX package's AutoModel loads the same weights and
    its vectors equal the port's."""
    for name in ("gemma2-lm", "gemma-lm"):
        path = ckpt[name]
        c = checkpoint.load_checkpoint(path)
        texts = _texts(6, seed=12) + TEXTS
        ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
        lm = getattr(transformers, CLASSES[CONFIGS[name][0], True]).from_pretrained(path).eval()
        with torch.no_grad():
            want = lm.model(input_ids=ids, attention_mask=mask).last_hidden_state
            got = checkpoint.build_model(c)(ids, mask)
        assert float((got - want).abs().max()) <= ATOL
        jax_vectors = FlaxTextEncoder(path, "useModel").encode(texts)
        port = hf_encoder.TextEncoder(path, "useModel", device=None).encode(texts)
        assert float(np.abs(port - jax_vectors).max()) <= ATOL


# -- the encoder -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["gemma2", "gemma2-right", "gemma2-derived", "gemma2-144",
                                  "gemma", "gemma-right", "gemma-mqa"])
def test_encoder_matches_jax(ckpt, name, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of
    different lengths in one batch; under left padding `forceCls` takes a
    pad token's state for the short texts, in both, and chunks of 3 are
    cut from the call's one padded batch (hazard 3.25)."""
    path = ckpt[name]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    kind = CONFIGS[name.removesuffix("-right")][0]
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == CLASSES[kind, False]
    assert jax_enc._torch.config._attn_implementation == "sdpa"
    assert jax_enc._tokenizer.padding_side == ("right" if name.endswith("right") else "left")
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_fault_317_the_jax_flax_branch_raises_on_gemma_safetensors(ckpt):
    """From a model.safetensors, `FlaxAutoModel` loads Flax Gemma and
    `module.apply(params, input_ids, attention_mask)` passes no position
    ids, so the rotary table is not sliced: `encode` raises, past
    `_load`'s fallback, as for Llama. The port reads the same file, and
    embeds as the JAX package's torch branch does from pytorch_model.bin."""
    texts = _texts(4, seed=5, lo=2)
    jax_enc = FlaxTextEncoder(ckpt["gemma-st"], "useModel")
    with pytest.raises(TypeError, match="broadcast"):
        jax_enc.encode(texts)
    assert jax_enc._flax is not None
    want = FlaxTextEncoder(ckpt["gemma"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt["gemma-st"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("name", ["gemma2", "gemma"])
def test_chunk_texts_counts_the_gated_mlp(ckpt, name, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with the gated MLP's 2 x intermediate_size counted (the
    arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt[name], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * max(c["hidden_size"], heads * c["head_dim"])
                                             + 4 * c["intermediate_size"]))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


@pytest.mark.parametrize("name", ["gemma2", "gemma"])
def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, name, spec, tmp_path):
    """write_checkpoint's model.safetensors (the port's names) loads into
    transformers with nothing missing and computes the port's forward;
    AutoTokenizer reads its GemmaTokenizer files as the port does."""
    c = checkpoint.load_checkpoint(ckpt[name])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=spec)
    assert os.path.exists(os.path.join(path, "model.safetensors"))
    cls = getattr(transformers, CLASSES[CONFIGS[name][0], False])
    ref, info = cls.from_pretrained(path, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    c = checkpoint.load_checkpoint(path)
    assert c.tokenizer["tokenizer_class"] == "GemmaTokenizer"
    texts = _texts(5, seed=6) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    want = transformers.AutoTokenizer.from_pretrained(path)(
        texts, padding=True, truncation=True, max_length=512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


def test_the_gated_mlp_is_tanh_gelu_by_default_in_gemma2():
    """Gemma 2's MLP reads hidden_activation (tanh GELU by default), not
    hidden_act."""
    with torch.device("meta"):
        model = checkpoint.new_model({"model_type": "gemma2", "vocab_size": 10,
                                      "num_hidden_layers": 1, **SMALL, "hidden_act": "silu"})
    act = model.layers[0].mlp.act
    x = torch.linspace(-3, 3, 7)
    assert torch.equal(act(x), F.gelu(x, approximate="tanh"))
