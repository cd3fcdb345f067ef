"""BLOOM in the text encoder (K8): the port's `bloom` model type
(models/bloom.py: the embedding LayerNorm, ALiBi counted from each
text's first real token, the fused QKV laid out per head, BLOOM's own
GELU, residuals before or after the layer norms), BloomTokenizerFast's
files (models/bpe.py, BLOOM's Split pattern), the weight names, and the
encoder against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny BLOOMs are built from transformers'
`BloomConfig` (2 layers; hidden 48 over 6 heads, a head count that is not
a power of two, so the ALiBi slopes take their extra branch; and hidden
64 over 4 heads under `apply_residual_connection_post_layernorm`), their
weights drawn with numpy from a seed (the fused QKV at 0.15, so attention
is peaked and a wrong split shows), and saved as pytorch_model.bin beside
a seeded byte-level BPE in BLOOM's layout (`fixtures.bloom_tokenizer_json`,
BloomTokenizerFast's tokenizer_config.json, padding left as published,
or right). Flax BLOOM does not read a lone pytorch_model.bin, so the JAX
package's encoder runs transformers' torch `BloomModel` (`eager`, its
only attention). The port is held against it on every row of the last
hidden state and on normalized vectors within ATOL (1e-5), under both
poolings and both padding sides."""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    activations,
    bloom,
    bpe,
    checkpoint,
    fixtures,
    hf_encoder,
)

ATOL = 1e-5
BITES = 1e-3  # a trap undone must move the last hidden state this far (100 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "café", "naïve", "it's",
         "HELLO", "2024", "中文", "x.y", "(a|b)", "yes!", "你好。", "हिन्दी।"]
TEXTS = ["hello world", "", "😀 中文 é", "<s> inside </s> <pad> <unk>", " ".join(WORDS * 3),
         "Hello, world! (a|b) x.y 你好。ok", "x  y\tz\nnew line"]
# name -> (config arguments, saved from BloomForCausalLM)
CONFIGS = {
    "bloom6": (dict(hidden_size=48, n_head=6), False),
    "bloom4-post": (dict(hidden_size=64, n_head=4, apply_residual_connection_post_layernorm=True),
                    False),
    "bloom6-lm": (dict(hidden_size=48, n_head=6), True),
}
# izhx/udever-bloom-560m's config.json (bigscience/bloom-560m's widths)
UDEVER_BLOOM_560M = {"model_type": "bloom", "vocab_size": 250880, "hidden_size": 1024,
                     "n_layer": 24, "n_head": 16, "layer_norm_epsilon": 1e-5,
                     "apply_residual_connection_post_layernorm": False, "pretraining_tp": 1,
                     "slow_but_exact": False}


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


SPEC = fixtures.bloom_tokenizer_json(_texts(200, seed=1) + TEXTS, 900, seed=5)
VOCAB_SIZE = len(SPEC["model"]["vocab"])


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            sd = 0.15 if name.endswith("query_key_value.weight") else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if ("layernorm" in name or "ln_f" in name) and name.endswith("weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, side="left", **changes):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(SPEC, f, ensure_ascii=False)
    config = {**fixtures.bloom_tokenizer_config(SPEC, padding_side=side), **changes}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`{name}-{side}` for each of CONFIGS (the `-lm` one left only)."""
    root = tmp_path_factory.mktemp("bloom")
    out = {}
    for i, (name, (kwargs, causal_lm)) in enumerate(CONFIGS.items()):
        config = transformers.BloomConfig(vocab_size=VOCAB_SIZE, n_layer=2, **kwargs)
        cls = transformers.BloomForCausalLM if causal_lm else transformers.BloomModel
        model = cls(config)
        _draw_weights(model, 60 + i)
        for side in ("left",) if causal_lm else ("left", "right"):
            path = out[f"{name}-{side}"] = str(root / f"{name}-{side}")
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, side)
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "BloomModel" and ref.config._attn_implementation == "eager"
    return ref


def _forward(path, texts):
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    return got, want, mask


# -- config, module, weights and ALiBi --------------------------------------------


@pytest.mark.parametrize("name", ["bloom6", "bloom4-post"])
def test_the_config_reads_as_transformers(ckpt, name):
    c = checkpoint.load_checkpoint(ckpt[f"{name}-left"])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[f"{name}-left"])
    assert isinstance(model, bloom.BloomModel)
    assert (model.config["hidden_size"], model.config["num_attention_heads"],
            model.config["num_hidden_layers"]) == (want.hidden_size, want.n_head, want.n_layer)
    assert model.config["apply_residual_connection_post_layernorm"] == \
        want.apply_residual_connection_post_layernorm
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and tok.padding_side == "left" and tok.pad == 3
    assert (tok.before, tok.after) == ([], [])


def test_the_published_udever_bloom_560m_widths():
    """udever-bloom-560m (bloom-560m): 24 layers of 1,024, 16 heads of 64,
    12 x 1024^2 Linear weights a layer, a 250,880-row embedding; the
    module's names and shapes are BloomModel's."""
    small = {**UDEVER_BLOOM_560M, "n_layer": 1}
    with torch.device("meta"):
        ours = bloom.BloomModel(small).state_dict()
        theirs = transformers.BloomModel(transformers.BloomConfig(
            **{k: v for k, v in small.items() if k != "model_type"})).state_dict()
    assert set(ours) == set(theirs) and all(ours[k].shape == theirs[k].shape for k in ours)
    assert tuple(ours["h.0.self_attention.query_key_value.weight"].shape) == (3072, 1024)
    linear = sum(v.numel() for k, v in ours.items()
                 if k.endswith("weight") and v.dim() == 2 and k.startswith("h."))
    assert linear == 12 * 1024 * 1024
    assert ours["word_embeddings.weight"].shape == (250880, 1024)


def test_aliases_resolve_as_bloomconfig():
    """`n_embed` over `hidden_size`, and the attribute map's
    `num_attention_heads` and `num_hidden_layers` over `n_head` and
    `n_layer`, as BloomConfig reads them."""
    kwargs = dict(hidden_size=32, n_embed=64, n_head=2, num_attention_heads=8, n_layer=2,
                  num_hidden_layers=3)
    want = transformers.BloomConfig(**kwargs)
    got = bloom.check_config({"model_type": "bloom", **kwargs})
    assert (got["hidden_size"], got["num_attention_heads"], got["num_hidden_layers"]) == (
        want.hidden_size, want.n_head, want.n_layer) == (64, 8, 3)


def test_the_alibi_is_build_alibi_tensor_bit_for_bit():
    """Every head count from 1 to 40 (the extra slopes past a power of two)
    on left- and right-padded masks: the same float32 bits as transformers'
    `build_alibi_tensor`, each key's index counted from its text's first
    real token."""
    from transformers.models.bloom.modeling_bloom import build_alibi_tensor

    mask = torch.tensor([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0]])
    for heads in range(1, 41):
        want = build_alibi_tensor(mask, heads, torch.float32)
        got = bloom.alibi(mask, heads)
        assert got.dtype == torch.float32 and torch.equal(got, want), heads
    slopes = bloom.alibi_slopes(6, torch.device("cpu"))
    n = 4  # the largest power of two under 6 heads, then two odd powers of the next base
    assert torch.equal(slopes[:4], torch.tensor([2 ** (-8 / n * k) for k in (1, 2, 3, 4)]))
    assert torch.equal(slopes[4:], torch.tensor([2 ** (-8 / 8 * k) for k in (1, 3)]))


def test_bloom_gelu_is_transformers_bit_for_bit():
    """BLOOM's GELU and its 0.79788456, not gelu_new's sqrt(2 / pi)."""
    from transformers.models.bloom.modeling_bloom import bloom_gelu_forward

    x = torch.linspace(-8, 8, 100_001)
    assert torch.equal(activations.bloom_gelu(x), bloom_gelu_forward(x))
    assert not torch.equal(activations.bloom_gelu(x), activations.gelu_new(x))
    assert math.sqrt(2 / math.pi) != 0.79788456


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    raw = torch.load(os.path.join(ckpt["bloom6-lm-left"], "pytorch_model.bin"),
                     weights_only=True)
    assert all(k.startswith(("transformer.", "lm_head.")) for k in raw)
    c = checkpoint.load_checkpoint(ckpt["bloom6-lm-left"])
    with torch.device("meta"):
        names = set(bloom.BloomModel(c.config).state_dict())
    assert set(c.state_dict) == names
    got, want, _mask = _forward(ckpt["bloom6-lm-left"], _texts(4, seed=3) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, tmp_path):
    c = checkpoint.load_checkpoint(ckpt["bloom6-right"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=SPEC)
    ref, info = transformers.AutoModel.from_pretrained(path, output_loading_info=True)
    assert type(ref).__name__ == "BloomModel"
    assert not info["missing_keys"] and not info["unexpected_keys"]
    tok = transformers.AutoTokenizer.from_pretrained(path)
    assert type(tok).__name__ == "BloomTokenizerFast" and tok.padding_side == "left"


# -- the forward and its traps ----------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", ["bloom6", "bloom4-post"])
def test_forward_matches_transformers_on_every_row(ckpt, name, side):
    """Every row of the last hidden state, padded ones included, equals
    AutoModel's `eager` within ATOL: six heads (the extra slopes), and
    four under post-layernorm residuals."""
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(ckpt[f"{name}-{side}"], texts)
    assert int((mask == 0).sum()) > 0
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_the_fused_qkv_is_split_per_head(ckpt):
    """Mutation guard: query_key_value's rows are (heads, 3, head_dim). The
    port equals the reference; the same weights read as (3, heads,
    head_dim) move the last hidden state past BITES."""
    texts = _texts(6, seed=10, lo=5) + TEXTS
    got, want, _mask = _forward(ckpt["bloom6-right"], texts)
    assert float((got - want).abs().max()) <= ATOL
    c = checkpoint.load_checkpoint(ckpt["bloom6-right"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    heads, d = 6, 8
    for block in model.h:
        qkv = block.self_attention.query_key_value
        order = torch.arange(3 * heads * d).view(3, heads, d).transpose(0, 1).reshape(-1)
        qkv.weight = torch.nn.Parameter(qkv.weight[order])
        qkv.bias = torch.nn.Parameter(qkv.bias[order])
    with torch.no_grad():
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_the_post_layernorm_residual_is_read(ckpt):
    """Mutation guard: flipping apply_residual_connection_post_layernorm
    moves the last hidden state past BITES."""
    texts = _texts(6, seed=12, lo=5) + TEXTS
    got, want, _mask = _forward(ckpt["bloom4-post-right"], texts)
    c = checkpoint.load_checkpoint(ckpt["bloom4-post-right"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    for block in model.h:
        block.post_norm_residual = False
    with torch.no_grad():
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_alibi_counts_from_the_first_real_token(ckpt):
    """A text's real rows do not depend on how far its batch pads it, on
    either side: the biases count from its first real token."""
    text = "hello world search engine"
    for side in ("left", "right"):
        c = checkpoint.load_checkpoint(ckpt[f"bloom6-{side}"])
        tok, model = checkpoint.build_tokenizer(c), checkpoint.build_model(c)
        rows = []
        for batch in ([text], [text, " ".join(WORDS * 2)]):
            ids, mask = tok(batch, 512)
            with torch.no_grad():
                rows.append(model(ids, mask)[0][mask[0].bool()])
        assert float((rows[0] - rows[1]).abs().max()) <= ATOL, side


# -- the encoder ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_encoder_matches_jax(ckpt, side, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized; under
    forceCls with left padding the pad's state (an average over its whole
    row) is pooled, and chunks of 3 are cut from the call's one batch."""
    path = ckpt[f"bloom6-{side}"]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "BloomModel"
    assert type(jax_enc._tokenizer).__name__ == "BloomTokenizerFast"
    assert jax_enc._tokenizer.padding_side == side
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_mask(ckpt, monkeypatch):
    """The additive (L, L) mask counted on top of the common per-text
    count (the ALiBi biases join the scores inside baddbmm)."""
    enc = hf_encoder.TextEncoder(ckpt["bloom6-right"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
    per_text += 4 * L * L
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- the tokenizer and what is refused --------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
def test_tokenizer_matches_autotokenizer(ckpt, side):
    """BloomTokenizerFast's ids and masks as padded batches cut at 512 and
    at 6 tokens, padded on the side tokenizer_config.json names."""
    path = ckpt[f"bloom6-{side}"]
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == "BloomTokenizerFast" and ref.padding_side == side
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(path))
    texts = _texts(20, seed=7) + TEXTS
    for max_len in (512, 6):
        ids, mask = tok(texts, max_len)
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]


def test_token_types_are_refused_as_bloommodel_raises(ckpt, tmp_path):
    """A tokenizer_config.json whose model_input_names give token types: the
    JAX package passes them and BloomModel raises; the port refuses them by
    name."""
    path = str(tmp_path / "types")
    shutil.copytree(ckpt["bloom6-right"], path)
    _tokenizer_files(path, "right", model_input_names=["input_ids", "token_type_ids",
                                                       "attention_mask"])
    with pytest.raises(ValueError, match="unexpected arguments"):
        FlaxTextEncoder(path, "useModel").encode(["hello world"])
    with pytest.raises(ValueError, match="token_type_ids are not supported by bloom"):
        hf_encoder.TextEncoder(path, "useModel", device=None).encode(["hello world"])


def test_a_directory_without_tokenizer_json_is_refused(ckpt, tmp_path):
    """BloomTokenizerFast reads tokenizer.json only (it has no slow class to
    convert vocab.json + merges.txt from): AutoTokenizer fails, and the
    port refuses by name."""
    path = str(tmp_path / "legacy")
    shutil.copytree(ckpt["bloom6-right"], path)
    os.remove(os.path.join(path, "tokenizer.json"))
    model = SPEC["model"]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(model["vocab"], f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in model["merges"]))
    with pytest.raises(Exception):
        transformers.AutoTokenizer.from_pretrained(path)
    with pytest.raises(ValueError, match="BloomTokenizerFast, which reads a tokenizer.json only"):
        checkpoint.load_checkpoint(path)


@pytest.mark.parametrize("change, match", [
    ({"pretraining_tp": 2, "slow_but_exact": True}, "slow_but_exact"),
    ({"n_head": 5}, "not a multiple of n_head"),
])
def test_unread_configs_are_refused(change, match):
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config({"model_type": "bloom", "vocab_size": 100, "hidden_size": 48,
                                 "n_head": 6, **change})


def test_add_prefix_space_is_refused(ckpt, tmp_path):
    """BloomTokenizerFast's add_prefix_space rewrites the flag of the
    ByteLevel after its Split (the port's choice: no published file sets
    it)."""
    with pytest.raises(ValueError, match="add_prefix_space true"):
        bpe.BPE(SPEC, {**fixtures.bloom_tokenizer_config(SPEC), "add_prefix_space": True},
                "bloom")
