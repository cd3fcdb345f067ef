"""Gemma 3's text stack in the text encoder (K8): the port's `gemma3_text`
model type (models/gemma3.py: the scaled embedding, four `(1 + w)`
RMSNorms a layer, Q/K norms, two rotary bases, GQA, the tanh-GELU-gated
MLP, sliding and full layers, bidirectional as EmbeddingGemma or causal),
its weight names, and the encoder against transformers and the JAX
package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny stacks (hidden 64, 4 heads of 16 over 2 KV
heads, intermediate 96, `query_pre_attn_scalar` 16) are built from
transformers' `Gemma3TextConfig`, their weights drawn with numpy from a
seed: every RMSNorm weight at 0 +- 0.3 (they start at 0, so a norm that
multiplies by w alone fails), Q/K norms at 1 +- 0.3 so attention is
peaked and an off-by-one window shows; windows of 5 and 6 tokens bite on
texts of 20 and more. They are saved by transformers as
pytorch_model.bin beside models/fixtures.py's seeded tokenizer in Gemma's
layout (GemmaTokenizerFast: left padding, `<bos> $A`). transformers has
no Flax Gemma 3, so the JAX package's encoder runs transformers' torch
model (its AutoModel branch, `sdpa`). The port is held against it within
1e-5 on normalized vectors, for both poolings and both padding sides, and
against `AutoModel` on every row of the last hidden state, padded ones
included: within 1e-5 of `sdpa` at 2 layers, and on the real rows of
`eager` (the same products, so the same bits) at 2 and 6.

A checkpoint saved from `Gemma3ForCausalLM` (`model.` names) loads in the
port; the JAX package's `AutoModel` leaves its weights at their random
initialization (fault 3.19: the class's base-model prefix is
`language_model`), so the port is held there against
`Gemma3ForCausalLM`'s own `model`."""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    bpe,
    checkpoint,
    decoder,
    fixtures,
    gemma3,
    hf_encoder,
    modernbert,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文"]
TEXTS = ["hello world", "", "😀 中文 é", "<start_of_turn>user hi<end_of_turn>",
         " ".join(WORDS * 3), "x<table>y  z", "tab\there\nnew line"]
# google/embeddinggemma-300m's published config.json
PUBLISHED_EMBEDDINGGEMMA = {
    "model_type": "gemma3_text", "vocab_size": 262_144, "hidden_size": 768,
    "intermediate_size": 1152, "num_hidden_layers": 24, "num_attention_heads": 3,
    "num_key_value_heads": 1, "head_dim": 256, "query_pre_attn_scalar": 256,
    "sliding_window": 512, "rope_theta": 1_000_000.0, "rope_local_base_freq": 10_000.0,
    "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh",
    "use_bidirectional_attention": True, "max_position_embeddings": 2048,
    "pad_token_id": 0, "eos_token_id": 1, "bos_token_id": 2,
    "layer_types": (["sliding_attention"] * 5 + ["full_attention"]) * 4,
}
SMALL = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, query_pre_attn_scalar=16, max_position_embeddings=2048)
SLIDE_FULL = ["sliding_attention", "full_attention"]
# name -> (Gemma3TextConfig arguments, saved from Gemma3ForCausalLM)
CONFIGS = {
    # bidirectional: the config builds 16 // 2 + 1 = 9 and saves it; read
    # back, 9 // 2 + 1 = 5
    "bidirectional": (dict(num_hidden_layers=2, layer_types=SLIDE_FULL, sliding_window=16,
                           use_bidirectional_attention=True), False),
    "causal": (dict(num_hidden_layers=2, layer_types=SLIDE_FULL, sliding_window=6), False),
    "bias": (dict(num_hidden_layers=2, layer_types=SLIDE_FULL, sliding_window=16,
                  use_bidirectional_attention=True, attention_bias=True), False),
    # layer_types left out of config.json: derived, five sliding then one full
    "derived": (dict(num_hidden_layers=6, sliding_window=16, use_bidirectional_attention=True),
                False),
    # saved from Gemma3ForCausalLM: `model.` names, the tied lm_head
    "causal-lm": (dict(num_hidden_layers=2, layer_types=SLIDE_FULL, sliding_window=16,
                       use_bidirectional_attention=True), True),
}
SHALLOW = ("bidirectional", "causal", "bias")


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
            sd = 0.3 if "norm" in name else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if "q_norm" in name or "k_norm" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, spec, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.gemma_tokenizer_config(spec, padding_side=side), f)


@pytest.fixture(scope="module")
def spec():
    return fixtures.gemma_tokenizer_json(_texts(200, seed=1) + TEXTS, 1200, seed=15)


@pytest.fixture(scope="module")
def ckpt(spec, tmp_path_factory):
    """`{name}` for each of CONFIGS, left-padded (GemmaTokenizerFast's
    default) as pytorch_model.bin; `{name}-right` with padding_side right
    for the shallow ones; `st`: the bidirectional one as model.safetensors;
    `port`: it as the port writes it."""
    root = tmp_path_factory.mktemp("gemma3")
    out = {}
    for i, (name, (kwargs, causal_lm)) in enumerate(CONFIGS.items()):
        config = transformers.Gemma3TextConfig(vocab_size=len(spec["model"]["vocab"]),
                                               **SMALL, **kwargs)
        cls = transformers.Gemma3ForCausalLM if causal_lm else transformers.Gemma3TextModel
        model = cls(config)
        _draw_weights(model, 70 + i)
        sides = ("left", "right") if name in SHALLOW else ("left",)
        for side in sides:
            key = name if side == "left" else f"{name}-right"
            path = out[key] = str(root / key)
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, spec, None if side == "left" else "right")
            if name == "derived":
                with open(os.path.join(path, "config.json")) as f:
                    saved = json.load(f)
                del saved["layer_types"]
                with open(os.path.join(path, "config.json"), "w") as f:
                    json.dump(saved, f)
        if name == "bidirectional":
            path = out["st"] = str(root / "st")
            model.save_pretrained(path)
            _tokenizer_files(path, spec)
    c = checkpoint.load_checkpoint(out["bidirectional"])
    out["port"] = str(root / "port")
    checkpoint.write_checkpoint(out["port"], c.config, c.state_dict, tokenizer_json=spec)
    return out


def _reference(path, impl="sdpa"):
    ref = transformers.AutoModel.from_pretrained(path, attn_implementation=impl).eval()
    assert ref.config._attn_implementation == impl
    return ref


# -- config, layers and weights --------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_the_config_reads_as_gemma3(ckpt, name):
    """The window and layer types as transformers' config object holds
    them: a bidirectional file's sliding_window w read as w // 2 + 1."""
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[name])
    assert isinstance(model, gemma3.Gemma3Model)
    assert model.config["window"] == want.sliding_window
    assert model.config["layer_types"] == want.layer_types
    assert [layer.sliding for layer in model.layers] == [
        t == "sliding_attention" for t in want.layer_types]
    if name == "derived":
        assert "layer_types" not in c.config
        assert want.layer_types == ["sliding_attention"] * 5 + ["full_attention"]
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and tok.byte_fallback and tok.padding_side == "left"


def test_the_published_embeddinggemma_widths():
    """google/embeddinggemma-300m: 3 heads of 256 over 1 KV head on a
    768-wide model, a 257-token reach (512 // 2 + 1), 101.45 M Linear
    weights a token, 303 M parameters, 201 M of them the embedding."""
    config = gemma3.check_config(PUBLISHED_EMBEDDINGGEMMA)
    assert config["window"] == 257
    assert config["window"] == transformers.Gemma3TextConfig(**{
        k: v for k, v in PUBLISHED_EMBEDDINGGEMMA.items() if k != "model_type"}).sliding_window
    with torch.device("meta"):
        model = gemma3.Gemma3Model(config)
    attn = model.layers[0].self_attn
    assert tuple(attn.q_proj.weight.shape) == (768, 768)
    assert tuple(attn.k_proj.weight.shape) == (256, 768)
    linear = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert linear == 101_449_728
    assert model.embed_tokens.weight.numel() == 201_326_592
    total = sum(p.numel() for p in model.parameters())
    assert abs(total - 303e6) < 1e6


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_rotary_tables_are_transformers_bits(theta):
    """modernbert.rotary at head_dim 256 is Gemma3RotaryEmbedding's cos and
    sin, bit for bit, at rope_theta and at rope_local_base_freq."""
    from transformers.models.gemma3.modeling_gemma3 import Gemma3RotaryEmbedding

    ref = Gemma3RotaryEmbedding(transformers.Gemma3TextConfig(
        **{**SMALL, "head_dim": 256, "rope_theta": theta}))
    for L in (1, 7, 257, 512):
        want_cos, want_sin = ref(torch.zeros(1, L, 64), torch.arange(L)[None])
        cos, sin = modernbert.rotary(L, 256, theta, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L


def test_the_scales_are_float32_device_tensors():
    """sqrt(hidden_size) rounded to float32 as Gemma3TextScaledWordEmbedding
    stores it, and query_pre_attn_scalar ** -0.5, both float32 tensors on
    the forward's device (fault 3.4)."""
    from transformers.models.gemma3.modeling_gemma3 import Gemma3TextScaledWordEmbedding

    ref = Gemma3TextScaledWordEmbedding(10, 768, 0, embed_scale=768 ** 0.5)
    scale = gemma3.embed_scale(768, torch.device("cpu"))
    assert scale.dtype == torch.float32 and torch.equal(scale, ref.embed_scale)
    attn = decoder.attention_scale(256, torch.device("cpu"))
    assert attn.dtype == torch.float32 and float(attn) == float(np.float32(256 ** -0.5))


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """Gemma3ForCausalLM's names (`model.` prefix, the tied `lm_head.`) map
    onto Gemma3Model's; the safetensors and bin routes give identical
    tensors."""
    c = checkpoint.load_checkpoint(ckpt["causal-lm"])
    lm = transformers.Gemma3ForCausalLM.from_pretrained(ckpt["causal-lm"]).state_dict()
    assert all(k.startswith(("model.", "lm_head.")) for k in lm) and "lm_head.weight" in lm
    got = checkpoint.hf_to_state_dict(lm)
    with torch.device("meta"):
        names = set(gemma3.Gemma3Model(c.config).state_dict())
    assert set(got) == set(c.state_dict) == names
    assert all(torch.equal(got[k], c.state_dict[k]) for k in got)
    st, pt = checkpoint.read_weights(ckpt["st"]), checkpoint.read_weights(ckpt["bidirectional"])
    assert set(st) == set(pt) and all(torch.equal(st[k], pt[k]) for k in st)


REFUSED = [
    ({"model_type": "gemma3"}, "gemma3"),
    ({"partial_rotary_factor": 0.5}, "partial_rotary_factor"),
    ({"layer_types": ["chunked_attention"] * 3}, "layer_types"),
    ({"num_key_value_heads": 3}, "num_key_value_heads"),
]


@pytest.mark.parametrize("change, match", REFUSED)
def test_unread_gemma3_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["causal"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


def test_defaults_fill_what_a_config_leaves_out():
    """A config with only the widths resolves as Gemma3TextConfig does."""
    widths = {"vocab_size": 100, "hidden_size": 64, "intermediate_size": 96,
              "num_hidden_layers": 7, "num_attention_heads": 8}
    got = gemma3.check_config({"model_type": "gemma3_text", **widths})
    want = transformers.Gemma3TextConfig(**widths)
    for key in ("num_key_value_heads", "head_dim", "hidden_activation", "rms_norm_eps",
                "rope_theta", "attention_bias", "query_pre_attn_scalar", "layer_types",
                "attn_logit_softcapping", "rope_local_base_freq",
                "use_bidirectional_attention", "max_position_embeddings"):
        assert got[key] == getattr(want, key), key
    assert got["window"] == want.sliding_window == 4096


# -- the masks, the forward and the encoder ---------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_keys_follow_transformers_masks(causal):
    """decoder.blocked_keys against transformers' own mask functions
    (masking_utils: the causal and sliding-window overlays, Gemma-3's
    bidirectional window ORed in, the padding mask ANDed last) on a
    left-padded batch."""
    from transformers.masking_utils import (
        and_masks,
        causal_mask_function,
        or_masks,
        padding_mask_function,
        sliding_window_causal_mask_function,
    )
    from transformers.models.gemma3.modeling_gemma3 import _bidirectional_window_overlay

    mask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1], [1] * 12])
    window = 4
    for sliding in (False, True):
        fn = sliding_window_causal_mask_function(window) if sliding else causal_mask_function
        if not causal:
            fn = or_masks(fn, _bidirectional_window_overlay(window) if sliding
                          else (lambda *args: torch.tensor(True)))
        fn = and_masks(fn, padding_mask_function(mask.bool()))
        t = torch.tensor
        want = torch.tensor([[[[bool(fn(t(b), t(0), t(q), t(k))) for k in range(12)]
                               for q in range(12)]] for b in range(2)])
        got = decoder.blocked_keys(mask, causal=causal, window=window if sliding else None)
        assert torch.equal(~got.expand_as(want), want), (causal, sliding)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", SHALLOW)
def test_forward_matches_transformers_on_every_row(ckpt, name, side):
    """Padded batches of texts of 1 to 40 words: every row of the last
    hidden state, padded ones included, equals AutoModel's default (sdpa)
    within ATOL; a pad query that sees no key (causal under left padding,
    or outside every window) attends to nothing."""
    path = ckpt[name if side == "left" else f"{name}-right"]
    c = checkpoint.load_checkpoint(path)
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(6, seed=9) + TEXTS, 512)
    assert int((mask == 0).sum()) > 0 and mask.shape[1] > 20
    assert bool((mask[:, -1 if side == "left" else 0] == 1).all())
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        eager = _reference(path, "eager")(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL
    assert float((got - eager)[mask.bool()].abs().max()) <= ATOL


def test_fault_319_a_causal_lm_checkpoint_runs_as_its_model(ckpt):
    """Gemma3ForCausalLM's files: the port's forward equals that class's
    own `model` (sdpa) on every row; the JAX package's AutoModel loads
    none of its weights (fault 3.19), so its vectors are another model's."""
    path = ckpt["causal-lm"]
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(6, seed=12) + TEXTS, 512)
    lm = transformers.Gemma3ForCausalLM.from_pretrained(path).eval()
    with torch.no_grad():
        want = lm.model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
    jax_enc = FlaxTextEncoder(path, "useModel")
    jax_enc.encode(["hello"])
    loaded = jax_enc._torch.state_dict()["norm.weight"]
    assert not torch.equal(loaded, c.state_dict["norm.weight"])


def test_six_layers_equal_eagers_products(ckpt):
    """The derived five-sliding-one-full stack: the real rows of the last
    hidden state equal transformers' `eager` attention (the same products
    and softmax) within ATOL; sdpa's own rounding drifts further at six
    layers, so the normalized vectors hold it (test_encoder_matches_jax)."""
    c = checkpoint.load_checkpoint(ckpt["derived"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(6, seed=10) + TEXTS, 512)
    with torch.no_grad():
        want = _reference(ckpt["derived"], "eager")(input_ids=ids,
                                                    attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    real = mask.bool()
    assert float((got - want)[real].abs().max()) <= ATOL


def test_the_window_bites(ckpt):
    """Mutation guard: one token more or less of reach moves the last
    hidden state well past ATOL on these texts, in both directions."""
    for name in ("bidirectional", "causal"):
        c = checkpoint.load_checkpoint(ckpt[name])
        model = checkpoint.build_model(c)
        ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=11, lo=20), 512)
        window = model.config["window"]
        with torch.no_grad():
            want = model(ids, mask)
            for moved in (-1, 1):
                model.config["window"] = window + moved
                assert float((model(ids, mask) - want).abs().max()) > 1e-3, (name, moved)


def test_a_left_pad_query_sees_the_text_when_bidirectional(ckpt):
    """Under left padding a pad query of the bidirectional stack's full
    layer sees the real keys (its attention output is not zero, and
    forceCls pools it), where the causal stack's sees none (exactly
    zero)."""
    for name, zero in (("bidirectional", False), ("causal", True)):
        c = checkpoint.load_checkpoint(ckpt[name])
        model = checkpoint.build_model(c)
        ids, mask = checkpoint.build_tokenizer(c)(["rust", " ".join(WORDS)], 512)
        n_pad = int((mask[0] == 0).sum())
        assert n_pad > 4
        seen = []
        hook = model.layers[1].self_attn.o_proj.register_forward_hook(
            lambda mod, args, out: seen.append(args[0]))
        try:
            with torch.no_grad():
                model(ids, mask)
        finally:
            hook.remove()
        assert bool((seen[0][0, :n_pad] == 0).all()) == zero, name


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["bidirectional", "bidirectional-right", "causal", "bias",
                                  "derived"])
def test_encoder_matches_jax(ckpt, name, pooling):
    """The JAX package's torch branch (no Flax Gemma 3), pooled and
    normalized, texts of different lengths in one batch; under left
    padding `forceCls` takes a pad token's state for the short texts, in
    both."""
    path = ckpt[name]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "Gemma3TextModel"
    assert jax_enc._tokenizer.padding_side == ("right" if name.endswith("right") else "left")
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_gated_mlp(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with the gated MLP's 2 x intermediate_size counted (the
    arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["causal"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * max(c["hidden_size"], heads * c["head_dim"])
                                             + 4 * c["intermediate_size"]))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt):
    """write_checkpoint's model.safetensors (Gemma3Model's names) loads into
    transformers with nothing missing and computes the port's forward;
    AutoTokenizer reads its GemmaTokenizer files as the port does."""
    ref, info = transformers.Gemma3TextModel.from_pretrained(ckpt["port"],
                                                             output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert os.path.exists(os.path.join(ckpt["port"], "model.safetensors"))
    c = checkpoint.load_checkpoint(ckpt["port"])
    assert c.tokenizer["tokenizer_class"] == "GemmaTokenizer"
    texts = _texts(5, seed=6) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    want = transformers.AutoTokenizer.from_pretrained(ckpt["port"])(
        texts, padding=True, truncation=True, max_length=512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
