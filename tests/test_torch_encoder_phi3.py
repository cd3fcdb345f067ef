"""Phi-3 in the text encoder (K8): the port's `phi3` model type
(models/decoder.py: the fused `qkv_proj` and `gate_up_proj`, partial
rotary, longrope, a window in every layer), its weight names, and the
encoder against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny stacks (hidden 64, 4 heads of 16 over 2 KV
heads, intermediate 96) are built from transformers' `Phi3Config`, their
weights drawn with numpy from a seed (Q and K rows of `qkv_proj` at 0.15,
so attention is peaked and a window or rotary otherwise shows; norm
weights 1 +- 0.05), saved by transformers as pytorch_model.bin beside
models/fixtures.py's seeded tokenizer in Phi-3's layout (Llama-2's
byte-fallback BPE with Phi-3's chat tokens from id 1,200 and
`<|endoftext|>` as pad; LlamaTokenizerFast pads on the left by class
default). No Flax Phi-3 exists, so the JAX package's encoder runs
transformers' torch model (its AutoModel branch, `sdpa`). The port is
held against it within 1e-5 on normalized vectors, for both poolings and
both padding sides, and against `AutoModel` on every row of the last
hidden state under `sdpa` and on the real rows under `eager`. The
longrope stack switches from its short to its long factors past
`original_max_position_embeddings` 32 (`max_position_embeddings` 128), so
texts of 1 to 40 words reach both."""

import copy
import json
import os
import shutil

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
    hf_encoder,
    rope,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-4  # a trap undone must move the last hidden state this far (10 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文"]
TEXTS = ["hello world", "", "😀 中文 é", "<|user|> hi<|end|>\n<|assistant|>  ok",
         "x<|endoftext|>y  z", "tab\there\nnew line"]
BPE_SIZE = 1200  # the seeded pieces; Phi-3's added tokens follow
SMALL = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             vocab_size=BPE_SIZE + 64, pad_token_id=BPE_SIZE, eos_token_id=BPE_SIZE,
             bos_token_id=1)
ORIGINAL = 32  # original_max_position_embeddings of the longrope stacks


def _longrope(n, kind="longrope"):
    return {"type": kind, "short_factor": [1.0 + i / 8 for i in range(n)],
            "long_factor": [2.0 + i / 3 for i in range(n)]}


LONGROPE = dict(partial_rotary_factor=0.75, sliding_window=5, rope_scaling=_longrope(6),
                max_position_embeddings=128, original_max_position_embeddings=ORIGINAL)
# microsoft/Phi-3-mini-4k-instruct's config.json widths
PHI3_MINI = {"model_type": "phi3", "vocab_size": 32_064, "hidden_size": 3072,
             "intermediate_size": 8192, "num_hidden_layers": 32, "num_attention_heads": 32,
             "num_key_value_heads": 32, "hidden_act": "silu", "rms_norm_eps": 1e-5,
             "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
             "rope_theta": 10_000.0, "rope_scaling": None, "sliding_window": 2047}
# name -> (config arguments, saved from Phi3ForCausalLM)
CONFIGS = {
    "phi3": (dict(num_hidden_layers=2), False),
    "phi3-partial": (dict(num_hidden_layers=2, partial_rotary_factor=0.75, sliding_window=5),
                     False),
    "phi3-lm": (dict(num_hidden_layers=2, **LONGROPE), True),
}
SHALLOW = ("phi3", "phi3-partial")


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


def _config(**kwargs):
    return transformers.Phi3Config(**{**SMALL, **copy.deepcopy(kwargs)})


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    q_and_k = 4 * 16 + 2 * 16  # qkv_proj's Q and K rows
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                draw = rng.normal(1.0, 0.05, tuple(p.shape))
            else:
                draw = rng.normal(0.0, 0.05, tuple(p.shape))
                if "qkv_proj" in name:
                    draw[:q_and_k] = rng.normal(0.0, 0.15, (q_and_k, p.shape[1]))
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, spec, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.phi3_tokenizer_config(spec, padding_side=side), f)


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
    return fixtures.phi3_tokenizer_json(_texts(200, seed=1) + TEXTS[:3], BPE_SIZE, seed=16)


@pytest.fixture(scope="module")
def ckpt(spec, tmp_path_factory):
    """`{name}` for each of CONFIGS, left-padded (LlamaTokenizerFast's
    default) as pytorch_model.bin; `{name}-right` with padding_side right
    for the shallow ones."""
    root = tmp_path_factory.mktemp("phi3")
    out = {}
    for i, (name, (kwargs, causal_lm)) in enumerate(CONFIGS.items()):
        cls = transformers.Phi3ForCausalLM if causal_lm else transformers.Phi3Model
        model = cls(_config(**kwargs))
        _draw_weights(model, 110 + i)
        for side in ("left", "right") if name in SHALLOW else ("left",):
            key = name if side == "left" else f"{name}-right"
            path = out[key] = str(root / key)
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, spec, None if side == "left" else "right")
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
    """DecoderModel with Phi-3's fused projections, every layer sliding iff
    the config has a window, the rotated width int(head_dim *
    partial_rotary_factor), and LlamaTokenizerFast's left padding."""
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[name])
    assert isinstance(model, decoder.DecoderModel)
    assert model.config["window"] == want.sliding_window
    kinds = {"sliding_attention" if want.sliding_window else "full_attention"}
    assert set(model.config["layer_types"]) == kinds
    assert model.config["rotary_dim"] == int(16 * want.partial_rotary_factor)
    assert model.rope.dim == model.config["rotary_dim"]
    assert model.rope.kind == ("longrope" if want.rope_scaling else "default")
    layer = model.layers[0]
    assert isinstance(layer.mlp, decoder.FusedGatedMLP) and layer.self_attn.fused
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and tok.byte_fallback and tok.padding_side == "left"
    assert tok.pad == BPE_SIZE and tok.token_to_id("<|user|>") == BPE_SIZE + 10


def test_the_published_phi3_mini_widths():
    """microsoft/Phi-3-mini-4k-instruct: qkv_proj 9,216 x 3,072, gate_up_proj
    16,384 x 3,072, 113.2 M Linear weights a layer, a 2,047-token window in
    every layer; its 128k sibling's longrope lists are head_dim / 2 = 48
    long, and at partial_rotary_factor 0.75, 36."""
    config = decoder.check_config(PHI3_MINI)
    assert config["window"] == 2047 and set(config["layer_types"]) == {"sliding_attention"}
    with torch.device("meta"):
        model = decoder.DecoderModel({**PHI3_MINI, "num_hidden_layers": 1})
    layer = model.layers[0]
    assert tuple(layer.self_attn.qkv_proj.weight.shape) == (9216, 3072)
    assert tuple(layer.mlp.gate_up_proj.weight.shape) == (16_384, 3072)
    linear = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert linear == 113_246_208
    for factor, n in ((1.0, 48), (0.75, 36)):
        scaled = {**PHI3_MINI, "partial_rotary_factor": factor, "max_position_embeddings": 131_072,
                  "rope_scaling": _longrope(n)}
        transformers.Phi3Config(**{k: v for k, v in copy.deepcopy(scaled).items()
                                   if k != "model_type"})
        assert decoder.check_config(scaled)["rotary_dim"] == 2 * n


def test_defaults_fill_what_a_config_leaves_out():
    """A config with only the widths resolves as Phi3Config does."""
    widths = {"vocab_size": 100, "hidden_size": 64, "intermediate_size": 96,
              "num_hidden_layers": 3, "num_attention_heads": 4}
    got = decoder.check_config({"model_type": "phi3", **widths})
    want = transformers.Phi3Config(**widths, pad_token_id=0)
    for key in ("num_key_value_heads", "hidden_act", "rms_norm_eps", "rope_theta",
                "rope_scaling", "partial_rotary_factor", "sliding_window",
                "max_position_embeddings", "original_max_position_embeddings"):
        assert got[key] == getattr(want, key), key
    assert got["head_dim"] == 16 and got["window"] is None


def test_the_fused_projections_split_as_phi3_splits_them(ckpt):
    """A Phi3ForCausalLM file (`model.` names, `lm_head.`): qkv_proj and
    gate_up_proj load fused under their own names, at the reference's
    product shapes. The port's Q, K and V are the reference's slices (Q's
    heads x head_dim, then K's, then V's), and its gate the first half of
    gate_up_proj: swapping K's and V's rows, or the two halves, moves the
    last hidden state past BITES."""
    path = ckpt["phi3-lm"]
    lm = transformers.Phi3ForCausalLM.from_pretrained(path).state_dict()
    assert "lm_head.weight" in lm and all(k.startswith(("model.", "lm_head.")) for k in lm)
    c = checkpoint.load_checkpoint(path)
    assert set(c.state_dict) == {k.removeprefix("model.") for k in lm if k != "lm_head.weight"}
    assert tuple(c.state_dict["layers.0.self_attn.qkv_proj.weight"].shape) == (128, 64)
    assert tuple(c.state_dict["layers.0.mlp.gate_up_proj.weight"].shape) == (192, 64)
    texts = _texts(6, seed=9) + TEXTS
    got, want, _mask = _forward(path, texts)
    assert float((got - want).abs().max()) <= ATOL
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    layer = model.layers[0]
    for swap in ("kv", "gate_up"):
        if swap == "kv":
            weight = layer.self_attn.qkv_proj.weight
            moved = torch.cat((weight[:64], weight[96:], weight[64:96]))
        else:
            weight = layer.mlp.gate_up_proj.weight
            moved = torch.cat((weight[96:], weight[:96]))
        param = torch.nn.Parameter(moved, requires_grad=False)
        owner = layer.self_attn.qkv_proj if swap == "kv" else layer.mlp.gate_up_proj
        owner.weight = param
        with torch.no_grad():
            assert float((model(ids, mask) - want).abs().max()) > BITES, swap
        owner.weight = weight


# -- the forward and its traps -------------------------------------------------


@pytest.mark.parametrize("name, side", [(name, side) for name in SHALLOW
                                         for side in ("left", "right")] + [("phi3-lm", "left")])
def test_forward_matches_transformers_on_every_row(ckpt, name, side):
    """Padded batches of texts of 1 to 40 words: every row of the last
    hidden state, padded ones included, equals AutoModel's default (sdpa)
    within ATOL, and the real rows equal `eager`."""
    path = ckpt[name if side == "left" else f"{name}-right"]
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(path, texts)
    assert int((mask == 0).sum()) > 0 and mask.shape[1] > ORIGINAL
    assert bool((mask[:, -1 if side == "left" else 0] == 1).all())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL
    _got, eager, _mask = _forward(path, texts, "eager")
    assert float((got - eager)[mask.bool()].abs().max()) <= ATOL


def test_partial_rotary_rotates_the_first_channels(ckpt):
    """partial_rotary_factor 0.75 on 16-wide heads: the tables are 12 wide,
    the first 12 channels of Q and K rotate and the last 4 pass through;
    rotating the whole head instead moves past BITES."""
    c = checkpoint.load_checkpoint(ckpt["phi3-partial"])
    model = checkpoint.build_model(c)
    cos, sin = model.rope.tables(7, torch.device("cpu"))
    assert cos.shape[-1] == 12
    x = torch.randn(1, 4, 7, 16, generator=torch.Generator().manual_seed(0))
    out = decoder.rotate(x, cos, sin)
    assert torch.equal(out[..., 12:], x[..., 12:])
    assert not torch.equal(out[..., :12], x[..., :12])
    texts = _texts(6, seed=10) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(ckpt["phi3-partial"])(input_ids=ids,
                                                attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        model.rope = rope.Rope("default", model.rope.theta, 16)
        assert float((model(ids, mask) - want).abs().max()) > BITES


@pytest.mark.parametrize("factor", [0.7, 0.0])
def test_an_odd_or_empty_rotated_width_runs_as_the_reference_runs_it(spec, tmp_path, factor):
    """partial_rotary_factor 0.7 on 16-wide heads: int(11.2) = 11, whose 6
    frequencies the reference's tables repeat over 12 channels, and it
    rotates those 12; at 0 nothing rotates. The port runs the same."""
    model = transformers.Phi3Model(_config(num_hidden_layers=2, partial_rotary_factor=factor))
    _draw_weights(model, 120)
    path = str(tmp_path / "odd")
    model.save_pretrained(path, safe_serialization=False)
    _tokenizer_files(path, spec)
    got, want, _mask = _forward(path, _texts(6, seed=11) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_longrope_picks_its_factors_batch_by_batch(ckpt):
    """A batch longer than original_max_position_embeddings (32) runs the
    long factors, a shorter one the short factors, with no state kept: one
    encoder (the port's, and the JAX package's) over a long batch, a short
    one and the long one again equals a fresh reference model on each.
    Running the short factors on the long batch moves past BITES."""
    path = ckpt["phi3-lm"]
    long_texts = _texts(6, seed=12, lo=30) + TEXTS
    short_texts = ["hello world", "rust", "machine learning database", "中文 café"]
    c = checkpoint.load_checkpoint(path)
    model = checkpoint.build_model(c)
    tok = checkpoint.build_tokenizer(c)
    jax_enc = FlaxTextEncoder(path, "useModel")
    port_enc = hf_encoder.TextEncoder(path, "useModel", device=None)
    for texts, longer in ((long_texts, True), (short_texts, False), (long_texts, True)):
        ids, mask = tok(texts, 512)
        assert (ids.shape[1] > ORIGINAL) == longer
        assert model.rope.inv_freq(ids.shape[1])[0].equal(
            1.0 / (torch.tensor(_longrope(6)["long_factor" if longer else "short_factor"])
                   * 10_000.0 ** (torch.arange(0, 12, 2).float() / 12)))
        with torch.no_grad():
            want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
            got = model(ids, mask)
        assert float((got - want).abs().max()) <= ATOL
        fresh = FlaxTextEncoder(path, "useModel").encode(texts)
        np.testing.assert_array_equal(jax_enc.encode(texts), fresh)
        assert float(np.abs(port_enc.encode(texts) - fresh).max()) <= ATOL
    ids, mask = tok(long_texts, 512)
    model.rope = rope.Rope("longrope", model.rope.theta, 12, 128, model.rope.scaling, 10 ** 6)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) > BITES


@pytest.mark.parametrize("kind", ["su", "yarn"])
def test_su_and_yarn_are_read_as_longrope(ckpt, kind, tmp_path):
    """Phi3Config renames an older `type` su or yarn to longrope: a
    config.json that says so runs as the longrope stack."""
    path = _with_config(ckpt["phi3-lm"], tmp_path / kind, rope_scaling=_longrope(6, kind))
    assert transformers.AutoConfig.from_pretrained(path).rope_scaling["type"] == "longrope"
    model = checkpoint.build_model(checkpoint.load_checkpoint(path))
    assert model.rope.kind == "longrope"
    got, want, _mask = _forward(path, _texts(6, seed=13, lo=30) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


REFUSED = [
    ({"rope_scaling": {"type": "linear", "factor": 2.0}}, "rope_scaling"),
    ({"rope_scaling": {"rope_type": "linear", "factor": 2.0}}, "rope_scaling"),
    ({"rope_scaling": {"rope_type": "longrope", "short_factor": [1.0] * 8,
                       "long_factor": [1.0] * 8}}, "rope_scaling"),
    ({"rope_scaling": {**_longrope(8), "factor": 2.0}}, "rope_scaling"),
    ({"rope_scaling": {**_longrope(8), "type": "dynamic"}}, "rope_scaling"),
    ({"rope_scaling": {**_longrope(8), "short_factor": [1.0] * 7}}, "short_factor"),
    ({"rope_scaling": {**_longrope(8), "long_factor": ["1"] * 8}}, "long_factor"),
]


@pytest.mark.parametrize("change, match", REFUSED)
def test_what_phi3config_raises_on_is_refused_by_name(change, match):
    """Phi3Config takes no rope_scaling but the three-field longrope (su and
    yarn renamed so), lists of hidden_size / heads / 2 numbers; the port
    refuses the rest by name."""
    with pytest.raises(ValueError):
        _config(num_hidden_layers=2, **change)
    config = {"model_type": "phi3", "num_hidden_layers": 2, **SMALL, **copy.deepcopy(change)}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


def test_a_partial_rotary_factor_past_the_head_is_refused():
    """partial_rotary_factor 1.5: tables 24 wide on 16-wide heads, which
    the reference's apply_rotary_pos_emb raises on; the port refuses the
    config by name."""
    model = transformers.Phi3Model(_config(num_hidden_layers=1, partial_rotary_factor=1.5))
    ids = torch.arange(12)[None]
    with pytest.raises(RuntimeError, match="size of tensor"), torch.no_grad():
        model.eval()(input_ids=ids, attention_mask=torch.ones_like(ids))
    with pytest.raises(ValueError, match="partial_rotary_factor"):
        checkpoint.check_config({"model_type": "phi3", "num_hidden_layers": 1, **SMALL,
                                 "partial_rotary_factor": 1.5})


def test_the_window_bites(ckpt):
    """Mutation guard: one token more or less of reach moves the last
    hidden state past BITES on texts longer than the window."""
    c = checkpoint.load_checkpoint(ckpt["phi3-partial"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=14, lo=20), 512)
    window = model.config["window"]
    with torch.no_grad():
        want = model(ids, mask)
        for moved in (-1, 1):
            model.config["window"] = window + moved
            assert float((model(ids, mask) - want).abs().max()) > BITES, moved


def test_a_window_slides_every_layer_and_none_slides_without_one():
    widths = {"model_type": "phi3", "num_hidden_layers": 3, **SMALL}
    assert decoder.check_config(widths)["layer_types"] == ["full_attention"] * 3
    got = decoder.check_config({**widths, "sliding_window": 4096})
    assert got["layer_types"] == ["sliding_attention"] * 3 and got["window"] == 4096


# -- the encoder -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["phi3", "phi3-right", "phi3-partial", "phi3-partial-right",
                                  "phi3-lm"])
def test_encoder_matches_jax(ckpt, name, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of
    different lengths in one batch (the longrope stack past its 32
    positions); under left padding `forceCls` takes a pad token's state for
    the short texts, in both, and chunks of 3 are cut from the call's one
    padded batch (hazard 3.25)."""
    path = ckpt[name]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "Phi3Model"
    assert jax_enc._torch.config._attn_implementation == "sdpa"
    assert type(jax_enc._tokenizer).__name__ == "LlamaTokenizerFast"
    assert jax_enc._tokenizer.padding_side == ("right" if name.endswith("right") else "left")
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("kind, scaling", [
    ("phi3", None), ("llama", {"rope_type": "dynamic", "factor": 2.0}),
    ("llama", {"rope_type": "longrope", "short_factor": [1.0 + i / 8 for i in range(8)],
               "long_factor": [2.0 + i / 3 for i in range(8)], "factor": 4.0})])
@pytest.mark.parametrize("side", ["left", "right"])
def test_a_batch_length_rotary_is_chunked_as_one_batch(spec, tmp_path, kind, scaling, side,
                                                       monkeypatch):
    """A `longrope` or `dynamic` rotary takes its frequencies from the
    batch's padded length: past 32 positions the long factors, or the NTK
    base at that length. The JAX package pads the call's texts as one
    batch, so chunks of 3 are cut from that one batch (chunks padded to
    their own longest would take the short factors, or another base, and
    miss by 1e-2); under both poolings and both padding sides."""
    if kind == "phi3":
        model = transformers.Phi3Model(_config(num_hidden_layers=2, **LONGROPE))
    else:
        model = transformers.LlamaModel(transformers.LlamaConfig(
            **{**SMALL, "num_hidden_layers": 2, "max_position_embeddings": ORIGINAL,
               "rope_scaling": copy.deepcopy(scaling)}))
    _draw_weights(model, 130)
    path = str(tmp_path / kind)
    model.save_pretrained(path, safe_serialization=False)
    _tokenizer_files(path, spec, None if side == "left" else "right")
    texts = ["rust", "hello world", "café"] + _texts(5, seed=17, lo=30) + ["中文"] * 3
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    for pooling in ("useModel", "forceCls"):
        want = FlaxTextEncoder(path, pooling).encode(texts)
        got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
        assert float(np.abs(got - want).max()) <= ATOL, pooling


def test_chunk_texts_counts_the_fused_gated_mlp(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with gate_up_proj's 2 x intermediate_size counted (the
    arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["phi3"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * max(c["hidden_size"], heads * c["head_dim"])
                                             + 4 * c["intermediate_size"]))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, spec, tmp_path):
    """write_checkpoint's model.safetensors (fused names) loads into
    transformers' Phi3Model with nothing missing and computes the port's
    forward; AutoTokenizer reads its LlamaTokenizer files (Phi-3's added
    tokens among them) as the port does."""
    c = checkpoint.load_checkpoint(ckpt["phi3-lm"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=spec)
    assert os.path.exists(os.path.join(path, "model.safetensors"))
    ref, info = transformers.Phi3Model.from_pretrained(path, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    c = checkpoint.load_checkpoint(path)
    assert c.tokenizer["tokenizer_class"] == "LlamaTokenizer"
    texts = _texts(5, seed=6) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    want = transformers.AutoTokenizer.from_pretrained(path)(
        texts, padding=True, truncation=True, max_length=512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
