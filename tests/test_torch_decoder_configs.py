"""The decoder configurations beyond the published defaults in the text
encoder (K8): models/rope.py's rotary tables (`default`, `linear`,
`dynamic`, `yarn`, `llama3`, `longrope`), models/activations.py's MLP
activations, Qwen2's and Qwen3's sliding layers, Mistral's windows of any
size, Llama's `mlp_bias`, and Gemma 3's scaled global rotary beside its
unscaled local one and its ignored `attn_logit_softcapping`; held against
transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. The tables are compared bit for bit with each
family's transformers rotary module (a fresh one per length: `dynamic`
keeps state, fault 3.21). Tiny decoders (2 layers, hidden 64, 4 heads
over 2 KV heads; Qwen3 and Gemma 3 at head_dim 32 and 16) are built from
transformers' configs, their weights drawn with numpy from a seed (Q and
K with a standard deviation of 0.15, Q/K norms at 1 +- 0.3, so attention
is peaked and an off-by-one window or a rotary scaled otherwise shows),
and saved by transformers as pytorch_model.bin (Llama and Mistral from a
model.safetensors break the JAX package's Flax branch, fault 3.17) beside
seeded tokenizer files, once right- and once left-padded. The texts run
to 512 tokens: past `max_position_embeddings` 64 where `dynamic` and
`longrope` switch, past each window, and far enough for `llama3` and
`yarn` to move the long wavelengths. Each variant also has a guard: the
port with its setting undone (the default rotary, a window one token off,
no attention factor, another activation, no MLP bias, the local rotary
scaled) is more than 1e-4 off the reference."""

import copy
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    activations,
    checkpoint,
    decoder,
    fixtures,
    gemma3,
    hf_encoder,
    rope,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-4  # a setting undone must move the last hidden state this far (10 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文", "gpu"]
TEXTS = ["hello world", "", "rust", "café and café 中文", " ".join(WORDS * 40)]
SMALL = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2)
SLIDE_FULL = ["sliding_attention", "full_attention"]


def _longrope(n, factor=None):
    """A longrope rope_scaling with n short and long factors."""
    out = {"rope_type": "longrope", "short_factor": [1.0 + i / 8 for i in range(n)],
           "long_factor": [2.0 + i / 3 for i in range(n)]}
    if factor is not None:
        out["factor"] = factor
    return out


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


# -- the rotary tables ---------------------------------------------------------

# (rope_scaling, config keys beside it); head_dim 32, max_position_embeddings 64
ROPES = {
    "default": (None, {}),
    "linear": ({"rope_type": "linear", "factor": 2.0}, {}),
    "linear-type": ({"type": "linear", "factor": 8.0}, {}),
    "dynamic": ({"rope_type": "dynamic", "factor": 2.0}, {}),
    "yarn": ({"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 16}, {}),
    "yarn-mscale": ({"rope_type": "yarn", "factor": 4.0, "mscale": 0.707, "mscale_all_dim": 1.0,
                     "beta_fast": 16.0, "beta_slow": 2.0}, {}),
    "yarn-given": ({"rope_type": "yarn", "factor": 3.0, "attention_factor": 1.25,
                    "truncate": False, "original_max_position_embeddings": 32}, {}),
    "llama3": ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 16}, {}),
    "longrope": (_longrope(16, factor=2.0), {}),
    "longrope-original": (_longrope(16), {"original_max_position_embeddings": 32}),
}
FAMILIES = ("llama", "qwen2", "qwen3", "mistral", "gemma3_text")
# Gemma3TextConfig's validation raises on a bare `type` (REFUSED)
GEMMA_ROPES = [name for name in ROPES if name != "linear-type"]
TABLE_LENGTHS = (1, 7, 32, 33, 64, 65, 200, 512)


def _table_config(kind, name):
    scaling, extra = ROPES[name]
    return dict(vocab_size=100, max_position_embeddings=64, rope_theta=1e4,
                **{**SMALL, "hidden_size": 128}, head_dim=32,
                rope_scaling=copy.deepcopy(scaling), **extra)


def _port_model(config):
    with torch.device("meta"):
        return checkpoint.new_model(config)


def _reference_rotary(kind, config, local=False):
    from transformers.models.gemma3.modeling_gemma3 import Gemma3RotaryEmbedding
    from transformers.models.llama.modeling_llama import LlamaRotaryEmbedding
    from transformers.models.mistral.modeling_mistral import MistralRotaryEmbedding
    from transformers.models.qwen2.modeling_qwen2 import Qwen2RotaryEmbedding
    from transformers.models.qwen3.modeling_qwen3 import Qwen3RotaryEmbedding

    cls = {"llama": LlamaRotaryEmbedding, "qwen2": Qwen2RotaryEmbedding,
           "qwen3": Qwen3RotaryEmbedding, "mistral": MistralRotaryEmbedding,
           "gemma3_text": Gemma3RotaryEmbedding}[kind]
    ref_config = transformers.AutoConfig.for_model(kind, **copy.deepcopy(config))
    if local:  # as Gemma3TextModel builds rotary_emb_local
        ref_config.rope_theta = ref_config.rope_local_base_freq
        ref_config.rope_scaling = {"rope_type": "default"}
    return cls(ref_config)


@pytest.mark.parametrize("kind, name", [(kind, name) for kind in FAMILIES for name in ROPES
                                        if kind != "gemma3_text" or name in GEMMA_ROPES])
def test_rope_tables_are_transformers_bits(kind, name):
    """The port's rotary tables for the config (DecoderModel.rope,
    Gemma3Model.rope) equal the family's rotary module, cos and sin bit for
    bit, at lengths on both sides of max_position_embeddings (dynamic) and
    of the original length (longrope), a fresh module per length."""
    config = _table_config(kind, name)
    table = _port_model({"model_type": kind, **config}).rope
    assert table.kind == rope.rope_type(ROPES[name][0])
    for L in TABLE_LENGTHS:
        want_cos, want_sin = _reference_rotary(kind, config)(torch.zeros(1, L, 8),
                                                             torch.arange(L)[None])
        cos, sin = table.tables(L, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L


@pytest.mark.parametrize("name", GEMMA_ROPES)
def test_gemma3_local_rope_is_unscaled(name):
    """Gemma 3's sliding layers rotate by `rotary_emb_local`, built from a
    copy of the config with rope_scaling `default` at
    rope_local_base_freq, whatever the global rope_scaling."""
    config = _table_config("gemma3_text", name)
    model = _port_model({"model_type": "gemma3_text", **config})
    assert model.local_rope == rope.Rope("default", 10_000.0, 32)
    ref = _reference_rotary("gemma3_text", config, local=True)
    model_ref = transformers.Gemma3TextModel(transformers.Gemma3TextConfig(
        **copy.deepcopy(config)))
    for L in (7, 65, 512):
        positions = torch.arange(L)[None]
        want_cos, want_sin = model_ref.rotary_emb_local(torch.zeros(1, L, 8), positions)
        assert torch.equal(want_cos, ref(torch.zeros(1, L, 8), positions)[0])
        cos, sin = model.local_rope.tables(L, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L


def test_the_published_llama32_1b_config():
    """meta-llama/Llama-3.2-1B's config.json: 32 heads of 64 over 8 KV
    heads on a 2048-wide model, 973,078,528 Linear weights a token and
    1,235,814,400 parameters (the tied embedding counted once), and its
    llama3 rotary tables at rope_theta 500,000 equal LlamaRotaryEmbedding's
    to the bit up to 512 tokens."""
    from transformers.models.llama.modeling_llama import LlamaRotaryEmbedding

    published = {
        "model_type": "llama", "vocab_size": 128_256, "hidden_size": 2048,
        "intermediate_size": 8192, "num_hidden_layers": 16, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5,
        "rope_theta": 500_000.0, "max_position_embeddings": 131_072, "hidden_act": "silu",
        "attention_bias": False, "mlp_bias": False, "tie_word_embeddings": True,
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}}
    model = _port_model(published)
    linear = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert linear == 973_078_528
    assert sum(p.numel() for p in model.parameters()) == 1_235_814_400
    ref = LlamaRotaryEmbedding(transformers.LlamaConfig(**{
        k: copy.deepcopy(v) for k, v in published.items() if k != "model_type"}))
    for L in (1, 16, 511, 512):
        want_cos, want_sin = ref(torch.zeros(1, L, 8), torch.arange(L)[None])
        cos, sin = model.rope.tables(L, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L
    default = rope.Rope("default", 500_000.0, 64).tables(512, torch.device("cpu"))[0]
    assert not torch.equal(default, model.rope.tables(512, torch.device("cpu"))[0])
    # on a CUDA device with 70 GB free, a chunk takes 90 texts: 192.9 MB a
    # 512-token text (32 heads' scores, Q at 32 x 64, the gated MLP's
    # 2 x 8,192) in a quarter of the free memory
    enc = hf_encoder.TextEncoder("unused", device=None)
    enc._model, enc.device = model, torch.device("cuda", 0)
    free = 70 * 10**9
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 * 10**9))
        assert enc.chunk_texts() == free // 4 // 192_937_984 == 90


# -- the activations -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(activations.ACTIVATIONS))
def test_activation_is_transformers_bits(name):
    """Each name the port runs equals transformers' ACT2FN[name] bit for
    bit, on a wide spread of float32 values."""
    from transformers.activations import ACT2FN

    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.normal(0.0, 3.0, 8192), [0.0, -0.0, 1e-30, -1e-30, 20.0, -20.0, 80.0, -80.0]]
    ).astype(np.float32))
    assert torch.equal(activations.activation(name)(x), ACT2FN[name](x))


@pytest.mark.parametrize("name", ["gelu_10", "mish", "nope"])
def test_other_activations_are_refused_by_name(name):
    with pytest.raises(ValueError, match=f"hidden_act `{name}`"):
        decoder.check_config({"model_type": "llama", "vocab_size": 10, **SMALL,
                              "hidden_act": name})
    with pytest.raises(ValueError, match=f"hidden_activation `{name}`"):
        gemma3.check_config({"model_type": "gemma3_text", "vocab_size": 10, **SMALL,
                             "head_dim": 16, "hidden_activation": name})


# -- the variants, their forward and their encoder ----------------------------------

# name -> (model_type, transformers config arguments)
VARIANTS = {
    "llama-llama3": ("llama", dict(rope_theta=5e5, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32})),
    "llama-mlp-bias-gelu-new": ("llama", dict(mlp_bias=True, attention_bias=True,
                                              hidden_act="gelu_new")),
    "llama-longrope-original": ("llama", dict(max_position_embeddings=64,
                                              original_max_position_embeddings=32,
                                              rope_scaling=_longrope(8))),
    "llama-yarn": ("llama", dict(max_position_embeddings=128, rope_scaling={
        "rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32})),
    "qwen2-yarn-type": ("qwen2", dict(rope_theta=1e6, rope_scaling={
        "type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32})),
    "qwen2-sliding": ("qwen2", dict(use_sliding_window=True, sliding_window=6,
                                    max_window_layers=1)),
    "qwen2-dynamic-mlp-bias": ("qwen2", dict(max_position_embeddings=64, mlp_bias=True,
                                             hidden_act="quick_gelu", rope_scaling={
                                                 "rope_type": "dynamic", "factor": 2.0})),
    "qwen2-longrope": ("qwen2", dict(max_position_embeddings=64,
                                     rope_scaling=_longrope(8, factor=2.0))),
    # Qwen3's documented long-context setting (yarn 4 over 32,768), a window
    # of 8 from layer 1 and the erf GELU: chip_smoke.py's variant (a)
    "qwen3-yarn-sliding-gelu": ("qwen3", dict(
        head_dim=32, rope_theta=1e6, max_position_embeddings=131_072, hidden_act="gelu",
        use_sliding_window=True, sliding_window=8, max_window_layers=1,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 32_768})),
    "qwen3-layer-types": ("qwen3", dict(head_dim=32, use_sliding_window=True, sliding_window=6,
                                        layer_types=SLIDE_FULL)),
    "qwen3-swish-linear": ("qwen3", dict(head_dim=32, hidden_act="swish", rope_scaling={
        "rope_type": "linear", "factor": 2.0})),
    "mistral-window-linear": ("mistral", dict(sliding_window=8, rope_scaling={
        "rope_type": "linear", "factor": 2.0})),
    "mistral-full-llama3": ("mistral", dict(sliding_window=None, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 32})),
    "mistral-dynamic-gelu-fast": ("mistral", dict(
        head_dim=16, max_position_embeddings=64, sliding_window=4096, hidden_act="gelu_fast",
        rope_scaling={"rope_type": "dynamic", "factor": 2.0})),
    "mistral-wide-window-relu": ("mistral", dict(sliding_window=5000, hidden_act="relu")),
    # chip_smoke.py's variant (d): Gemma 3's larger decoders' linear 8, a
    # softcap the reference ignores, the erf GELU
    "gemma3-linear-softcap-gelu": ("gemma3_text", dict(
        layer_types=SLIDE_FULL, sliding_window=6, attn_logit_softcapping=50.0,
        hidden_activation="gelu", rope_scaling={"rope_type": "linear", "factor": 8.0})),
    "gemma3-yarn-bidirectional": ("gemma3_text", dict(
        layer_types=SLIDE_FULL, sliding_window=16, use_bidirectional_attention=True,
        hidden_activation="gelu_new", rope_scaling={
            "rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32})),
    "gemma3-dynamic": ("gemma3_text", dict(layer_types=SLIDE_FULL, sliding_window=6,
                                           max_position_embeddings=64, rope_scaling={
                                               "rope_type": "dynamic", "factor": 2.0})),
}


def _default_rope(m):
    m.rope = rope.Rope("default", m.rope.theta, m.rope.dim)


def _no_attention_factor(m):
    m.rope = dataclasses.replace(m.rope, scaling=m.rope.scaling + (("attention_factor", 1.0),))


def _window(delta):
    def move(m):
        m.config["window"] += delta
    return move


def _act(fn):
    def swap(m):
        for layer in m.layers:
            layer.mlp.act = fn
    return swap


def _no_mlp_bias(m):
    for layer in m.layers:  # new tensors: the parameters are the checkpoint's own
        for proj in (layer.mlp.gate_proj, layer.mlp.up_proj, layer.mlp.down_proj):
            proj.bias = torch.nn.Parameter(torch.zeros_like(proj.bias))


def _all_full(m):
    """No layer slides: `max_window_layers` read as `>` (layer 1 of 2
    stops sliding), or a given layer_types ignored for the derived one
    (max_window_layers 28)."""
    m.config["layer_types"] = ["full_attention"] * len(m.layers)


def _scaled_local(m):
    m.local_rope = dataclasses.replace(m.rope, theta=m.local_rope.theta)


# name -> the settings undone, each of which must move the output past BITES
UNDONE = {
    "llama-llama3": [_default_rope],
    "llama-mlp-bias-gelu-new": [_no_mlp_bias, _act(F.gelu)],
    "llama-longrope-original": [_default_rope],
    "llama-yarn": [_default_rope, _no_attention_factor],
    "qwen2-yarn-type": [_default_rope],
    "qwen2-sliding": [_window(-1), _window(1), _all_full],
    "qwen2-dynamic-mlp-bias": [_default_rope, _act(F.silu)],
    "qwen2-longrope": [_default_rope],
    "qwen3-yarn-sliding-gelu": [_no_attention_factor, _window(-1), _window(1), _all_full,
                                _act(F.silu)],
    "qwen3-layer-types": [_all_full],
    "qwen3-swish-linear": [_default_rope],
    "mistral-window-linear": [_default_rope, _window(-1), _window(1)],
    "mistral-full-llama3": [_default_rope],
    "mistral-dynamic-gelu-fast": [_default_rope, _act(F.silu)],
    "mistral-wide-window-relu": [_act(F.silu)],
    "gemma3-linear-softcap-gelu": [_default_rope, _scaled_local, _window(1),
                                   _act(activations.ACTIVATIONS["gelu_pytorch_tanh"])],
    "gemma3-yarn-bidirectional": [_no_attention_factor, _scaled_local],
    "gemma3-dynamic": [_default_rope],
}


# saved without layer_types, as checkpoints from before transformers wrote
# it are (gte-Qwen2's): the layers' types derived from max_window_layers
DERIVED = ("qwen2-sliding", "qwen3-yarn-sliding-gelu")


def _layout(kind):
    return {"qwen2": "qwen", "qwen3": "qwen", "gemma3_text": "gemma"}.get(kind, "llama3")


def _tokenizer_files(path, spec, layout, side):
    if layout == "qwen":
        config = fixtures.qwen2_tokenizer_config(spec, padding_side=side)
    elif layout == "gemma":
        config = fixtures.gemma_tokenizer_config(spec, padding_side=side)
    else:
        config = fixtures.llama3_tokenizer_config(spec, padding_side=side)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


def _draw_weights(model, seed):
    """Q and K at 0.15 (peaked attention), the rest at 0.05; norm weights 1
    + N(0, 0.05), Q/K norms 1 + N(0, 0.3), Gemma's other `(1 + w)` norms
    N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    gemma = isinstance(model, transformers.Gemma3TextModel)
    with torch.no_grad():
        for name, p in model.named_parameters():
            qk_norm = "q_norm" in name or "k_norm" in name
            if "norm" in name:
                sd, mean = (0.3, 0.0 if gemma and not qk_norm else 1.0) if gemma or qk_norm \
                    else (0.05, 1.0)
            else:
                sd, mean = 0.05, 0.0
                if "q_proj" in name or "k_proj" in name:
                    sd = 0.15
            draw = rng.normal(mean, sd, tuple(p.shape))
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _reference_config(kind, vocab, kwargs):
    if kind == "gemma3_text":
        return transformers.Gemma3TextConfig(vocab_size=vocab, **SMALL, head_dim=16,
                                             query_pre_attn_scalar=16,
                                             **copy.deepcopy(kwargs))
    widths = {**SMALL, "max_position_embeddings": 2048, **copy.deepcopy(kwargs)}
    return transformers.AutoConfig.for_model(kind, vocab_size=vocab, **widths)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`{variant}-{side}` for each of VARIANTS and both padding sides: the
    tiny model as pytorch_model.bin beside its tokenizer files (Qwen2's
    layout for qwen2/qwen3, Llama-3's for llama/mistral, Gemma's for
    gemma3_text)."""
    root = tmp_path_factory.mktemp("decoder_configs")
    train = TEXTS + _texts(200, seed=1)
    specs = {"qwen": fixtures.qwen2_tokenizer_json(train, 1200, seed=13),
             "llama3": fixtures.llama3_tokenizer_json(train, 1200, seed=14),
             "gemma": fixtures.gemma_tokenizer_json(train, 1200, seed=15)}
    out = {}
    for i, (name, (kind, kwargs)) in enumerate(VARIANTS.items()):
        spec = specs[_layout(kind)]
        model = transformers.AutoModel.from_config(
            _reference_config(kind, len(spec["model"]["vocab"]), kwargs))
        _draw_weights(model, 80 + i)
        for side in ("right", "left"):
            path = out[f"{name}-{side}"] = str(root / f"{name}-{side}")
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, spec, _layout(kind), side)
            if name in DERIVED:
                with open(os.path.join(path, "config.json")) as f:
                    saved = json.load(f)
                del saved["layer_types"]
                with open(os.path.join(path, "config.json"), "w") as f:
                    json.dump(saved, f)
    return out


def _batch(c):
    texts = _texts(6, seed=9, lo=0, hi=220) + TEXTS
    return checkpoint.build_tokenizer(c)(texts, 512)


def _reference_forward(path, ids, mask, monkeypatch=None):
    """AutoModel's last hidden state: under its default `sdpa`, or, given
    `monkeypatch`, under `eager` (explicit products and softmax, as the
    port computes them, so the same bits) with a query that sees no key
    given an attention output of 0, as `sdpa` gives it (hazard 3.18;
    `eager` alone averages every key). `sdpa`'s own rounding drifts from
    both by up to 1.4e-5 on Gemma 3 under yarn."""
    impl = "sdpa" if monkeypatch is None else "eager"
    ref = transformers.AutoModel.from_pretrained(path, attn_implementation=impl).eval()
    assert ref.config._attn_implementation == impl
    if monkeypatch is not None:
        module = sys.modules[type(ref).__module__]
        eager = module.eager_attention_forward

        def zero_unseen(attn, query, key, value, attention_mask, **kwargs):
            out, weights = eager(attn, query, key, value, attention_mask, **kwargs)
            hidden = attention_mask[:, :, :, : key.shape[-2]] == torch.finfo(out.dtype).min
            unseen = hidden.all(-1).transpose(1, 2)[..., None]  # (B, L, 1, 1)
            return out.masked_fill(unseen, 0.0), weights

        monkeypatch.setattr(module, "eager_attention_forward", zero_unseen)
    with torch.no_grad():
        return ref(input_ids=ids, attention_mask=mask).last_hidden_state


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("name", VARIANTS)
def test_forward_matches_transformers_on_every_row(ckpt, name, side, monkeypatch):
    """A padded batch of texts of 1 to 512 tokens: every row of the last
    hidden state, padded ones included, equals AutoModel (`eager`, a query
    that sees no key zeroed as `sdpa` zeroes it) within ATOL."""
    path = ckpt[f"{name}-{side}"]
    c = checkpoint.load_checkpoint(path)
    model = checkpoint.build_model(c)
    assert model.config["model_type"] == VARIANTS[name][0]
    ids, mask = _batch(c)
    assert ids.shape[1] == 512 and int((mask == 0).sum()) > 0
    real = mask.sum(1) > 0  # "" has no token in Qwen2's layout
    assert bool((mask[real, -1 if side == "left" else 0] == 1).all())
    want = _reference_forward(path, ids, mask, monkeypatch)
    with torch.no_grad():
        got = model(ids, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("name", VARIANTS)
def test_each_setting_bites(ckpt, name, monkeypatch):
    """Mutation guard: the port with one of the variant's settings undone
    is more than BITES off the reference on the same batch, so the forward
    test would catch it."""
    path = ckpt[f"{name}-right"]
    c = checkpoint.load_checkpoint(path)
    ids, mask = _batch(c)
    want = _reference_forward(path, ids, mask, monkeypatch)
    for undo in UNDONE[name]:
        model = checkpoint.build_model(c)
        undo(model)
        with torch.no_grad():
            got = model(ids, mask)
        assert float((got - want).abs().max()) > BITES, undo.__name__


def test_the_variants_read_as_transformers_config_objects(ckpt):
    """Each variant's layers slide, and by how far, as the family's
    transformers model takes them: the config object's layer_types and
    sliding_window for Qwen2, Qwen3 and Gemma 3, every layer at
    sliding_window for Mistral, no layer for Llama; Llama alone loads MLP
    biases."""
    for name, (kind, _kwargs) in VARIANTS.items():
        path = ckpt[f"{name}-right"]
        model = checkpoint.build_model(checkpoint.load_checkpoint(path))
        want = transformers.AutoConfig.from_pretrained(path)
        n = want.num_hidden_layers
        if kind == "mistral":
            types = ["sliding_attention" if want.sliding_window is not None
                     else "full_attention"] * n
        elif kind == "llama":
            types = ["full_attention"] * n
        else:
            types = want.layer_types
        got = [("sliding_attention" if layer.sliding else "full_attention")
               for layer in model.layers] if kind == "gemma3_text" else model.config["layer_types"]
        assert got == types, name
        if "sliding_attention" in types:
            assert model.config["window"] == want.sliding_window, name
        has_bias = model.layers[0].mlp.gate_proj.bias is not None
        assert has_bias == (kind == "llama" and getattr(want, "mlp_bias", False)), name


@pytest.mark.parametrize("kind", ["qwen2", "qwen3"])
@pytest.mark.parametrize("use, window, max_window_layers", [
    (True, 6, 0), (True, 6, 1), (True, 6, 3), (True, 6, 28), (True, None, 1), (False, 6, 1)])
def test_qwen_layer_types_are_derived_as_its_config_derives_them(kind, use, window,
                                                                 max_window_layers):
    """No layer_types in the file: layer i slides iff use_sliding_window
    keeps a window and i >= max_window_layers, as Qwen2Config and
    Qwen3Config derive it."""
    changes = dict(num_hidden_layers=4, use_sliding_window=use, sliding_window=window,
                   max_window_layers=max_window_layers)
    want = transformers.AutoConfig.for_model(kind, **{**SMALL, **changes})
    got = decoder.check_config({"model_type": kind, "vocab_size": 10, **SMALL, **changes})
    assert got["layer_types"] == want.layer_types
    assert got["window"] == want.sliding_window


# (variant, padding side) held against the JAX package's encoder
ENCODED = [("llama-llama3", "right"), ("llama-mlp-bias-gelu-new", "left"),
           ("qwen3-yarn-sliding-gelu", "left"), ("qwen2-sliding", "right"),
           ("mistral-window-linear", "left"), ("gemma3-linear-softcap-gelu", "left")]


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
@pytest.mark.parametrize("name, side", ENCODED)
def test_encoder_matches_jax(ckpt, name, side, pooling):
    """The JAX package's torch branch (pytorch_model.bin: fault 3.17 for
    Llama and Mistral; no Flax Qwen2, Qwen3 or Gemma 3), pooled and
    normalized, texts of 1 to 512 tokens in one batch."""
    path = ckpt[f"{name}-{side}"]
    texts = _texts(8, seed=3, hi=220) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and jax_enc._tokenizer.padding_side == side
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


# -- faults of the reference, and what it refuses -------------------------------------


def _with_config(src, dst, **changes):
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "config.json")) as f:
        config = json.load(f)
    config.update(changes)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config, f)
    return str(dst)


def test_fault_320_gemma3_softcapping_is_ignored(ckpt, tmp_path):
    """transformers' Gemma3Attention stores attn_logit_softcapping but never
    passes it to the attention function: a cap of 0.5, which would flatten
    these scores, leaves AutoModel's output and the JAX package's vectors
    as they are without one; the port ignores it too."""
    src = ckpt["gemma3-linear-softcap-gelu-left"]
    capped = _with_config(src, tmp_path / "capped", attn_logit_softcapping=0.5)
    plain = _with_config(src, tmp_path / "plain", attn_logit_softcapping=None)
    c = checkpoint.load_checkpoint(capped)
    ids, mask = _batch(c)
    want = _reference_forward(plain, ids, mask)
    assert torch.equal(_reference_forward(capped, ids, mask), want)
    with torch.no_grad():
        got = checkpoint.build_model(c)(ids, mask)
        assert torch.equal(got, checkpoint.build_model(checkpoint.load_checkpoint(plain))(ids,
                                                                                          mask))
    assert float((got - want).abs().max()) <= ATOL
    texts = _texts(6, seed=4, hi=120) + TEXTS
    jax_capped = FlaxTextEncoder(capped, "useModel").encode(texts)
    np.testing.assert_array_equal(jax_capped, FlaxTextEncoder(plain, "useModel").encode(texts))
    port = hf_encoder.TextEncoder(capped, "useModel", device=None).encode(texts)
    assert float(np.abs(port - jax_capped).max()) <= ATOL


def test_fault_321_the_references_dynamic_rope_keeps_state(ckpt):
    """transformers' `dynamic` rotary keeps the frequencies of the longest
    batch it has seen until a batch under max_position_embeddings comes:
    the JAX package's encoder, one model for every call, embeds a batch of
    65-200 tokens otherwise after a 512-token batch than a fresh encoder
    does. The port computes each batch at its own length, as a fresh
    model does."""
    path = ckpt["qwen2-dynamic-mlp-bias-right"]
    long_texts = [" ".join(WORDS * 30)]
    mid_texts = _texts(4, seed=5, lo=40, hi=60)
    enc = hf_encoder.TextEncoder(path, "useModel", device=None)
    enc._load()
    length = max(len(enc._tokenizer.ids(t)) for t in mid_texts)
    assert 64 < length < 512
    seen = FlaxTextEncoder(path, "useModel")
    seen.encode(long_texts)
    after = seen.encode(mid_texts)
    fresh = FlaxTextEncoder(path, "useModel").encode(mid_texts)
    assert float(np.abs(after - fresh).max()) > BITES
    enc.encode(long_texts)
    got = enc.encode(mid_texts)
    assert float(np.abs(got - fresh).max()) <= ATOL


# (model_type, config changes, what the port's refusal names, what transformers raises)
REFUSED = [
    ("llama", {"rope_scaling": {"rope_type": "mrope", "factor": 2.0}}, "rope_type", KeyError),
    ("qwen2", {"rope_scaling": {"factor": 2.0}}, "rope_type", KeyError),
    ("llama", {"rope_scaling": {"rope_type": "llama3", "factor": 8.0}}, "lacks", KeyError),
    ("mistral", {"rope_scaling": {"rope_type": "llama3", "factor": 8.0}}, "lacks", KeyError),
    ("qwen3", {"rope_scaling": _longrope(16)}, "longrope", TypeError),
    ("mistral", {"rope_scaling": {"rope_type": "dynamic", "factor": 2.0}}, "head_dim",
     TypeError),
    ("mistral", {"rope_scaling": {"rope_type": "yarn", "factor": 2.0}}, "head_dim", TypeError),
    ("mistral", {"rope_scaling": _longrope(8, factor=2.0)}, "head_dim", TypeError),
    ("qwen2", {"layer_types": SLIDE_FULL}, "layer_types", TypeError),
    ("qwen3", {"layer_types": SLIDE_FULL, "sliding_window": 8}, "layer_types", TypeError),
    ("llama", {"layer_types": SLIDE_FULL}, "layer_types", TypeError),
    ("mistral", {"layer_types": SLIDE_FULL, "sliding_window": None}, "layer_types",
     TypeError),
    ("qwen3", {"hidden_act": "nope"}, "hidden_act", KeyError),
    ("gemma3_text", {"rope_scaling": {"rope_type": "mrope", "factor": 2.0}}, "rope_type",
     KeyError),
    ("gemma3_text", {"rope_scaling": _longrope(8)}, "longrope", TypeError),
    ("gemma3_text", {"rope_scaling": {"type": "linear", "factor": 8.0}}, "rope_type",
     KeyError),
    ("gemma3_text", {"hidden_activation": "nope"}, "hidden_activation", KeyError),
]


def _reference_run(kind, changes):
    config = _reference_config(kind, 100, {"max_position_embeddings": 64, **changes})
    model = transformers.AutoModel.from_config(config).eval()
    ids = torch.randint(0, 100, (2, 80), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model(input_ids=ids, attention_mask=torch.ones_like(ids)).last_hidden_state


@pytest.mark.parametrize("kind, changes, match, raised", REFUSED)
def test_what_the_reference_raises_on_is_refused_by_name(kind, changes, match, raised):
    """Each config transformers raises on (at the config, the rotary tables,
    the mask or the cache) the port refuses by name when it reads it."""
    with pytest.raises(raised):
        _reference_run(kind, copy.deepcopy(changes))
    config = {"model_type": kind, "vocab_size": 100, "max_position_embeddings": 64, **SMALL,
              **({"head_dim": 16} if kind == "gemma3_text" else {}), **copy.deepcopy(changes)}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


@pytest.mark.parametrize("kind", FAMILIES)
def test_partial_rotary_factor_is_refused_as_the_reference_raises(kind):
    """partial_rotary_factor 0.5: the families' rotary tables cover half the
    head, and transformers' apply_rotary_pos_emb raises on the sizes; the
    port refuses the config by name."""
    with pytest.raises(RuntimeError, match="size of tensor"):
        _reference_run(kind, {"partial_rotary_factor": 0.5})
    config = {"model_type": kind, "vocab_size": 100, **SMALL, "partial_rotary_factor": 0.5,
              **({"head_dim": 16} if kind == "gemma3_text" else {})}
    with pytest.raises(ValueError, match="partial_rotary_factor"):
        checkpoint.check_config(config)


def test_a_longrope_factor_list_of_another_length_is_refused():
    with pytest.raises(ValueError, match="short_factor has 4 entries"):
        decoder.check_config({"model_type": "llama", "vocab_size": 10, **SMALL,
                              "rope_scaling": {**_longrope(8, factor=2.0),
                                               "short_factor": [1.0] * 4}})
