"""The decoder embedders in the text encoder (K8): the port's `qwen3`,
`qwen2`, `llama` and `mistral` model types (models/decoder.py: pre-norm
RMSNorm, rotary positions, grouped-query attention under a causal mask,
the SiLU-gated MLP; Qwen3's per-head Q/K norm, Qwen2's Q/K/V biases,
Llama's `attention_bias`), their weight names, Qwen2's and Llama-3's
byte-level BPE tokenizers with left padding, and the encoder against
transformers and the JAX package's `FlaxTextEncoder`, at the published
defaults (rope scaling, sliding layers, `mlp_bias` and the other
activations: tests/test_torch_decoder_configs.py).

Nothing is downloaded. Tiny decoders (2 layers, hidden 64, 4 heads over 2
KV heads, intermediate 96; Qwen3 with `head_dim` 32, not 64 / 4) are
built from transformers' configs, their weights drawn with numpy from a
seed (Q and K with a standard deviation of 0.15, so attention is peaked;
every norm weight 1 plus noise, Qwen3's Q/K norms with 0.3, so a norm
moved after the rotary shows), and saved by transformers beside seeded
tokenizer files in Qwen2's layout (`qwen3`, `qwen2`) or Llama-3's
(`llama`, `mistral`), models/fixtures.py, once with the published right
padding and once with tokenizer_config.json's `padding_side` `left`, as
Qwen3-Embedding publishes. transformers has no Flax Qwen2 or Qwen3, so
the JAX package's encoder runs transformers' torch model (its AutoModel
branch, `sdpa`); its Flax Llama and Mistral raise on a model.safetensors
(fault 3.17), so those two are saved as pytorch_model.bin only. The port
is held against the JAX package within 1e-5 on normalized vectors, for
every pooling and both padding sides, and against `AutoModel` on every
row of the last hidden state, padded ones included (hazard 3.18)."""

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
    hf_encoder,
    modernbert,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
KINDS = ("qwen3", "qwen2", "llama", "mistral")
BPE_SIZE = 1200
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "привет", "中文", "it's", "we'll", "HELLO",
         "2024", "1234567", "gpu", "don'T", "x'Sy"]
TEXTS = [
    "hello world", "it's we'll DON'T x'ſy", "a\r\n\r\n  b  \n c", "12 345 6789 1234567",
    "<|endoftext|>x<|im_start|> <think>y", "<|begin_of_text|> <|eot_id|>z", "",
    "café and café", "中文 search中文 привет мир", "straße über " * 8,
    "tab\there\nnew  line", "a⹃b ㋿ Ᲊ ꟲ \U00010781",
]
PUBLISHED_QWEN3_EMBEDDING = {
    "model_type": "qwen3", "vocab_size": 151_669, "hidden_size": 1024,
    "num_hidden_layers": 28, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 128, "intermediate_size": 3072, "rope_theta": 1_000_000,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 32_768, "tie_word_embeddings": True,
    "hidden_act": "silu", "attention_bias": False, "use_sliding_window": False,
    "sliding_window": None, "max_window_layers": 28, "rope_scaling": None,
    "layer_types": ["full_attention"] * 28,
}


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops on one thread: seconds, not minutes, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _specs():
    train = TEXTS + _texts(200, seed=1)
    return {"qwen": fixtures.qwen2_tokenizer_json(train, BPE_SIZE, seed=13),
            "llama": fixtures.llama3_tokenizer_json(train, BPE_SIZE, seed=14)}


def _tokenizer_files(path, kind, spec, side):
    side = None if side == "right" else side
    if kind in ("qwen3", "qwen2"):
        config = fixtures.qwen2_tokenizer_config(spec, padding_side=side)
    else:
        config = fixtures.llama3_tokenizer_config(spec, padding_side=side)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


def _config(kind, spec):
    vocab = spec["model"]["vocab"]
    # 2,048 positions: Flax Mistral's 131,072 default takes 40 s to load
    common = dict(vocab_size=len(vocab), hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=2048)
    if kind == "qwen3":
        return transformers.Qwen3Config(head_dim=32, rope_theta=1e6, **common)
    if kind == "qwen2":
        return transformers.Qwen2Config(rope_theta=1e6, **common)
    if kind == "llama":
        return transformers.LlamaConfig(attention_bias=True, rope_theta=5e5, **common)
    return transformers.MistralConfig(sliding_window=4096, **common)


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            sd = 0.15 if ("q_proj" in name or "k_proj" in name) else 0.05
            if "q_norm" in name or "k_norm" in name:
                sd = 0.3
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if "norm" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`{kind}-{side}` for each kind and padding side: the tiny decoder
    with its tokenizer files (Qwen2's layout for qwen3/qwen2, Llama-3's for
    llama/mistral); qwen3 and qwen2 as model.safetensors, llama and
    mistral as pytorch_model.bin. `llama-st`/`mistral-st`: the same
    weights as model.safetensors (fault 3.17). `port`: qwen3 as the port
    writes it."""
    root = tmp_path_factory.mktemp("decoders")
    specs = _specs()
    out = {}
    for i, kind in enumerate(KINDS):
        spec = specs["qwen" if kind.startswith("qwen") else "llama"]
        model = transformers.AutoModel.from_config(_config(kind, spec))
        _draw_weights(model, 40 + i)
        for side in ("right", "left"):
            path = out[f"{kind}-{side}"] = str(root / f"{kind}-{side}")
            model.save_pretrained(path, safe_serialization=kind.startswith("qwen"))
            _tokenizer_files(path, kind, spec, side)
        if not kind.startswith("qwen"):
            path = out[f"{kind}-st"] = str(root / f"{kind}-st")
            model.save_pretrained(path)
            _tokenizer_files(path, kind, spec, "right")
    c = checkpoint.load_checkpoint(out["qwen3-left"])
    out["port"] = str(root / "port")
    checkpoint.write_checkpoint(out["port"], c.config, c.state_dict, tokenizer_json=specs["qwen"],
                                tokenizer_config=c.tokenizer)
    return out


# -- config, layers and weights --------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_the_config_reads_as_a_decoder(ckpt, kind):
    c = checkpoint.load_checkpoint(ckpt[f"{kind}-right"])
    model = checkpoint.build_model(c)
    assert isinstance(model, decoder.DecoderModel) and model.config["model_type"] == kind
    assert model.config["num_key_value_heads"] == 2
    assert model.config["head_dim"] == (32 if kind == "qwen3" else 16)
    attn = model.layers[0].self_attn
    assert attn.qk_norm == (kind == "qwen3")
    assert (attn.q_proj.bias is not None) == (kind in ("qwen2", "llama"))
    assert (attn.o_proj.bias is not None) == (kind == "llama")
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and tok.split is not None
    assert tok.ignore_merges == (kind in ("llama", "mistral"))


def test_the_published_qwen3_embedding_widths():
    """Qwen3-Embedding-0.6B: 16 heads of 128 on a 1024-wide model (not
    1024 / 16), 8 KV heads, 440.4 M linear weights a token."""
    config = decoder.check_config(PUBLISHED_QWEN3_EMBEDDING)
    assert (config["head_dim"], config["num_key_value_heads"]) == (128, 8)
    with torch.device("meta"):
        model = decoder.DecoderModel(config)
    attn = model.layers[0].self_attn
    assert tuple(attn.q_proj.weight.shape) == (2048, 1024)
    assert tuple(attn.k_proj.weight.shape) == (1024, 1024)
    linear = sum(m.weight.numel() for m in model.modules() if isinstance(m, torch.nn.Linear))
    assert linear == 440_401_920
    total = sum(p.numel() for p in model.parameters())
    assert abs(total - 596e6) < 1e6


def test_rotary_tables_are_transformers_bits():
    """modernbert.rotary at rope_theta 1e6 and head_dim 128 is
    Qwen3RotaryEmbedding's cos and sin, bit for bit, for positions
    0..L-1."""
    from transformers.models.qwen3.modeling_qwen3 import Qwen3RotaryEmbedding

    ref = Qwen3RotaryEmbedding(transformers.Qwen3Config(**{
        k: v for k, v in PUBLISHED_QWEN3_EMBEDDING.items() if k != "model_type"}))
    for L in (1, 7, 128, 511, 512):
        x = torch.zeros(1, L, 1024)
        want_cos, want_sin = ref(x, torch.arange(L)[None])
        cos, sin = modernbert.rotary(L, 128, 1e6, torch.device("cpu"))
        assert torch.equal(cos[0, 0], want_cos[0]) and torch.equal(sin[0, 0], want_sin[0]), L


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """`*ForCausalLM` names (`model.` prefix, `lm_head.`) and an old
    checkpoint's `rotary_emb.inv_freq` map onto the same names and
    tensors; the safetensors and bin routes give identical tensors."""
    state = checkpoint.read_weights(ckpt["llama-right"])
    assert set(state) == set(decoder.DecoderModel(
        checkpoint.load_checkpoint(ckpt["llama-right"]).config).state_dict())
    st = checkpoint.read_weights(ckpt["llama-st"])
    assert set(st) == set(state) and all(torch.equal(st[k], state[k]) for k in state)
    lm = transformers.LlamaForCausalLM.from_pretrained(ckpt["llama-right"]).state_dict()
    assert any(k.startswith("model.") for k in lm) and "lm_head.weight" in lm
    lm["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
    got = checkpoint.hf_to_state_dict(lm)
    assert set(got) == set(state) and all(torch.equal(got[k], state[k]) for k in state)


def test_a_safetensors_file_is_read_as_one_host_copy(ckpt):
    """read_weights shares read_safetensors' one buffer (no copy per
    tensor), and build_model takes those tensors as its parameters."""
    state = checkpoint.read_weights(ckpt["qwen3-right"])
    lo = min(t.data_ptr() for t in state.values())
    hi = max(t.data_ptr() + t.nbytes for t in state.values())
    assert hi - lo <= os.path.getsize(os.path.join(ckpt["qwen3-right"], "model.safetensors"))
    c = checkpoint.load_checkpoint(ckpt["qwen3-right"])
    model = checkpoint.build_model(c)
    assert model.norm.weight.data_ptr() == c.state_dict["norm.weight"].data_ptr()


# what transformers raises on (tests/test_torch_decoder_configs.py pins each
# raise): sliding layers with no window (a Qwen config keeps sliding_window
# only under use_sliding_window), a rotary of half the head, uneven groups
REFUSED = [
    ("qwen3", {"layer_types": ["full_attention", "sliding_attention"]}, "layer_types"),
    ("llama", {"partial_rotary_factor": 0.5}, "partial_rotary_factor"),
    ("qwen2", {"num_key_value_heads": 3}, "num_key_value_heads"),
]


@pytest.mark.parametrize("kind, change, match", REFUSED)
def test_unread_decoder_configs_are_refused(ckpt, kind, change, match):
    config = {**checkpoint.load_checkpoint(ckpt[f"{kind}-right"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


@pytest.mark.parametrize("kind", KINDS)
def test_defaults_fill_what_a_config_leaves_out(kind):
    """A config without the keys a family defaults resolves as transformers'
    config class of that family resolves it: Qwen2's and Qwen3's 32 KV
    heads, Mistral's 8 and its 4,096-token window, Qwen3's head_dim 128,
    head_dim hidden / heads elsewhere."""
    widths = {"vocab_size": 100, "hidden_size": 2048, "intermediate_size": 96,
              "num_hidden_layers": 1, "num_attention_heads": 64}
    got = decoder.check_config({"model_type": kind, **widths})
    want = transformers.AutoConfig.for_model(kind, **widths)
    assert got["num_key_value_heads"] == (want.num_key_value_heads or 64)
    assert got["head_dim"] == (getattr(want, "head_dim", None) or 2048 // 64)
    for key in ("rms_norm_eps", "rope_theta", "rope_scaling", "attention_bias", "mlp_bias",
                "use_sliding_window", "max_position_embeddings", "max_window_layers"):
        if hasattr(want, key):
            assert got[key] == getattr(want, key), key
    if kind == "mistral":
        assert got["sliding_window"] == want.sliding_window == 4096


# -- the forward and the encoder ----------------------------------------------------


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert ref.config._attn_implementation == "sdpa"
    return ref


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_transformers_on_every_row(ckpt, kind, side):
    """Padded batches of texts of different lengths: every row of the last
    hidden state, padded ones included, equals AutoModel's default (sdpa)
    within ATOL; under left padding a pad query sees no key."""
    c = checkpoint.load_checkpoint(ckpt[f"{kind}-{side}"])
    model = checkpoint.build_model(c)
    texts = _texts(6, seed=9) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    real = mask.sum(1) > 0
    assert int((mask == 0).sum()) > 0
    # "" has no token in Qwen2's layout: a row of pad queries alone
    assert bool(real.all()) == (kind in ("llama", "mistral"))
    assert bool((mask[real, -1 if side == "left" else 0] == 1).all())
    with torch.no_grad():
        want = _reference(ckpt[f"{kind}-{side}"])(input_ids=ids,
                                                  attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_a_pad_query_with_no_visible_key_attends_to_nothing(ckpt):
    """Left padding: the pad queries before a short text's first token see
    no key. Their attention output (o_proj's input) is exactly 0, as
    torch's SDPA gives transformers; the real rows equal the text run
    alone."""
    c = checkpoint.load_checkpoint(ckpt["qwen3-left"])
    model = checkpoint.build_model(c)
    tok = checkpoint.build_tokenizer(c)
    ids, mask = tok(["rust", " ".join(WORDS)], 512)
    n_pad = int((mask[0] == 0).sum())
    assert n_pad > 4
    seen = []
    hook = model.layers[0].self_attn.o_proj.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    try:
        with torch.no_grad():
            got = model(ids, mask)
    finally:
        hook.remove()
    assert bool((seen[0][0, :n_pad] == 0).all()) and bool(torch.isfinite(got).all())
    alone_ids, alone_mask = tok(["rust"], 512)
    with torch.no_grad():
        alone = model(alone_ids, alone_mask)
    assert float((got[0, n_pad:] - alone[0]).abs().max()) <= ATOL


def test_the_scale_is_a_float32_device_tensor(ckpt, monkeypatch):
    """head_dim ** -0.5 is a float32 tensor made on the forward's device
    (fault 3.4), and the scores take their scale from it."""
    scale = decoder.attention_scale(32, torch.device("cpu"))
    assert scale.dtype == torch.float32 and scale.shape == ()
    assert float(scale) == float(np.float32(32 ** -0.5))
    c = checkpoint.load_checkpoint(ckpt["qwen3-right"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(3, seed=2, lo=3), 512)
    with torch.no_grad():
        want = model(ids, mask)
        monkeypatch.setattr(decoder, "attention_scale",
                            lambda d, device: torch.full((), 2 * d ** -0.5, device=device))
        moved = model(ids, mask)
    assert float((moved - want).abs().max()) > 1e-3


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("kind", KINDS)
def test_encoder_matches_jax(ckpt, kind, side, pooling):
    """The JAX package's torch branch (no Flax Qwen2/Qwen3; Llama and
    Mistral from pytorch_model.bin, fault 3.17), pooled and normalized,
    texts of different lengths in one batch; under left padding
    `forceCls` takes a pad token's state for the short texts, in both."""
    path = ckpt[f"{kind}-{side}"]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__.lower().startswith(kind)
    assert jax_enc._tokenizer.padding_side == side
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    # mean pooling over Qwen2's token-less "" is 0 in both
    norms = np.linalg.norm(want, axis=1)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), np.where(norms > 0.5, 1.0, 0.0),
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["llama", "mistral"])
def test_fault_317_the_jax_flax_branch_raises_on_llama_safetensors(ckpt, kind):
    """From a model.safetensors, `FlaxAutoModel` loads Flax Llama (Mistral)
    and `module.apply(params, input_ids, attention_mask)` passes no
    position ids, so the rotary table is not sliced: `encode` raises, past
    `_load`'s fallback. The port reads the same file, and embeds as the
    JAX package's torch branch does from pytorch_model.bin."""
    texts = _texts(4, seed=5, lo=2)
    jax_enc = FlaxTextEncoder(ckpt[f"{kind}-st"], "useModel")
    with pytest.raises(TypeError, match="broadcast"):
        jax_enc.encode(texts)
    assert jax_enc._flax is not None
    want = FlaxTextEncoder(ckpt[f"{kind}-right"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt[f"{kind}-st"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_decoder_widths(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with Q at heads x head_dim (128, wider than the 64-wide model)
    and the gated MLP's 2 x intermediate_size counted (the arithmetic,
    with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["qwen3-right"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    assert heads * c["head_dim"] > c["hidden_size"]
    per_text = 4 * (3 * heads * L * L + L * (6 * heads * c["head_dim"]
                                             + 4 * c["intermediate_size"]))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt):
    """write_checkpoint's model.safetensors (DecoderModel's names) loads
    into transformers with nothing missing and computes the port's
    forward; AutoTokenizer reads its tokenizer files as the port does,
    left padding included."""
    ref, info = transformers.Qwen3Model.from_pretrained(ckpt["port"], output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert os.path.exists(os.path.join(ckpt["port"], "model.safetensors"))
    c = checkpoint.load_checkpoint(ckpt["port"])
    texts = _texts(5, seed=6) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    want = transformers.AutoTokenizer.from_pretrained(ckpt["port"])(
        texts, padding=True, truncation=True, max_length=512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    assert bool((mask[:, 0] == 0).any())
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL

