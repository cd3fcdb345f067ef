"""Mixtral in the text encoder (K8): the port's `mixtral` model type
(models/decoder.py over models/moe.py's sparse block: 8 experts of
`intermediate_size` a layer by default, the top 2 of a float32 softmax
renormalized, `w2(act(w1(x)) * w3(x))` per expert; Mistral's attention),
its weight names, and the encoder against transformers and the JAX
package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny stacks (hidden 64, 4 heads of 16 over 2 KV
heads, 6 experts of 48, top 2) are built from transformers'
`MixtralConfig`, their weights drawn with numpy from a seed (the gates at
0.3, so a token's experts are decided by a wide margin; Q and K at 0.15;
norm weights 1 +- 0.05), saved by transformers as model.safetensors beside
models/fixtures.py's seeded Llama-2 byte-fallback BPE (`LlamaTokenizerFast`
pads on the left by class default, `</s>` its pad). No Flax Mixtral
exists, so the JAX package's encoder runs transformers' torch model (its
AutoModel branch, `sdpa`). The port is held against it within 1e-5 on
normalized vectors, for both poolings and both padding sides, and against
`AutoModel` on every row of the last hidden state."""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, decoder, fixtures, hf_encoder, moe  # noqa: E402

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-4  # a trap undone must move the last hidden state this far (10 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文"]
TEXTS = ["hello world", "", "😀 中文 é", "<s> inside </s>", "tab\there\nnew line"]
SMALL = dict(hidden_size=64, intermediate_size=48, num_attention_heads=4, num_key_value_heads=2,
             num_local_experts=6, num_experts_per_tok=2, max_position_embeddings=2048)
# GritLM/GritLM-8x7B's config.json widths (Mixtral-8x7B's)
GRITLM_8X7B = {"model_type": "mixtral", "vocab_size": 32_000, "hidden_size": 4096,
               "intermediate_size": 14_336, "num_hidden_layers": 32, "num_attention_heads": 32,
               "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
               "hidden_act": "silu", "rms_norm_eps": 1e-5, "rope_theta": 1e6,
               "sliding_window": None, "max_position_embeddings": 32_768}
# name -> (config arguments, saved from MixtralForCausalLM)
CONFIGS = {
    "mixtral": (dict(num_hidden_layers=2), False),
    "mixtral-window": (dict(num_hidden_layers=2, sliding_window=5, num_experts_per_tok=3,
                            hidden_act="gelu"), False),
    "mixtral-lm": (dict(num_hidden_layers=3), True),
}


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


def _config(vocab, **kwargs):
    return transformers.MixtralConfig(**{**SMALL, "vocab_size": vocab, "pad_token_id": 2,
                                         **copy.deepcopy(kwargs)})


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                draw = rng.normal(1.0, 0.05, tuple(p.shape))
            else:
                std = 0.3 if name.endswith("moe.gate.weight") else 0.15 if (
                    "q_proj" in name or "k_proj" in name) else 0.05
                draw = rng.normal(0.0, std, tuple(p.shape))
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, spec, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.llama_tokenizer_config(spec, padding_side=side), f)


@pytest.fixture(scope="module")
def spec():
    return fixtures.llama_tokenizer_json(_texts(200, seed=1) + TEXTS[:3], 800, seed=25)


@pytest.fixture(scope="module")
def ckpt(spec, tmp_path_factory):
    """`{name}` for each of CONFIGS, left-padded (LlamaTokenizerFast's
    default) as model.safetensors; `{name}-right` with padding_side right."""
    root = tmp_path_factory.mktemp("mixtral")
    out = {}
    for i, (name, (kwargs, causal_lm)) in enumerate(CONFIGS.items()):
        cls = transformers.MixtralForCausalLM if causal_lm else transformers.MixtralModel
        model = cls(_config(len(spec["model"]["vocab"]), **kwargs))
        _draw_weights(model, 250 + i)
        for side in ("left", "right"):
            key = name if side == "left" else f"{name}-right"
            path = out[key] = str(root / key)
            model.save_pretrained(path)
            _tokenizer_files(path, spec, None if side == "left" else "right")
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert ref.config._attn_implementation == "sdpa"
    return ref


def _forward(path, texts):
    """(port, reference, mask, port model): the last hidden states of
    `texts` in one padded batch."""
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    model = checkpoint.build_model(c)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    return got, want, mask, model


# -- config, layers and weights --------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_the_config_reads_as_transformers(ckpt, name):
    """DecoderModel with the sparse block in every layer under Mixtral's
    `block_sparse_moe` (its experts, top-k, renormalized, no shared
    expert), Mistral's attention (a window in every layer iff the config
    has one, no biases, no Q/K norms), and LlamaTokenizerFast's left
    padding."""
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[name])
    assert isinstance(model, decoder.DecoderModel)
    assert model.config["window"] == want.sliding_window
    kinds = {"sliding_attention" if want.sliding_window else "full_attention"}
    assert set(model.config["layer_types"]) == kinds
    for layer in model.layers:
        block = layer.block_sparse_moe
        assert isinstance(block, moe.SparseMoeBlock) and not hasattr(layer, "mlp")
        assert (len(block.experts), block.top_k, block.normalize, block.shared) == (
            want.num_local_experts, want.num_experts_per_tok, True, False)
        attn = layer.self_attn
        assert attn.q_proj.bias is None and attn.o_proj.bias is None and not attn.qk_norm
        assert attn.zero_unseen
    tok = checkpoint.build_tokenizer(c)
    assert tok.byte_fallback and tok.padding_side == "left" and tok.pad == 2


def test_the_published_gritlm_8x7b_widths():
    """GritLM-8x7B (Mixtral-8x7B): a layer holds 8 experts of 3 x 4,096 x
    14,336 (1.409B weights) and 41.9M attention weights (Q and O 4,096 x
    4,096, K and V 1,024 x 4,096: 8 KV heads of 128), 5.80 GB in float32;
    no window in any layer."""
    config = decoder.check_config(GRITLM_8X7B)
    assert config["window"] is None and config["head_dim"] == 128
    assert set(config["layer_types"]) == {"full_attention"}
    with torch.device("meta"):
        model = decoder.DecoderModel({**GRITLM_8X7B, "num_hidden_layers": 1})
    layer = model.layers[0]
    experts = sum(p.numel() for p in layer.block_sparse_moe.experts.parameters())
    attn = sum(p.numel() for p in layer.self_attn.parameters())
    gate = layer.block_sparse_moe.gate.weight.numel()
    assert (experts, attn, gate) == (1_409_286_144, 41_943_040, 32_768)
    assert 4 * (experts + attn) // 10**7 == 580  # 5.80 GB


def test_defaults_fill_what_a_config_leaves_out():
    """A config with only the widths resolves as MixtralConfig does."""
    widths = {"vocab_size": 100, "hidden_size": 64, "intermediate_size": 96,
              "num_hidden_layers": 3, "num_attention_heads": 8}
    got = decoder.check_config({"model_type": "mixtral", **widths})
    want = transformers.MixtralConfig(**widths)
    for key in ("num_key_value_heads", "hidden_act", "rms_norm_eps", "rope_theta",
                "sliding_window", "num_local_experts", "num_experts_per_tok",
                "max_position_embeddings", "router_jitter_noise", "output_router_logits"):
        assert got[key] == getattr(want, key), key
    assert got["head_dim"] == 8 and got["window"] is None


def test_a_causal_lm_file_loads_under_the_model_names(ckpt):
    """A MixtralForCausalLM file (`model.` names, `lm_head.`): the experts
    load as `layers.{i}.block_sparse_moe.experts.{j}.w1/w2/w3` and
    lm_head is dropped."""
    path = ckpt["mixtral-lm"]
    lm = transformers.MixtralForCausalLM.from_pretrained(path).state_dict()
    assert "lm_head.weight" in lm
    c = checkpoint.load_checkpoint(path)
    assert set(c.state_dict) == {k.removeprefix("model.") for k in lm if k != "lm_head.weight"}
    assert tuple(c.state_dict["layers.2.block_sparse_moe.experts.5.w2.weight"].shape) == (64, 48)


# -- the forward and its traps -------------------------------------------------


@pytest.mark.parametrize("name", [f"{n}{s}" for n in CONFIGS for s in ("", "-right")])
def test_forward_matches_transformers_on_every_row(ckpt, name):
    """Padded batches of texts of 1 to 40 words: every row of the last
    hidden state, padded ones included, equals AutoModel's default (sdpa)
    within ATOL."""
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask, _model = _forward(ckpt[name], texts)
    side = "right" if name.endswith("right") else "left"
    assert int((mask == 0).sum()) > 0
    assert bool((mask[:, -1 if side == "left" else 0] == 1).all())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_the_routing_is_the_reference_s_bit_for_bit(ckpt):
    """On the same input rows the port's block equals the reference's
    MixtralSparseMoeBlock to the bit (the gathered rows in its order, the
    sums in ascending expert order), and its gate logits are the ones the
    reference returns."""
    path = ckpt["mixtral-window"]
    ref = _reference(path)
    port = checkpoint.build_model(checkpoint.load_checkpoint(path))
    x = torch.randn(5, 13, 64, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, logits = ref.layers[1].block_sparse_moe(x)
        block = port.layers[1].block_sparse_moe
        assert torch.equal(block(x), want)
        assert torch.equal(block.gate(x.reshape(-1, 64)), logits)
        weights, chosen = block.route(x.reshape(-1, 64))
    assert chosen.shape == (65, 3) and torch.allclose(weights.sum(-1), torch.ones(65))


def test_the_renormalization_and_the_expert_names_bite(ckpt):
    """Mutation guards: Mixtral's top-k weights divided by their sum, and
    `w1` the gate, `w3` the up projection; dropping the renormalization or
    swapping w1 and w3 moves the last hidden state past BITES."""
    texts = _texts(6, seed=10) + TEXTS
    path = ckpt["mixtral"]
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    model = checkpoint.build_model(c)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        for layer in model.layers:
            layer.block_sparse_moe.normalize = False
        assert float((model(ids, mask) - want).abs().max()) > BITES
        for layer in model.layers:
            layer.block_sparse_moe.normalize = True
            for expert in layer.block_sparse_moe.experts:
                expert.w1, expert.w3 = expert.w3, expert.w1
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_the_window_slides_every_layer(ckpt):
    """MixtralConfig's window holds in every layer: one token more or less
    of reach moves the last hidden state past BITES on texts longer than
    it."""
    c = checkpoint.load_checkpoint(ckpt["mixtral-window"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=14, lo=20), 512)
    assert model.config["layer_types"] == ["sliding_attention"] * 2
    window = model.config["window"]
    with torch.no_grad():
        want = model(ids, mask)
        for moved in (-1, 1):
            model.config["window"] = window + moved
            assert float((model(ids, mask) - want).abs().max()) > BITES, moved


def test_training_only_settings_are_read_as_eval_reads_them(ckpt, tmp_path):
    """router_jitter_noise and output_router_logits act only in training or
    on outputs the encoder drops: a config that sets them runs as one
    that does not."""
    import shutil

    path = str(tmp_path / "jitter")
    shutil.copytree(ckpt["mixtral"], path)
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    config.update(router_jitter_noise=0.5, output_router_logits=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    texts = _texts(5, seed=15) + TEXTS
    got, want, _mask, _model = _forward(path, texts)
    assert float((got - want).abs().max()) <= ATOL


REFUSED = [
    ({"num_experts_per_tok": 7}, "num_experts_per_tok"),
    ({"hidden_act": "swiglu"}, "hidden_act"),
    ({"partial_rotary_factor": 0.5}, "partial_rotary_factor"),
    ({"rope_scaling": {"rope_type": "dynamic", "factor": 2.0}}, "rope_scaling"),
]


@pytest.mark.parametrize("change, match", REFUSED)
def test_what_transformers_raises_on_is_refused_by_name(spec, change, match):
    """More experts a token than the layer has (torch.topk raises), an
    activation transformers does not know, a partial rotary (the tables
    do not fit the head) and a rope_scaling whose tables read MixtralConfig's
    stored head_dim of None: transformers raises on each; the port refuses
    each config by name."""
    vocab = len(spec["model"]["vocab"])
    try:
        model = transformers.MixtralModel(_config(vocab, num_hidden_layers=1, **change)).eval()
        ids = torch.arange(3, 15)[None]
        with torch.no_grad():
            model(input_ids=ids, attention_mask=torch.ones_like(ids))
        raised = False
    except (ValueError, RuntimeError, KeyError, TypeError):
        raised = True
    assert raised
    config = {"model_type": "mixtral", "num_hidden_layers": 1, "vocab_size": vocab, **SMALL,
              **copy.deepcopy(change)}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


# -- the encoder -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["mixtral", "mixtral-right", "mixtral-window", "mixtral-lm"])
def test_encoder_matches_jax(ckpt, name, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of
    different lengths in one batch; under left padding `forceCls` takes a
    pad token's state for the short texts, in both, and chunks of 3 are
    cut from the call's one padded batch (hazard 3.25)."""
    path = ckpt[name]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "MixtralModel"
    assert jax_enc._torch.config._attn_implementation == "sdpa"
    assert type(jax_enc._tokenizer).__name__ == "LlamaTokenizerFast"
    assert jax_enc._tokenizer.padding_side == ("right" if name.endswith("right") else "left")
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_routed_rows(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with the sparse block's routed rows counted: up to
    num_experts_per_tok x L a text, each expert's gathered input and
    output rows and its 2 x intermediate_size activation, and the gate's
    logits (the arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["mixtral"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads, h = enc.max_len, c["num_attention_heads"], c["hidden_size"]
    per_text = 4 * (3 * heads * L * L + L * (6 * max(h, heads * c["head_dim"])
                                             + 4 * c["intermediate_size"]))
    per_text += 4 * L * (2 * (2 * c["intermediate_size"] + 2 * h) + 6)
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


def test_the_chip_script_counts_the_routed_work_only(ckpt):
    """chip_smoke.py's bound counts of a sparse block: a token runs the
    gate and its num_experts_per_tok experts, not the other ones; the
    count before charged every Linear weight on every token
    (`projection_weights`), here 3x the routed experts' work."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    model = checkpoint.build_model(checkpoint.load_checkpoint(ckpt["mixtral-lm"]))
    n, L, layers, h = 4, 16, 3, 64
    expert = 3 * 64 * 48
    attention = 2 * 64 * 64 + 2 * 32 * 64  # Q and O, K and V over 2 KV heads of 16
    routed = layers * (attention + 6 * 64 + 2 * expert)
    assert chip_smoke.routed_weights(model) == routed
    assert chip_smoke.projection_weights(model) == routed + layers * 4 * expert
    scores = 4 * L * L * h * layers * n
    assert chip_smoke.encoder_flops(model, n, L) == 2 * routed * n * L + scores
    old = 2 * chip_smoke.projection_weights(model) * n * L + scores
    assert old - chip_smoke.encoder_flops(model, n, L) == 2 * layers * 4 * expert * n * L
    # a query reads the experts its tokens hit: here 5 of 6 in each layer
    assert chip_smoke.routed_weights(model, [5, 5, 5]) == routed + layers * 3 * expert


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, spec, tmp_path):
    """write_checkpoint's model.safetensors (Mixtral's names) loads into
    transformers' MixtralModel with nothing missing and computes the
    port's forward; AutoTokenizer reads its LlamaTokenizer files as the
    port does."""
    c = checkpoint.load_checkpoint(ckpt["mixtral-window"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=spec)
    assert os.path.exists(os.path.join(path, "model.safetensors"))
    ref, info = transformers.MixtralModel.from_pretrained(path, output_loading_info=True)
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
