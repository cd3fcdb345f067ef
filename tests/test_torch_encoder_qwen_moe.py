"""Qwen2-MoE and Qwen3-MoE in the text encoder (K8): the port's
`qwen2_moe` and `qwen3_moe` model types (models/decoder.py over
models/moe.py's sparse block), their weight names, and the encoder
against transformers and the JAX package's `FlaxTextEncoder`.

Qwen2-MoE's block routes each token to its top 4 of the experts without
renormalizing them (`norm_topk_prob` false, Qwen2MoeConfig's default) and
adds a shared expert times `sigmoid(shared_expert_gate(x))`; its attention
is Qwen2's with biases on Q, K and V under `qkv_bias`, and its model builds
its own additive mask (`_update_causal_mask`), so a left pad, which sees no
key, takes the uniform average of every value on the CPU, where the
reference runs. Qwen3-MoE's block renormalizes under `norm_topk_prob`; its
attention is Qwen3's (Q/K norms). A layer takes the sparse block unless it
is in `mlp_only_layers` or off the `decoder_sparse_step`; the others take a
gated MLP at `intermediate_size`.

Nothing is downloaded. Tiny stacks (hidden 64, 4 heads of 16 over 2 KV
heads, 8 experts of 32, a shared expert of 80) are built from
transformers' config classes, their weights drawn with numpy from a seed
(the gates at 0.3, Q and K at 0.15, biases at 0.05, norm weights 1 +-
0.05), saved by transformers as model.safetensors beside
models/fixtures.py's seeded BPE in Qwen2's layout (`Qwen2TokenizerFast`
pads on the right by class default; `{name}-left` copies pad on the left).
No Flax class exists for either, so the JAX package's encoder runs
transformers' torch model (its AutoModel branch, `sdpa`). The port is held
against it within 1e-5 on normalized vectors, for both poolings and both
padding sides, and against `AutoModel` on every row of the last hidden
state, pad rows included."""

import copy
import json
import os

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
TEXTS = ["hello world", "", "😀 中文 é", "<|endoftext|> inside", "tab\there\nnew line"]
BPE_SIZE = 800
SMALL = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             moe_intermediate_size=32, num_experts=8, max_position_embeddings=2048)
CLASSES = {"qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeModel"),
           "qwen3_moe": ("Qwen3MoeConfig", "Qwen3MoeModel")}
# name -> (model type, config arguments)
CONFIGS = {
    # Qwen2-MoE's defaults: top 4 unnormalized, a shared expert, every layer sparse
    "qwen2_moe": ("qwen2_moe", dict(num_hidden_layers=2, num_experts_per_tok=4,
                                    shared_expert_intermediate_size=80)),
    # a sparse block on every second layer, the last one dense by
    # mlp_only_layers: only layer 1 of 4 is sparse; a window in every layer
    "qwen2_moe-steps": ("qwen2_moe", dict(
        num_hidden_layers=4, num_experts_per_tok=2, shared_expert_intermediate_size=80,
        decoder_sparse_step=2, mlp_only_layers=[3], use_sliding_window=True, sliding_window=6,
        max_window_layers=3)),
    # Qwen3-MoE renormalizing its top 4, Q/K norms, biases on the four
    # projections
    "qwen3_moe": ("qwen3_moe", dict(num_hidden_layers=2, num_experts_per_tok=4, head_dim=16,
                                    norm_topk_prob=True, attention_bias=True)),
    "qwen3_moe-steps": ("qwen3_moe", dict(
        num_hidden_layers=4, num_experts_per_tok=3, head_dim=16, norm_topk_prob=True,
        decoder_sparse_step=2, mlp_only_layers=[3], use_sliding_window=True, sliding_window=6)),
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


def _config(kind, vocab, **kwargs):
    cls = getattr(transformers, CLASSES[kind][0])
    return cls(**{**SMALL, "vocab_size": vocab, **copy.deepcopy(kwargs)})


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                draw = rng.normal(1.0, 0.05, tuple(p.shape))
            else:
                std = 0.3 if name.endswith("mlp.gate.weight") else 0.15 if (
                    "q_proj" in name or "k_proj" in name) else 0.05
                draw = rng.normal(0.0, std, tuple(p.shape))
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, spec, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.qwen2_tokenizer_config(spec, padding_side=side), f)


@pytest.fixture(scope="module")
def spec():
    return fixtures.qwen2_tokenizer_json(_texts(200, seed=1) + TEXTS[:3], BPE_SIZE, seed=26)


@pytest.fixture(scope="module")
def ckpt(spec, tmp_path_factory):
    """`{name}` for each of CONFIGS, right-padded (Qwen2TokenizerFast's
    default) as model.safetensors; `{name}-left` with padding_side left."""
    root = tmp_path_factory.mktemp("qwen_moe")
    out = {}
    for i, (name, (kind, kwargs)) in enumerate(CONFIGS.items()):
        model = getattr(transformers, CLASSES[kind][1])(
            _config(kind, len(spec["model"]["vocab"]), **kwargs))
        _draw_weights(model, 260 + i)
        for side in ("right", "left"):
            key = name if side == "right" else f"{name}-left"
            path = out[key] = str(root / key)
            model.save_pretrained(path)
            _tokenizer_files(path, spec, None if side == "right" else "left")
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert ref.config._attn_implementation == "sdpa"
    return ref


def _batch(path, texts):
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    return checkpoint.build_model(c), ids, mask


# -- config, layers and weights --------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_the_config_reads_as_transformers(ckpt, name):
    """Each layer takes the sparse block where the reference's does (and
    a gated MLP at intermediate_size elsewhere), with its experts, top-k,
    renormalization and shared expert; Q/K norms and biases as the type
    reads them; a window in every layer under use_sliding_window; and
    Qwen2TokenizerFast's right padding."""
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    ref = _reference(ckpt[name])
    want = ref.config
    kind = c.config["model_type"]
    assert isinstance(model, decoder.DecoderModel)
    for port, theirs in zip(model.layers, ref.layers):
        sparse = type(theirs.mlp).__name__.endswith("SparseMoeBlock")
        assert isinstance(port.mlp, moe.SparseMoeBlock) == sparse
        if sparse:
            block = port.mlp
            assert (len(block.experts), block.top_k, block.normalize, block.shared) == (
                want.num_experts, want.num_experts_per_tok, want.norm_topk_prob,
                kind == "qwen2_moe")
        else:
            assert isinstance(port.mlp, decoder.GatedMLP)
            assert port.mlp.gate_proj.weight.shape == theirs.mlp.gate_proj.weight.shape
        attn = port.self_attn
        assert attn.qk_norm == (kind == "qwen3_moe")
        assert (attn.q_proj.bias is not None) == (theirs.self_attn.q_proj.bias is not None)
        assert (attn.o_proj.bias is not None) == (theirs.self_attn.o_proj.bias is not None)
        assert attn.zero_unseen == (kind == "qwen3_moe")
    window = want.sliding_window
    assert model.config["window"] == window
    assert set(model.config["layer_types"]) == {
        "sliding_attention" if window else "full_attention"}
    tok = checkpoint.build_tokenizer(c)
    assert tok.padding_side == "right" and tok.pad == BPE_SIZE


@pytest.mark.parametrize("kind", ["qwen2_moe", "qwen3_moe"])
def test_defaults_fill_what_a_config_leaves_out(kind):
    """A config with only the widths resolves as the type's config class
    does (Qwen3MoeConfig's head_dim is hidden_size / heads, not Qwen3's
    128)."""
    heads = 16 if kind == "qwen2_moe" else 4  # over the default KV heads, 16 and 4
    widths = {"vocab_size": 100, "hidden_size": 64, "intermediate_size": 96,
              "num_hidden_layers": 3, "num_attention_heads": heads}
    got = decoder.check_config({"model_type": kind, **widths})
    want = getattr(transformers, CLASSES[kind][0])(**widths)
    keys = ["num_key_value_heads", "hidden_act", "rms_norm_eps", "rope_theta", "num_experts",
            "num_experts_per_tok", "moe_intermediate_size", "norm_topk_prob",
            "decoder_sparse_step", "mlp_only_layers", "use_sliding_window",
            "max_position_embeddings"]
    keys += ["shared_expert_intermediate_size", "qkv_bias"] if kind == "qwen2_moe" else [
        "attention_bias"]
    for key in keys:
        assert got[key] == getattr(want, key), key
    assert got["head_dim"] == 64 // heads and got["window"] is None


@pytest.mark.parametrize("kind, widths, experts, routed", [
    # Qwen/Qwen1.5-MoE-A2.7B: 60 experts of 3 x 2,048 x 1,408, a shared
    # expert of 3 x 2,048 x 5,632 and its 2,048-wide gate, Q, K and V with
    # biases over 16 heads of 128
    ("qwen2_moe", {"hidden_size": 2048, "intermediate_size": 5632, "num_attention_heads": 16,
                   "num_key_value_heads": 16, "vocab_size": 151_936}, 519_045_120, 4),
    # Qwen/Qwen3-30B-A3B: 128 experts of 3 x 2,048 x 768, 32 heads of 128
    # over 4 KV heads, Q/K norms
    ("qwen3_moe", {"hidden_size": 2048, "intermediate_size": 6144, "num_attention_heads": 32,
                   "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128,
                   "num_experts_per_tok": 8, "moe_intermediate_size": 768,
                   "norm_topk_prob": True, "vocab_size": 151_936}, 603_979_776, 8),
])
def test_the_published_widths(kind, widths, experts, routed):
    with torch.device("meta"):
        model = decoder.DecoderModel({"model_type": kind, "num_hidden_layers": 1, **widths})
    block = model.layers[0].mlp
    assert sum(p.numel() for p in block.experts.parameters()) == experts
    assert block.top_k == routed and block.normalize == (kind == "qwen3_moe")
    if kind == "qwen2_moe":
        assert block.shared_expert.gate_proj.weight.shape == (5632, 2048)
        assert block.shared_expert_gate.weight.shape == (1, 2048)
    else:
        assert model.layers[0].self_attn.q_proj.weight.shape == (4096, 2048)


# -- the forward and its traps -------------------------------------------------


@pytest.mark.parametrize("name", [f"{n}{s}" for n in CONFIGS for s in ("", "-left")])
def test_forward_matches_transformers_on_every_row(ckpt, name):
    """Padded batches of texts of 1 to 40 words: every row of the last
    hidden state, padded ones included (Qwen2-MoE's left pads the uniform
    average of every value, Qwen3-MoE's a zero attention output), equals
    AutoModel's default (sdpa) within ATOL."""
    texts = _texts(6, seed=9) + TEXTS
    model, ids, mask = _batch(ckpt[name], texts)
    with torch.no_grad():
        want = _reference(ckpt[name])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert int((mask == 0).sum()) > 0
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("kind", ["qwen2_moe", "qwen3_moe"])
def test_the_blocks_are_the_reference_s_bit_for_bit(ckpt, kind):
    """On the same input rows the port's block equals the reference's to
    the bit (top 4 summed in ascending expert order; Qwen2-MoE's shared
    expert added after), and the gate's logits are the reference's."""
    path = ckpt[kind]
    ref = _reference(path)
    port = checkpoint.build_model(checkpoint.load_checkpoint(path))
    x = torch.randn(5, 13, 64, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, logits = ref.layers[1].mlp(x)
        block = port.layers[1].mlp
        assert torch.equal(block(x), want)
        assert torch.equal(block.gate(x.reshape(-1, 64)), logits)


def test_the_qwen2_moe_traps_bite(ckpt):
    """Mutation guards on Qwen2-MoE: its top-4 weights are not divided by
    their sum, the shared expert is scaled by the sigmoid of its gate, and
    a left pad's attention output is the uniform average of the values,
    not 0; undoing any of them moves the last hidden state past BITES
    (the pads' rows for the last one)."""
    texts = _texts(6, seed=10) + TEXTS
    model, ids, mask = _batch(ckpt["qwen2_moe-left"], texts)
    with torch.no_grad():
        want = _reference(ckpt["qwen2_moe-left"])(input_ids=ids,
                                                  attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        blocks = [layer.mlp for layer in model.layers]
        for block in blocks:
            block.normalize = True
        assert float((model(ids, mask) - want).abs().max()) > BITES
        for block in blocks:
            block.normalize = False
        sigmoid = torch.sigmoid
        try:
            moe.torch.sigmoid = lambda x: x
            assert float((model(ids, mask) - want).abs().max()) > BITES
        finally:
            moe.torch.sigmoid = sigmoid
        for layer in model.layers:
            layer.self_attn.zero_unseen = True
        pads = mask == 0
        moved = (model(ids, mask) - want)[pads].abs().max()
        assert float(moved) > BITES
        assert float((model(ids, mask) - want)[~pads].abs().max()) <= ATOL


def test_qwen3_moe_renormalizes_under_norm_topk_prob(ckpt):
    """Mutation guard: Qwen3-MoE under norm_topk_prob divides its top-k
    weights by their sum; not dividing moves the last hidden state past
    BITES."""
    texts = _texts(6, seed=11) + TEXTS
    model, ids, mask = _batch(ckpt["qwen3_moe"], texts)
    with torch.no_grad():
        want = _reference(ckpt["qwen3_moe"])(input_ids=ids, attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        for layer in model.layers:
            layer.mlp.normalize = False
        assert float((model(ids, mask) - want).abs().max()) > BITES


@pytest.mark.parametrize("name", ["qwen2_moe-steps", "qwen3_moe-steps"])
def test_the_window_slides_every_layer(ckpt, name):
    """Under use_sliding_window the types' masks slide every layer,
    whatever max_window_layers says: one token more or less of reach moves
    the last hidden state past BITES."""
    model, ids, mask = _batch(ckpt[name], _texts(4, seed=14, lo=20))
    assert model.config["layer_types"] == ["sliding_attention"] * 4
    window = model.config["window"]
    with torch.no_grad():
        want = model(ids, mask)
        for moved in (-1, 1):
            model.config["window"] = window + moved
            assert float((model(ids, mask) - want).abs().max()) > BITES, moved


REFUSED = [
    ("qwen2_moe", {"num_experts_per_tok": 9}, "num_experts_per_tok"),
    ("qwen3_moe", {"num_experts_per_tok": 9}, "num_experts_per_tok"),
    ("qwen2_moe", {"head_dim": 32}, "head_dim"),
    ("qwen3_moe", {"hidden_act": "swiglu"}, "hidden_act"),
    ("qwen2_moe", {"decoder_sparse_step": 0}, "decoder_sparse_step"),
    ("qwen3_moe", {"partial_rotary_factor": 0.5}, "partial_rotary_factor"),
]


@pytest.mark.parametrize("kind, change, match", REFUSED)
def test_what_transformers_raises_on_is_refused_by_name(kind, change, match):
    """More experts a token than a sparse layer has (torch.topk raises), a
    Qwen2-MoE head_dim other than hidden_size / heads (its attention
    raises), an activation transformers does not know, a sparse step of 0
    (a modulo by zero) and a partial rotary: transformers raises on each;
    the port refuses each config by name."""
    raised = False
    try:
        config = _config(kind, 100, num_hidden_layers=1, **change)
        model = getattr(transformers, CLASSES[kind][1])(config).eval()
        ids = torch.arange(3, 15)[None]
        with torch.no_grad():
            model(input_ids=ids, attention_mask=torch.ones_like(ids))
    except (ValueError, RuntimeError, KeyError, ZeroDivisionError):
        raised = True
    assert raised
    config = {"model_type": kind, "num_hidden_layers": 1, "vocab_size": 100, **SMALL,
              **copy.deepcopy(change)}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


def test_a_dense_model_runs_without_experts():
    """num_experts 0 (or every layer in mlp_only_layers): no sparse block
    and no top-k test, as transformers builds its dense MLPs; a sparse
    step of 0 is never read then."""
    widths = {"vocab_size": 100, "num_hidden_layers": 2, **SMALL}
    for change in ({"num_experts": 0, "num_experts_per_tok": 9},
                   {"mlp_only_layers": [0, 1], "decoder_sparse_step": 0}):
        with torch.device("meta"):
            model = decoder.DecoderModel({"model_type": "qwen2_moe", **widths, **change})
        assert not any(isinstance(m, moe.SparseMoeBlock) for m in model.modules())


# -- the encoder -----------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["qwen2_moe", "qwen2_moe-left", "qwen2_moe-steps-left",
                                  "qwen3_moe", "qwen3_moe-left", "qwen3_moe-steps"])
def test_encoder_matches_jax(ckpt, name, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of
    different lengths in one batch, on both padding sides; under left
    padding `forceCls` takes a pad token's state (Qwen2-MoE's the uniform
    average), in both, and chunks of 3 are cut from the call's one padded
    batch (hazard 3.25)."""
    path = ckpt[name]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    kind = checkpoint.load_checkpoint(path).config["model_type"]
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == CLASSES[kind][1]
    assert type(jax_enc._tokenizer).__name__ == "Qwen2TokenizerFast"
    assert jax_enc._tokenizer.padding_side == ("left" if name.endswith("left") else "right")
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_shared_expert(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with Qwen2-MoE's routed rows (top 4, each expert's input and
    output rows and 2 x moe_intermediate_size) and its shared expert's 2 x
    shared_expert_intermediate_size counted (the arithmetic, with the
    device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["qwen2_moe"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads, h = enc.max_len, c["num_attention_heads"], c["hidden_size"]
    per_text = 4 * (3 * heads * L * L + L * (6 * h + 4 * c["intermediate_size"]))
    per_text += 4 * L * (4 * (2 * 32 + 2 * h) + 8 + 2 * 80)
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


@pytest.mark.parametrize("kind", ["qwen2_moe", "qwen3_moe"])
def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, spec, tmp_path, kind):
    """write_checkpoint's model.safetensors (the types' names) loads into
    transformers' model with nothing missing and computes the port's
    forward; AutoTokenizer reads its Qwen2Tokenizer files as the port
    does."""
    c = checkpoint.load_checkpoint(ckpt[f"{kind}-steps"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=spec)
    cls = getattr(transformers, CLASSES[kind][1])
    ref, info = cls.from_pretrained(path, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    c = checkpoint.load_checkpoint(path)
    assert c.tokenizer["tokenizer_class"] == "Qwen2Tokenizer"
    texts = _texts(5, seed=6) + TEXTS
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    want = transformers.AutoTokenizer.from_pretrained(path)(
        texts, padding=True, truncation=True, max_length=512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
