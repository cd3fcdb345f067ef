"""GPT-NeoX in the text encoder (K8): the port's `gpt_neox` model type
(models/gpt_neox.py: the fused QKV laid out per head, a partial rotary,
the parallel or sequential residual), GPT-NeoX's tokenizer class
(models/bpe.py), the weight names of one file and of shards, and the
encoder against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny GPT-NeoXs (hidden 64, 4 heads of 16 with 4
rotated channels at rotary_pct 0.25, intermediate 96, 2 layers) are
built from transformers' `GPTNeoXConfig`, their weights drawn with numpy
from a seed (the QKV projection at 0.15, so attention is peaked and a
wrong split or rotary shows), and saved beside a seeded byte-level BPE in
GPT-NeoX-20B's layout (`fixtures.gpt_neox_tokenizer_json`: NFC,
`<|endoftext|>` and `<|padding|>`, the space runs; `<|padding|>` the pad,
right or left as tokenizer_config.json says). There is no Flax GPT-NeoX,
so the JAX package's encoder runs transformers' torch `GPTNeoXModel`
under its default `sdpa`. The port is held against it on every row of
the last hidden state, padded rows included, and on normalized vectors,
within ATOL (1e-5), under both poolings, both padding sides and both
residual forms."""

import json
import os
import re
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
    gpt_neox,
    hf_encoder,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-3  # a trap undone must move the last hidden state this far (100 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文", "x.y"]
TEXTS = ["hello world", "", "😀 中文 é", "<|endoftext|> inside <|padding|>",
         " ".join(WORDS * 3), "x  y\tz\nnew line      wide", "it's we'll DON'T"]
SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=96,
             rotary_pct=0.25, max_position_embeddings=512)
# BMRetriever/BMRetriever-410M's widths: EleutherAI/pythia-410m's config.json
# as recalled (not read from a file)
PYTHIA_410M = {"model_type": "gpt_neox", "vocab_size": 50304, "hidden_size": 1024,
               "num_hidden_layers": 24, "num_attention_heads": 16, "intermediate_size": 4096,
               "rotary_pct": 0.25, "rotary_emb_base": 10000, "max_position_embeddings": 2048,
               "use_parallel_residual": True, "layer_norm_eps": 1e-5, "hidden_act": "gelu",
               "tie_word_embeddings": False}


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


SPEC = fixtures.gpt_neox_tokenizer_json(_texts(200, seed=1) + TEXTS, 700, seed=2)
VOCAB_SIZE = len(SPEC["model"]["vocab"])


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
            sd = 0.15 if "query_key_value.weight" in name else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if "layernorm" in name.lower() and name.endswith("weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, side=None, **changes):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(SPEC, f, ensure_ascii=False)
    config = {**fixtures.gpt_neox_tokenizer_config(SPEC, padding_side=side), **changes}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


def _config(**changes):
    return transformers.GPTNeoXConfig(vocab_size=VOCAB_SIZE, **{**SMALL, **changes})


def _causal_lm_state(lm):
    """A GPTNeoXForCausalLM's state_dict as older Pythia files hold it: with
    each layer's stale `attention.bias`, `attention.masked_bias` and
    `attention.rotary_emb.inv_freq` buffers."""
    state = dict(lm.state_dict())
    for i in range(lm.config.num_hidden_layers):
        at = f"gpt_neox.layers.{i}.attention."
        state[at + "bias"] = torch.tril(torch.ones(1, 1, 16, 16, dtype=torch.bool))
        state[at + "masked_bias"] = torch.tensor(-1e9)
        state[at + "rotary_emb.inv_freq"] = lm.gpt_neox.rotary_emb.inv_freq.clone()
    return state


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`left` and `right`: one GPTNeoXModel (parallel residual), padded as
    named; `seq-left` and `seq-right`: another with the sequential
    residual; `lm`: a GPTNeoXForCausalLM's pytorch_model.bin (`gpt_neox.`
    prefix, `embed_out.`, the stale buffers); `shards`: the same model as
    model.safetensors shards and their index."""
    root = tmp_path_factory.mktemp("gpt_neox")
    out = {}
    for name, parallel in (("", True), ("seq-", False)):
        model = transformers.GPTNeoXModel(_config(use_parallel_residual=parallel))
        _draw_weights(model, 40 + parallel)
        for side in ("left", "right"):
            path = out[name + side] = str(root / (name + side))
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, side)
    lm = transformers.GPTNeoXForCausalLM(_config())
    _draw_weights(lm, 42)
    path = out["lm"] = str(root / "lm")
    lm.save_pretrained(path, safe_serialization=False)
    torch.save(_causal_lm_state(lm), os.path.join(path, "pytorch_model.bin"))
    _tokenizer_files(path)
    path = out["shards"] = str(root / "shards")
    lm.save_pretrained(path, max_shard_size="60KB")
    _tokenizer_files(path)
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "GPTNeoXModel" and ref.config._attn_implementation == "sdpa"
    return ref


def _forward(path, texts, model=None):
    """(port, reference, mask): the last hidden states of `texts` in one
    padded batch (`model`: the port's module, else the checkpoint's)."""
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = (model or checkpoint.build_model(c))(ids, mask)
    return got, want, mask


# -- config, module and weights ---------------------------------------------------


def test_the_config_reads_as_transformers(ckpt):
    """Head width, rotated channels and residual form as GPTNeoXConfig and
    its attention hold them, and GPT-NeoX's tokenizer read as a byte-level
    BPE with nothing added around the text and `<|padding|>` the pad."""
    for name, parallel in (("left", True), ("seq-right", False)):
        c = checkpoint.load_checkpoint(ckpt[name])
        model = checkpoint.build_model(c)
        ref = _reference(ckpt[name])
        assert isinstance(model, gpt_neox.GPTNeoXModel)
        assert model.config["head_dim"] == ref.layers[0].attention.head_size == 16
        assert model.config["rotary_dim"] == ref.layers[0].attention.rotary_ndims == 4
        assert model.config["use_parallel_residual"] is ref.config.use_parallel_residual \
            is parallel
        assert all(layer.parallel is parallel for layer in model.layers)
        tok = checkpoint.build_tokenizer(c)
        assert isinstance(tok, bpe.BPE) and tok.padding_side == name.split("-")[-1]
        assert (tok.before, tok.after, tok.pad) == ([], [], 1)


def test_the_published_bmretriever_410m_widths():
    """BMRetriever-410M (Pythia-410M): 24 layers of 1,024, 16 heads of 64
    with 16 rotated channels, intermediate 4,096; the module's names and
    shapes are GPTNeoXModel's, 353,822,720 parameters without the causal
    LM's 51,511,296-parameter `embed_out`."""
    config = gpt_neox.check_config(PYTHIA_410M)
    assert (config["head_dim"], config["rotary_dim"]) == (64, 16)
    with torch.device("meta"):
        ours = gpt_neox.GPTNeoXModel(PYTHIA_410M).state_dict()
        theirs = transformers.GPTNeoXModel(transformers.GPTNeoXConfig(
            **{k: v for k, v in PYTHIA_410M.items() if k != "model_type"})).state_dict()
    assert set(ours) == set(theirs) and all(ours[k].shape == theirs[k].shape for k in ours)
    assert sum(v.numel() for v in ours.values()) == 353_822_720
    linear = sum(v.numel() for k, v in ours.items()
                 if k.endswith("weight") and v.dim() == 2 and not k.startswith("embed_in"))
    assert linear == 24 * 12 * 1024 * 1024 == 301_989_888


def test_defaults_resolve_as_gptneoxconfig():
    """A config with only its type resolves as GPTNeoXConfig; `rotary_pct`
    and `rotary_emb_base` win over config.json's `partial_rotary_factor`
    and `rope_theta`, as GPTNeoXConfig sets those after its keywords."""
    got = gpt_neox.check_config({"model_type": "gpt_neox"})
    want = transformers.GPTNeoXConfig()
    for key in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "hidden_act", "rotary_pct", "rotary_emb_base",
                "max_position_embeddings", "layer_norm_eps", "use_parallel_residual",
                "attention_bias"):
        assert got[key] == getattr(want, key), key
    kwargs = dict(SMALL, vocab_size=100, rotary_pct=0.5, partial_rotary_factor=0.25,
                  rotary_emb_base=500, rope_theta=10000.0)
    want = transformers.GPTNeoXModel(transformers.GPTNeoXConfig(**kwargs))
    got = gpt_neox.check_config({"model_type": "gpt_neox", **kwargs})
    assert got["rotary_dim"] == 2 * want.rotary_emb.inv_freq.numel() == 8
    model = gpt_neox.GPTNeoXModel({"model_type": "gpt_neox", **kwargs})
    assert model.rope.theta == want.config.rope_theta == 500
    assert torch.equal(model.rope.inv_freq(8)[0], want.rotary_emb.inv_freq)


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """GPTNeoXForCausalLM's names (`gpt_neox.` prefix, `embed_out.`) and
    the stale buffers of older files map onto the port's module; the
    buffers and the head are dropped, not loaded."""
    raw = torch.load(os.path.join(ckpt["lm"], "pytorch_model.bin"), weights_only=True)
    for name in ("embed_out.weight", "gpt_neox.layers.1.attention.masked_bias",
                 "gpt_neox.layers.1.attention.bias",
                 "gpt_neox.layers.1.attention.rotary_emb.inv_freq"):
        assert name in raw, name
    c = checkpoint.load_checkpoint(ckpt["lm"])
    with torch.device("meta"):
        names = set(gpt_neox.GPTNeoXModel(c.config).state_dict())
    assert set(c.state_dict) == names and "layers.0.attention.query_key_value.bias" in names
    got, want, _mask = _forward(ckpt["lm"], _texts(4, seed=3) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_shards_read_as_the_one_file(ckpt):
    """The same GPTNeoXForCausalLM as model.safetensors shards and their
    index: every tensor read, the same state as the one file's."""
    assert "model.safetensors.index.json" in os.listdir(ckpt["shards"])
    sharded = checkpoint.load_checkpoint(ckpt["shards"]).state_dict
    one = checkpoint.load_checkpoint(ckpt["lm"]).state_dict
    assert set(sharded) == set(one) and all(torch.equal(sharded[k], one[k]) for k in one)
    got, want, _mask = _forward(ckpt["shards"], TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_a_name_the_module_lacks_is_not_loaded_quietly(ckpt, tmp_path):
    """build_model loads strictly: a tensor no rule maps raises."""
    path = str(tmp_path / "odd")
    shutil.copytree(ckpt["lm"], path)
    state = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
    state["gpt_neox.layers.0.attention.query_key_value.scale"] = torch.ones(3)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    with pytest.raises(RuntimeError, match="query_key_value.scale"):
        checkpoint.build_model(checkpoint.load_checkpoint(path))


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, tmp_path):
    """write_checkpoint's pytorch_model.bin and GPT-NeoX's tokenizer files
    load into GPTNeoXModel and AutoTokenizer with nothing missing."""
    c = checkpoint.load_checkpoint(ckpt["right"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=SPEC)
    ref, info = transformers.AutoModel.from_pretrained(path, output_loading_info=True)
    assert type(ref).__name__ == "GPTNeoXModel"
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert "pytorch_model.bin" in os.listdir(path)
    tok = transformers.AutoTokenizer.from_pretrained(path)
    assert type(tok).__name__ == "GPTNeoXTokenizerFast" and tok.pad_token == "<|padding|>"


REFUSED = [
    ({"num_attention_heads": 5}, "hidden_size is not a multiple of num_attention_heads"),
    ({"rotary_pct": 1.5}, "does not hold the rotary tables' 24 channels \\(rotary_pct 1.5\\)"),
    ({"rope_scaling": {"rope_type": "ntk"}}, "its rope_type `ntk` is not one of"),
    ({"rope_scaling": {"rope_type": "linear"}}, "lacks \\['factor'\\]"),
]


@pytest.mark.parametrize("change, match", REFUSED)
def test_what_transformers_raises_on_is_refused_by_name(change, match):
    config = {"model_type": "gpt_neox", "vocab_size": 100, **SMALL, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)
    with pytest.raises((ValueError, RuntimeError, KeyError)):
        model = transformers.GPTNeoXModel(transformers.GPTNeoXConfig(
            **{k: v for k, v in config.items() if k != "model_type"}))
        model(input_ids=torch.ones((1, 5), dtype=torch.int64))


def test_an_activation_outside_the_ports_list_is_refused():
    """`gelu_10` is transformers' clipped GELU, which the port does not run
    (the port's choice, as for every family)."""
    config = {"model_type": "gpt_neox", "vocab_size": 100, **SMALL, "hidden_act": "gelu_10"}
    with pytest.raises(ValueError, match="hidden_act `gelu_10`"):
        checkpoint.check_config(config)


@pytest.mark.parametrize("scaling", [
    {"rope_type": "linear", "factor": 2.0},
    {"type": "dynamic", "factor": 2.0},
    {"rope_type": "yarn", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 8},
])
def test_a_scaled_rotary_matches_transformers(scaling):
    """GPTNeoXConfig validates transformers' rope types; the port computes
    each through models/rope.py over the rotated channels (`dynamic` past
    its 16 positions takes the batch's length)."""
    config = _config(rope_scaling=dict(scaling), max_position_embeddings=16)
    ref = transformers.GPTNeoXModel(config).eval()
    _draw_weights(ref, 43)
    port = gpt_neox.GPTNeoXModel({"model_type": "gpt_neox", **SMALL, "vocab_size": VOCAB_SIZE,
                                  "rope_scaling": dict(scaling), "max_position_embeddings": 16})
    port.load_state_dict(ref.state_dict(), strict=False)
    ids = torch.from_numpy(np.random.default_rng(5).integers(2, VOCAB_SIZE, (3, 40)))
    mask = torch.ones_like(ids)
    mask[1, 30:] = 0
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = port(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


# -- the forward and its traps ----------------------------------------------------


@pytest.mark.parametrize("name", ["left", "right", "seq-left", "seq-right"])
def test_forward_matches_transformers_on_every_row(ckpt, name):
    """Padded batches of texts of 0 to 30 words: every row of the last
    hidden state, the padded ones too (a left pad sees no key: its
    attention gives 0, as sdpa's), equals AutoModel's within ATOL."""
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(ckpt[name], texts)
    assert int((mask == 0).sum()) > 0
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def _block_split(self, x, blocked, cos, sin, scale):
    """The trap: `query_key_value` split Phi-3's way, Q's block, then K's,
    then V's."""
    B, L, h = x.shape
    d = self.head_dim
    q, k, v = (t.view(B, L, self.heads, d).transpose(1, 2)
               for t in self.query_key_value(x).split(h, dim=-1))
    q, k = decoder.rotate(q, cos, sin), decoder.rotate(k, cos, sin)
    return self.dense(decoder.attend(q, k, v, blocked, scale))


def test_the_fused_qkv_is_split_per_head(ckpt, monkeypatch):
    """Mutation guard: each head's Q, K and V lie side by side in
    `query_key_value`'s output. The port equals the reference; split as
    Phi-3's blocks it moves past BITES."""
    texts = _texts(6, seed=10, lo=5) + TEXTS
    got, want, _mask = _forward(ckpt["right"], texts)
    assert float((got - want).abs().max()) <= ATOL
    monkeypatch.setattr(gpt_neox._Attention, "forward", _block_split)
    got, want, _mask = _forward(ckpt["right"], texts)
    assert float((got - want).abs().max()) > BITES


@pytest.mark.parametrize("rotated", [0, 2, 8, 16])
def test_the_rotary_covers_int_head_size_times_rotary_pct(ckpt, rotated):
    """Mutation guard: the rotary turns int(16 x 0.25) = 4 channels of each
    head. The port equals the reference; any other width moves past
    BITES."""
    texts = _texts(6, seed=11, lo=5) + TEXTS
    c = checkpoint.load_checkpoint(ckpt["right"])
    model = checkpoint.build_model(c)
    got, want, _mask = _forward(ckpt["right"], texts, model)
    assert float((got - want).abs().max()) <= ATOL
    model.rope = gpt_neox.Rope("default", 10000.0, rotated)
    got, want, _mask = _forward(ckpt["right"], texts, model)
    assert float((got - want).abs().max()) > BITES


@pytest.mark.parametrize("name", ["right", "seq-right"])
def test_the_residual_form_follows_use_parallel_residual(ckpt, name):
    """Mutation guard: `x + attn(ln1(x)) + mlp(ln2(x))` under
    use_parallel_residual, else `h = x + attn(ln1(x)); h + mlp(ln2(h))`.
    The port equals the reference in each form; the other form moves past
    BITES."""
    texts = _texts(6, seed=12, lo=5) + TEXTS
    c = checkpoint.load_checkpoint(ckpt[name])
    model = checkpoint.build_model(c)
    got, want, _mask = _forward(ckpt[name], texts, model)
    assert float((got - want).abs().max()) <= ATOL
    for layer in model.layers:
        layer.parallel = not layer.parallel
    got, want, _mask = _forward(ckpt[name], texts, model)
    assert float((got - want).abs().max()) > BITES


def test_a_left_pad_sees_no_key_and_gives_zero_attention(ckpt, monkeypatch):
    """`zero_unseen`, decided against the reference: under sdpa on the CPU
    a left pad's attention output is 0 (its state `dense`'s bias through
    the residual), and forceCls pools that state. The uniform average an
    additive mask gives (`eager`'s) moves the pad rows past BITES."""
    texts = _texts(6, seed=13, lo=5) + TEXTS
    got, want, mask = _forward(ckpt["left"], texts)
    pads = mask == 0
    assert int(pads.sum()) > 0
    assert float((got[pads] - want[pads]).abs().max()) <= ATOL
    monkeypatch.setattr(gpt_neox, "attend",
                        lambda *args: decoder.attend(*args, zero_unseen=False))
    got, want, mask = _forward(ckpt["left"], texts)
    assert float((got[pads] - want[pads]).abs().max()) > BITES
    assert float((got[~pads] - want[~pads]).abs().max()) <= ATOL


def test_positions_count_from_the_padded_start(ckpt, monkeypatch):
    """Mutation guard on the positions: the reference rotates every row of
    a left-padded batch at positions 0..L-1 (`position_ids` is
    `cache_position`: one (1, L) row, not one a text from the mask), and
    so does the port (one (1, 1, L, 4) table shared by every row). The
    rotary being relative, the real rows show it only in rounding: the
    trap is on the positions themselves."""
    c = checkpoint.load_checkpoint(ckpt["left"])
    ids, mask = checkpoint.build_tokenizer(c)(["rust", " ".join(WORDS * 2)], 512)
    L = ids.shape[1]
    assert int(mask[0].sum()) < L  # the short text is left-padded
    ref = _reference(ckpt["left"])
    seen = []
    ref.rotary_emb.register_forward_pre_hook(lambda _m, args: seen.append(args[1].clone()))
    tables = []
    rotate = gpt_neox.rotate
    monkeypatch.setattr(gpt_neox, "rotate",
                        lambda x, cos, sin: tables.append(cos.shape) or rotate(x, cos, sin))
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
    assert [p.tolist() for p in seen] == [[list(range(L))]]
    assert set(tables) == {torch.Size([1, 1, L, 4])}


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_left_padded_chunks_are_cut_from_one_batch(ckpt, pooling, monkeypatch):
    """Mutation guard: under left padding every chunk of 3 is cut from the
    call's one padded batch, as the JAX package pads (each forward sees
    the call's longest length); the vectors equal the JAX package's."""
    texts = ["rust", "hello world", "café"] + _texts(5, seed=17, lo=20) + ["中文"] * 3
    want = FlaxTextEncoder(ckpt["left"], pooling).encode(texts)
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    enc = hf_encoder.TextEncoder(ckpt["left"], pooling, device=None)
    enc._load()
    lengths = []
    enc._model.register_forward_pre_hook(lambda _m, args: lengths.append(args[0].shape[1]))
    got = enc.encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL
    longest = enc.tokenize(texts)[0].shape[1]
    assert lengths == [longest] * 4


# -- the encoder ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["left", "right", "seq-left", "seq-right"])
def test_encoder_matches_jax(ckpt, name, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of 0 to
    30 words in one call, both residual forms, both padding sides."""
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt[name], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "GPTNeoXModel"
    assert type(jax_enc._tokenizer).__name__ == "GPTNeoXTokenizerFast"
    assert jax_enc._tokenizer.padding_side == name.split("-")[-1]
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[name], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_parallel_residual(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with the not-gated MLP once and, under the parallel residual,
    two more hidden-wide activations counted (the arithmetic, with the
    device's free memory faked); the sequential form counts none."""
    for name, extra in (("right", 2), ("seq-right", 0)):
        enc = hf_encoder.TextEncoder(ckpt[name], "useModel", device=None)
        enc._load()
        c = enc._model.config
        L, heads, h = enc.max_len, c["num_attention_heads"], c["hidden_size"]
        per_text = 4 * (3 * heads * L * L + L * ((6 + extra) * h + 2 * c["intermediate_size"]))
        free = 40 * per_text * 4 + 3
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
        enc.device = torch.device("cuda", 0)
        assert enc.chunk_texts() == 40, name


# -- GPT-NeoX's tokenizer ---------------------------------------------------------


@pytest.mark.parametrize("layout", ["right", "left", "bos", "bos-eos", "no-flags"])
def test_tokenizer_matches_autotokenizer(ckpt, layout, tmp_path):
    """Ids and masks as padded batches cut at 512 and at 6 tokens: the NFC
    normalizer, the space runs (added tokens matched on the normalized
    text), `<|endoftext|>` and `<|padding|>` kept whole, both padding
    sides, and the template the class rebuilds from `add_bos_token` and
    `add_eos_token`, both false when tokenizer_config.json leaves them out
    (the file's post-processor never counts)."""
    if layout in ("right", "left"):
        path = ckpt[layout]
    else:
        path = str(tmp_path / layout)
        shutil.copytree(ckpt["right"], path)
        _tokenizer_files(path, "right", add_bos_token=layout != "no-flags",
                         add_eos_token=layout == "bos-eos")
        if layout == "no-flags":
            config_path = os.path.join(path, "tokenizer_config.json")
            with open(config_path) as f:
                config = json.load(f)
            del config["add_bos_token"], config["add_eos_token"]
            with open(config_path, "w") as f:
                json.dump(config, f)
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == "GPTNeoXTokenizerFast"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(path))
    texts = _texts(20, seed=7) + TEXTS + ["Café é", "a" + " " * 30 + "b"]
    for max_len in (512, 6):
        ids, mask = tok(texts, max_len)
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        assert ids.tolist() == want["input_ids"], max_len
        assert mask.tolist() == want["attention_mask"], max_len
    assert (tok.before, tok.after) == {"right": ([], []), "left": ([], []), "bos": ([0], []),
                                       "bos-eos": ([0], [0]), "no-flags": ([], [])}[layout]


def test_no_pad_token_is_refused_as_the_reference_refuses_to_pad(ckpt, tmp_path):
    """Pythia's files name no pad token: AutoTokenizer(padding=True) raises
    "Asking to pad but the tokenizer does not have a padding token", so the
    JAX package raises at encode; the port refuses by name."""
    path = str(tmp_path / "nopad")
    shutil.copytree(ckpt["right"], path)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.gpt_neox_tokenizer_config(SPEC, pad_token=None), f)
    with pytest.raises(ValueError, match="Asking to pad"):
        FlaxTextEncoder(path, "useModel").encode(["hello world"])
    refusal = re.escape("names no pad token, and GPTNeoXTokenizer has none")
    with pytest.raises(ValueError, match=refusal):
        hf_encoder.TextEncoder(path, "useModel", device=None).encode(["hello world"])


def test_a_directory_without_tokenizer_json_is_refused(ckpt, tmp_path):
    """GPTNeoXTokenizerFast has no slow class: from vocab.json and
    merges.txt alone transformers fails to build it, and the port refuses
    the directory by name."""
    path = str(tmp_path / "legacy")
    shutil.copytree(ckpt["right"], path)
    os.remove(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(SPEC["model"]["vocab"], f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in SPEC["model"]["merges"]))
    with pytest.raises(ValueError):
        transformers.AutoTokenizer.from_pretrained(path)
    with pytest.raises(ValueError, match="GPTNeoXTokenizer, which reads a tokenizer.json only"):
        checkpoint.load_checkpoint(path)
