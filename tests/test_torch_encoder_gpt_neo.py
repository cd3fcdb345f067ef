"""GPT-Neo in the text encoder (K8): the port's `gpt_neo` model type
(models/gpt_neo.py: learned absolute positions from the padded start,
global and local layers, unscaled scores under the reference's two
masks), GPT-2's tokenizer classes (models/bpe.py), the weight names, and
the encoder against transformers and the JAX package's
`FlaxTextEncoder`.

Nothing is downloaded. Tiny GPT-Neos (hidden 64, 4 heads of 16,
intermediate 96, 512 positions, `attention_types` [[["global", "local"],
1]] with a 6-token window) are built from transformers' `GPTNeoConfig`,
their weights drawn with numpy from a seed (Q and K at 0.15, so
attention is peaked and a scale or an off-by-one window shows), and
saved as pytorch_model.bin beside a seeded byte-level BPE in GPT-2's
layout (`fixtures.gpt2_tokenizer_json`: `<|endoftext|>` as unk, bos, eos
and pad, padding right or left as tokenizer_config.json says). Flax
GPT-Neo does not read a lone pytorch_model.bin, so the JAX package's
encoder runs transformers' torch `GPTNeoModel` (`eager`, its only
attention). The port is held against it on every row of the last hidden
state, padded rows included, and on normalized vectors, within ATOL
(1e-5), under both poolings and both padding sides."""

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
    fixtures,
    gpt_neo,
    hf_encoder,
)

ATOL = 1e-5  # max abs error, normalized vectors and last hidden states
BITES = 1e-3  # a trap undone must move the last hidden state this far (100 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文", "x.y"]
TEXTS = ["hello world", "", "😀 中文 é", "<|endoftext|> inside <|endoftext|>",
         " ".join(WORDS * 3), "x  y\tz\nnew line", "it's we'll DON'T"]
WINDOW = 6
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
             max_position_embeddings=512, window_size=WINDOW,
             attention_types=[[["global", "local"], 1]])
# Muennighoff/SGPT-125M-weightedmean-nli-bitfit's config.json (EleutherAI's
# gpt-neo-125M widths)
SGPT_125M = {"model_type": "gpt_neo", "vocab_size": 50257, "hidden_size": 768, "num_layers": 12,
             "num_heads": 12, "attention_types": [[["global", "local"], 6]],
             "intermediate_size": None, "window_size": 256, "max_position_embeddings": 2048,
             "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5}


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


SPEC = fixtures.gpt2_tokenizer_json(_texts(200, seed=1) + TEXTS, 700, seed=2)
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
            sd = 0.15 if name.endswith(("q_proj.weight", "k_proj.weight")) else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if ("ln_" in name) and name.endswith("weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, side=None, **changes):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(SPEC, f, ensure_ascii=False)
    config = {**fixtures.gpt2_tokenizer_config(SPEC, padding_side=side), **changes}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


def _config(**changes):
    return transformers.GPTNeoConfig(vocab_size=VOCAB_SIZE, **{**SMALL, **changes})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`left` and `right`: one GPTNeoModel, padded as named; `lm`: a
    GPTNeoForCausalLM (`transformer.` prefix, `lm_head.`) with the stale
    `attn.attention.bias` / `masked_bias` buffers older files hold;
    `types`: `left` with model_input_names that give token types."""
    root = tmp_path_factory.mktemp("gpt_neo")
    out = {}
    model = transformers.GPTNeoModel(_config())
    _draw_weights(model, 40)
    for side in ("left", "right"):
        path = out[side] = str(root / side)
        model.save_pretrained(path, safe_serialization=False)
        _tokenizer_files(path, side)
    path = out["types"] = str(root / "types")
    model.save_pretrained(path, safe_serialization=False)
    _tokenizer_files(path, "left", model_input_names=["input_ids", "token_type_ids",
                                                      "attention_mask"])
    lm = transformers.GPTNeoForCausalLM(_config())
    _draw_weights(lm, 41)
    path = out["lm"] = str(root / "lm")
    lm.save_pretrained(path, safe_serialization=False)
    state = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
    for i, layer in enumerate(lm.transformer.h):
        attn = layer.attn.attention
        state[f"transformer.h.{i}.attn.attention.bias"] = attn.bias.clone()
        state[f"transformer.h.{i}.attn.attention.masked_bias"] = attn.masked_bias.clone()
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    _tokenizer_files(path)
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "GPTNeoModel" and ref.config._attn_implementation == "eager"
    return ref


def _forward(path, texts):
    """(port, reference, mask): the last hidden states of `texts` in one
    padded batch."""
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    return got, want, mask


# -- config, module and weights ---------------------------------------------------


def test_the_config_reads_as_transformers(ckpt):
    """The layer types, window and widths as GPTNeoConfig holds them, and
    GPT2Tokenizer's files read as a byte-level BPE, right-padded unless
    tokenizer_config.json says left."""
    for side in ("left", "right"):
        c = checkpoint.load_checkpoint(ckpt[side])
        model = checkpoint.build_model(c)
        want = transformers.AutoConfig.from_pretrained(ckpt[side])
        assert isinstance(model, gpt_neo.GPTNeoModel)
        assert model.config["layer_types"] == want.attention_layers == ["global", "local"]
        assert model.config["window"] == want.window_size == WINDOW
        assert model.config["num_hidden_layers"] == want.num_layers == 2
        assert model.config["num_attention_heads"] == want.num_heads == 4
        assert model.config["intermediate_size"] == 96
        tok = checkpoint.build_tokenizer(c)
        assert isinstance(tok, bpe.BPE) and tok.padding_side == side
        assert (tok.before, tok.after, tok.pad) == ([], [], VOCAB_SIZE - 1)


def test_the_published_sgpt_125m_widths():
    """SGPT-125M (gpt-neo-125M): 12 layers of 768, 12 heads, six global and
    six local layers alternating with a 256-token window, intermediate 4 x
    768; the module's names and shapes are GPTNeoModel's."""
    config = gpt_neo.check_config(SGPT_125M)
    assert config["layer_types"] == ["global", "local"] * 6 and config["window"] == 256
    assert config["intermediate_size"] == 3072
    with torch.device("meta"):
        ours = gpt_neo.GPTNeoModel(SGPT_125M).state_dict()
        theirs = transformers.GPTNeoModel(transformers.GPTNeoConfig(
            **{k: v for k, v in SGPT_125M.items() if k != "model_type"})).state_dict()
    theirs = {k: v for k, v in theirs.items() if not k.endswith(("attention.bias", "masked_bias"))}
    assert set(ours) == set(theirs) and all(ours[k].shape == theirs[k].shape for k in ours)
    linear = sum(v.numel() for k, v in ours.items() if k.endswith("proj.weight")
                 or k.endswith(("c_fc.weight", "c_proj.weight")))
    assert linear == 12 * (4 * 768 * 768 + 2 * 768 * 3072) == 84_934_656


def test_defaults_and_aliases_resolve_as_gptneoconfig():
    """A config with only some widths resolves as GPTNeoConfig: its
    defaults, `num_hidden_layers` / `num_attention_heads` read through the
    attribute map, and a config.json's `attention_layers` kept over the
    expansion of `attention_types`."""
    got = gpt_neo.check_config({"model_type": "gpt_neo"})
    want = transformers.GPTNeoConfig()
    assert got["layer_types"] == want.attention_layers
    for ours, theirs in (("num_hidden_layers", "num_layers"), ("num_attention_heads", "num_heads"),
                         ("hidden_size", "hidden_size"), ("window", "window_size"),
                         ("max_position_embeddings", "max_position_embeddings"),
                         ("layer_norm_epsilon", "layer_norm_epsilon"),
                         ("activation_function", "activation_function")):
        assert got[ours] == getattr(want, theirs), ours
    kwargs = dict(num_layers=2, attention_types=[[["local"], 2]], num_attention_heads=8,
                  attention_layers=["global", "local"])
    want = transformers.GPTNeoConfig(**kwargs)
    got = gpt_neo.check_config({"model_type": "gpt_neo", **kwargs})
    assert got["layer_types"] == want.attention_layers == ["global", "local"]
    assert got["num_attention_heads"] == want.num_heads == 8


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """GPTNeoForCausalLM's names (`transformer.` prefix, `lm_head.`) and the
    stale causal buffers of older files map onto the port's module; the
    buffers are dropped, not loaded."""
    raw = torch.load(os.path.join(ckpt["lm"], "pytorch_model.bin"), weights_only=True)
    assert "transformer.h.1.attn.attention.masked_bias" in raw
    c = checkpoint.load_checkpoint(ckpt["lm"])
    with torch.device("meta"):
        names = set(gpt_neo.GPTNeoModel(c.config).state_dict())
    assert set(c.state_dict) == names and "h.0.attn.attention.out_proj.bias" in names
    got, want, _mask = _forward(ckpt["lm"], _texts(4, seed=3) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, tmp_path):
    """write_checkpoint's pytorch_model.bin and GPT-2's tokenizer files load
    into GPTNeoModel and AutoTokenizer with nothing missing."""
    c = checkpoint.load_checkpoint(ckpt["right"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=SPEC)
    ref, info = transformers.AutoModel.from_pretrained(path, output_loading_info=True)
    assert type(ref).__name__ == "GPTNeoModel"
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert "pytorch_model.bin" in os.listdir(path)
    tok = transformers.AutoTokenizer.from_pretrained(path)
    assert type(tok).__name__ == "GPT2TokenizerFast" and tok.pad_token == "<|endoftext|>"


REFUSED = [
    ({"attention_types": [[["global", "sliding"], 1]]}, "attention_types entries \\['sliding'\\]"),
    ({"attention_types": [[["global", "local"], 2]]}, "expand to 4 layer types"),
    ({"num_heads": 5}, "hidden_size is not a multiple of num_heads"),
]


@pytest.mark.parametrize("change, match", REFUSED)
def test_what_transformers_raises_on_is_refused_by_name(change, match):
    config = {"model_type": "gpt_neo", "vocab_size": 100, **SMALL, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)
    with pytest.raises((ValueError, NotImplementedError, KeyError)):
        transformers.GPTNeoModel(transformers.GPTNeoConfig(
            **{k: v for k, v in config.items() if k != "model_type"}))


def test_an_activation_outside_the_ports_list_is_refused():
    """`gelu_10` is transformers' clipped GELU, which the port does not run
    (the port's choice, as for every family)."""
    config = {"model_type": "gpt_neo", "vocab_size": 100, **SMALL,
              "activation_function": "gelu_10"}
    with pytest.raises(ValueError, match="activation_function `gelu_10`"):
        checkpoint.check_config(config)


def test_an_unknown_attention_type_raises_in_transformers_as_refused():
    """transformers builds the config and raises NotImplementedError when
    the layer is built; the port refuses the checkpoint at load."""
    config = transformers.GPTNeoConfig(**{**SMALL, "attention_types": [[["global", "sliding"], 1]]})
    with pytest.raises(NotImplementedError, match="global' and 'local"):
        transformers.GPTNeoModel(config)


def test_a_batch_past_the_positions_is_refused(ckpt, tmp_path):
    """`wpe` has max_position_embeddings rows: a longer batch is refused by
    name, as transformers fails on it (not a device-side index error)."""
    c = checkpoint.load_checkpoint(ckpt["right"])
    small = gpt_neo.GPTNeoModel({**c.config, "max_position_embeddings": 8})
    ids = torch.zeros((1, 9), dtype=torch.int64)
    with pytest.raises(ValueError, match="passes max_position_embeddings 8"):
        small(ids, torch.ones_like(ids))


# -- the forward and its traps ----------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
def test_forward_matches_transformers_on_every_row(ckpt, side):
    """Padded batches of texts of 0 to 30 words (past the 6-token window):
    every row of the last hidden state, the padded ones too, equals
    AutoModel's `eager` within ATOL."""
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(ckpt[side], texts)
    assert int((mask == 0).sum()) > 0 and mask.shape[1] > 4 * WINDOW
    real = mask.sum(1) > 0  # "" has no token at all: GPT-2's files add none
    assert bool((mask[real, -1 if side == "left" else 0] == 1).all()) and not bool(real.all())
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_the_scores_are_not_scaled(ckpt):
    """Mutation guard: GPT-Neo's scores carry no 1/sqrt(head_dim). The port
    equals the reference, and the same model with the scale in (Q's
    weights times 16 ** -0.5) moves past BITES on the same batch."""
    texts = _texts(6, seed=10, lo=10) + TEXTS
    got, want, _mask = _forward(ckpt["right"], texts)
    assert float((got - want).abs().max()) <= ATOL
    c = checkpoint.load_checkpoint(ckpt["right"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    for block in model.h:
        q = block.attn.attention.q_proj
        q.weight = torch.nn.Parameter(q.weight * 16 ** -0.5)
    with torch.no_grad():
        assert float((model(ids, mask) - want).abs().max()) > BITES


def test_the_local_window_sees_itself_and_window_minus_one_before(ckpt):
    """Mutation guard: on a local layer query i sees keys i - 5 .. i (the
    bias `tril XOR tril(., -6)`); one key more or less of reach moves the
    last hidden state past BITES on texts longer than the window."""
    c = checkpoint.load_checkpoint(ckpt["right"])
    model = checkpoint.build_model(c)
    seen = model.seen(10, torch.device("cpu"))["local"]
    assert seen[9].nonzero().flatten().tolist() == [4, 5, 6, 7, 8, 9]
    assert torch.equal(model.seen(10, torch.device("cpu"))["global"],
                       torch.tril(torch.ones(10, 10, dtype=torch.bool)))
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=11, lo=20), 512)
    with torch.no_grad():
        want = _reference(ckpt["right"])(input_ids=ids, attention_mask=mask).last_hidden_state
        assert float((model(ids, mask) - want).abs().max()) <= ATOL
        for moved in (-1, 1):
            model.config["window"] = WINDOW + moved
            assert float((model(ids, mask) - want).abs().max()) > BITES, moved
    model.config["window"] = WINDOW


def test_positions_count_from_the_padded_start(ckpt):
    """Under left padding a text's positions shift with its batch's longest
    text: the same text gives another state in a longer batch, in the port
    as in the reference (hazard 3.25's kind)."""
    text = "hello world search engine"
    for path in (ckpt["left"],):
        c = checkpoint.load_checkpoint(path)
        tok, model = checkpoint.build_tokenizer(c), checkpoint.build_model(c)
        ref = _reference(path)
        outs = []
        for batch in ([text], [text, " ".join(WORDS * 2)]):
            ids, mask = tok(batch, 512)
            with torch.no_grad():
                got = model(ids, mask)[0, -1]
                want = ref(input_ids=ids, attention_mask=mask).last_hidden_state[0, -1]
            assert float((got - want).abs().max()) <= ATOL
            outs.append(got)
        assert float((outs[0] - outs[1]).abs().max()) > BITES


def test_token_types_add_their_word_rows_as_the_reference_adds_them(ckpt):
    """A tokenizer_config.json whose model_input_names give token types:
    the JAX package passes them and GPTNeoModel adds `wte`'s row 0 to every
    position; the port passes and adds them too."""
    texts = _texts(5, seed=12) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt["types"], "useModel")
    want = jax_enc.encode(texts)
    assert "token_type_ids" in jax_enc._tokenizer(texts[:1])
    got = hf_encoder.TextEncoder(ckpt["types"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL
    plain = hf_encoder.TextEncoder(ckpt["left"], "useModel", device=None).encode(texts)
    assert float(np.abs(plain - want).max()) > BITES


# -- the encoder ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_encoder_matches_jax(ckpt, side, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized, texts of 0 to
    30 words in one call; chunks of 3 are cut from the call's one padded
    batch under left padding (the positions count from its start)."""
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt[side], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "GPTNeoModel"
    assert type(jax_enc._tokenizer).__name__ == "GPT2TokenizerFast"
    assert jax_enc._tokenizer.padding_side == side
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[side], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_left_padded_chunks_are_cut_from_one_batch(ckpt, pooling, monkeypatch):
    """Mutation guard: chunks of 3, each padded to its own longest text,
    would give the short texts other positions than the JAX package's one
    batch, and miss past BITES; the port cuts them from the call's batch."""
    texts = ["rust", "hello world", "café"] + _texts(5, seed=17, lo=20) + ["中文"] * 3
    want = FlaxTextEncoder(ckpt["left"], pooling).encode(texts)
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    enc = hf_encoder.TextEncoder(ckpt["left"], pooling, device=None)
    got = enc.encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL
    apart = np.concatenate([enc.encode(texts[s:s + 3]) for s in range(0, len(texts), 3)])
    assert float(np.abs(apart - want).max()) > BITES


def test_chunk_texts_counts_the_masks(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with the additive (L, L) mask and the one more score-sized
    tensor (`torch.where`) counted (the arithmetic, with the device's free
    memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["right"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
    per_text += 4 * L * L + 4 * heads * L * L
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- GPT-2's tokenizer ------------------------------------------------------------


def _legacy_dir(path, **config):
    """vocab.json + merges.txt only (no tokenizer.json), as GPT2Tokenizer
    saves them, with GPT2Tokenizer's tokenizer_config.json."""
    os.makedirs(path, exist_ok=True)
    model = SPEC["model"]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(model["vocab"], f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in model["merges"]))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "GPT2Tokenizer", "pad_token": "<|endoftext|>", **config}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt_neo", "vocab_size": VOCAB_SIZE, **SMALL}, f)
    return str(path)


@pytest.mark.parametrize("layout", ["json-left", "json-right", "legacy", "legacy-bos"])
def test_tokenizer_matches_autotokenizer(ckpt, layout, tmp_path):
    """Ids and masks as padded batches cut at 512 and at 6 tokens, from
    tokenizer.json (both padding sides) and from GPT2Tokenizer's vocab.json
    + merges.txt, as GPT2Converter converts them (bos first under
    add_bos_token)."""
    if layout.startswith("json"):
        path = ckpt[layout.split("-")[1]]
    else:
        path = _legacy_dir(tmp_path / layout, add_bos_token=layout.endswith("bos"))
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == "GPT2TokenizerFast"
    c = checkpoint.load_checkpoint(path) if layout.startswith("json") else None
    if c is None:  # the legacy directory holds no weights
        with open(os.path.join(path, "tokenizer_config.json")) as f:
            tok = bpe.BPE(bpe.legacy_spec(path, json.load(f), "GPT2Tokenizer"),
                          {"tokenizer_class": "GPT2Tokenizer", "pad_token": "<|endoftext|>"})
    else:
        tok = checkpoint.build_tokenizer(c)
    texts = _texts(20, seed=7) + TEXTS
    for max_len in (512, 6):
        ids, mask = tok(texts, max_len)
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        assert ids.tolist() == want["input_ids"], max_len
        assert mask.tolist() == want["attention_mask"], max_len
    if layout == "legacy-bos":
        assert tok.before == [VOCAB_SIZE - 1]


def test_no_pad_token_is_refused_as_the_reference_refuses_to_pad(ckpt, tmp_path):
    """GPT-2's files name no pad token: AutoTokenizer(padding=True) raises
    "Asking to pad but the tokenizer does not have a padding token", so the
    JAX package raises at encode; the port refuses by name."""
    path = str(tmp_path / "nopad")
    shutil.copytree(ckpt["right"], path)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.gpt2_tokenizer_config(SPEC, pad_token=None), f)
    with pytest.raises(ValueError, match="Asking to pad"):
        FlaxTextEncoder(path, "useModel").encode(["hello world"])
    refusal = re.escape("names no pad token, and GPT2Tokenizer has none")
    with pytest.raises(ValueError, match=refusal):
        hf_encoder.TextEncoder(path, "useModel", device=None).encode(["hello world"])
