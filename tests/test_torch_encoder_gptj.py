"""GPT-J in the text encoder (K8): the port's `gptj` model type
(models/gptj.py: the interleaved rotary over the first `rotary_dim`
channels of each head, positions from the padded start, attention and
MLP side by side on one LayerNorm), its weight names, and the encoder
against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny GPT-Js (n_embd 64, 4 heads of 16, n_inner
96, 512 positions) with `rotary_dim` 8 (under the head width) and 16
(the whole head) are built from transformers' `GPTJConfig`, their
weights drawn with numpy from a seed (Q and K at 0.15, so attention is
peaked), and saved as pytorch_model.bin beside a seeded byte-level BPE
in GPT-2's layout (`fixtures.gpt2_tokenizer_json`, a pad token named,
padding right or left). Flax GPT-J does not read a lone
pytorch_model.bin, so the JAX package's encoder runs transformers' torch
`GPTJModel` (`eager`, its only attention). The port is held against it
on every row of the last hidden state and on normalized vectors within
ATOL (1e-5), under both poolings and both padding sides."""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, fixtures, gptj, hf_encoder  # noqa: E402

ATOL = 1e-5
BITES = 1e-3  # a trap undone must move the last hidden state this far (100 ATOL)
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "it's", "HELLO", "2024", "中文", "x.y"]
TEXTS = ["hello world", "", "😀 中文 é", "<|endoftext|> inside <|endoftext|>",
         " ".join(WORDS * 3), "x  y\tz\nnew line", "it's we'll DON'T"]
SMALL = dict(n_embd=64, n_layer=2, n_head=4, n_inner=96, n_positions=512)
# Muennighoff/SGPT-5.8B-weightedmean-msmarco-specb-bitfit's config.json
# (EleutherAI's gpt-j-6b widths)
SGPT_58B = {"model_type": "gptj", "vocab_size": 50400, "n_embd": 4096, "n_layer": 28,
            "n_head": 16, "rotary_dim": 64, "n_inner": None, "n_positions": 2048,
            "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5}
ROTARY = {"gptj": 8, "gptj-full": 16}


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


SPEC = fixtures.gpt2_tokenizer_json(_texts(200, seed=1) + TEXTS, 700, seed=4)
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
            sd = 0.15 if name.endswith(("q_proj.weight", "k_proj.weight")) else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if ("ln_" in name) and name.endswith("weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _tokenizer_files(path, side=None):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(SPEC, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.gpt2_tokenizer_config(SPEC, padding_side=side), f)


def _config(**changes):
    return transformers.GPTJConfig(vocab_size=VOCAB_SIZE, **{**SMALL, **changes})


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`{name}-{side}` for each of ROTARY, a GPTJModel padded as named;
    `lm`: a GPTJForCausalLM (`transformer.` prefix, `lm_head.`) with the
    stale `attn.bias` / `attn.masked_bias` buffers older files hold."""
    root = tmp_path_factory.mktemp("gptj")
    out = {}
    for i, (name, rotary) in enumerate(ROTARY.items()):
        model = transformers.GPTJModel(_config(rotary_dim=rotary))
        _draw_weights(model, 50 + i)
        for side in ("left", "right"):
            path = out[f"{name}-{side}"] = str(root / f"{name}-{side}")
            model.save_pretrained(path, safe_serialization=False)
            _tokenizer_files(path, side)
    lm = transformers.GPTJForCausalLM(_config(rotary_dim=8))
    _draw_weights(lm, 52)
    path = out["lm"] = str(root / "lm")
    lm.save_pretrained(path, safe_serialization=False)
    state = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
    L = SMALL["n_positions"]
    for i in range(SMALL["n_layer"]):
        state[f"transformer.h.{i}.attn.bias"] = torch.tril(
            torch.ones((L, L), dtype=torch.bool)).view(1, 1, L, L)
        state[f"transformer.h.{i}.attn.masked_bias"] = torch.tensor(-1e9)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    _tokenizer_files(path)
    return out


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "GPTJModel" and ref.config._attn_implementation == "eager"
    return ref


def _forward(path, texts):
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    with torch.no_grad():
        want = _reference(path)(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    return got, want, mask


# -- config, module and weights ---------------------------------------------------


@pytest.mark.parametrize("name", ROTARY)
def test_the_config_reads_as_transformers(ckpt, name):
    c = checkpoint.load_checkpoint(ckpt[f"{name}-right"])
    model = checkpoint.build_model(c)
    want = transformers.AutoConfig.from_pretrained(ckpt[f"{name}-right"])
    assert isinstance(model, gptj.GPTJModel)
    assert model.config["rotary_dim"] == want.rotary_dim == ROTARY[name]
    assert model.config["hidden_size"] == want.n_embd and model.config["intermediate_size"] == 96
    assert model.config["num_attention_heads"] == want.n_head == 4
    assert model.config["max_position_embeddings"] == want.n_positions == 512


def test_the_published_sgpt_58b_widths():
    """SGPT-5.8B (gpt-j-6b): 28 layers of 4,096, 16 heads of 256, a rotary
    over 64 of them, intermediate 16,384, 201.3M Linear weights a layer;
    the module's names and shapes are GPTJModel's."""
    config = gptj.check_config(SGPT_58B)
    assert (config["hidden_size"], config["num_attention_heads"], config["rotary_dim"],
            config["intermediate_size"]) == (4096, 16, 64, 16384)
    small = {**SGPT_58B, "n_layer": 1}
    with torch.device("meta"):
        ours = gptj.GPTJModel(small).state_dict()
        theirs = transformers.GPTJModel(transformers.GPTJConfig(
            **{k: v for k, v in small.items() if k != "model_type"})).state_dict()
    assert set(ours) == set(theirs) and all(ours[k].shape == theirs[k].shape for k in ours)
    linear = sum(v.numel() for k, v in ours.items() if k.endswith(("proj.weight", "fc_in.weight",
                                                                    "fc_out.weight")))
    assert linear == 4 * 4096 * 4096 + 2 * 4096 * 16384 == 201_326_592


def test_aliases_resolve_as_gptjconfig():
    """GPTJConfig's attribute map: `hidden_size`, `num_attention_heads`,
    `num_hidden_layers` and `max_position_embeddings` given in config.json
    win over `n_embd`, `n_head`, `n_layer` and `n_positions`."""
    kwargs = dict(hidden_size=128, num_attention_heads=8, num_hidden_layers=3,
                  max_position_embeddings=64, n_embd=64, n_head=4, n_layer=2, n_positions=512,
                  rotary_dim=8)
    want = transformers.GPTJConfig(**kwargs)
    got = gptj.check_config({"model_type": "gptj", **kwargs})
    assert (got["hidden_size"], got["num_attention_heads"], got["num_hidden_layers"],
            got["max_position_embeddings"]) == (want.n_embd, want.n_head, want.n_layer,
                                                want.n_positions) == (128, 8, 3, 64)


def test_the_rotary_table_is_transformers_bit_for_bit():
    """`sincos(L, dim)` equals `create_sinusoidal_positions`' rows 0..L-1,
    each entry repeated twice, as GPTJAttention gathers and repeats them."""
    from transformers.models.gptj.modeling_gptj import create_sinusoidal_positions

    for dim in (8, 16, 64):
        table = create_sinusoidal_positions(2048, dim)
        for L in (1, 13, 512):
            sin, cos = gptj.sincos(L, dim)
            want_sin, want_cos = torch.split(table[:L], dim // 2, dim=-1)
            assert torch.equal(sin[0, :, 0], torch.repeat_interleave(want_sin, 2, -1))
            assert torch.equal(cos[0, :, 0], torch.repeat_interleave(want_cos, 2, -1))


def test_weight_names_of_the_causal_lm_map_onto_the_model(ckpt):
    """GPTJForCausalLM's names and the stale `attn.bias` / `attn.masked_bias`
    buffers of older files: the buffers are dropped, the rest loads."""
    raw = torch.load(os.path.join(ckpt["lm"], "pytorch_model.bin"), weights_only=True)
    assert "transformer.h.0.attn.masked_bias" in raw and "lm_head.weight" in raw
    c = checkpoint.load_checkpoint(ckpt["lm"])
    with torch.device("meta"):
        names = set(gptj.GPTJModel(c.config).state_dict())
    assert set(c.state_dict) == names
    got, want, _mask = _forward(ckpt["lm"], _texts(4, seed=3) + TEXTS)
    assert float((got - want).abs().max()) <= ATOL


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt, tmp_path):
    c = checkpoint.load_checkpoint(ckpt["gptj-right"])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, tokenizer_json=SPEC)
    ref, info = transformers.AutoModel.from_pretrained(path, output_loading_info=True)
    assert type(ref).__name__ == "GPTJModel"
    assert not info["missing_keys"] and not info["unexpected_keys"]
    assert type(transformers.AutoTokenizer.from_pretrained(path)).__name__ == "GPT2TokenizerFast"


@pytest.mark.parametrize("rotary, match", [(7, "rotary_dim 7"), (32, "rotary_dim 32")])
def test_a_rotary_transformers_cannot_run_is_refused(rotary, match):
    """An odd rotary width (rotate_every_two cannot stack its halves) or one
    wider than the head: transformers fails at the forward, the port
    refuses the config by name."""
    model = transformers.GPTJModel(transformers.GPTJConfig(vocab_size=100, **SMALL,
                                                           rotary_dim=rotary)).eval()
    ids = torch.arange(12)[None]
    with pytest.raises(RuntimeError), torch.no_grad():
        model(input_ids=ids, attention_mask=torch.ones_like(ids))
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config({"model_type": "gptj", "vocab_size": 100, **SMALL,
                                 "rotary_dim": rotary})


def test_a_batch_past_the_positions_is_refused(ckpt):
    c = checkpoint.load_checkpoint(ckpt["gptj-right"])
    small = gptj.GPTJModel({**c.config, "n_positions": 8, "max_position_embeddings": 8})
    ids = torch.zeros((1, 9), dtype=torch.int64)
    with pytest.raises(ValueError, match="passes n_positions 8"):
        small(ids, torch.ones_like(ids))


# -- the forward -------------------------------------------------------------------


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("name", ROTARY)
def test_forward_matches_transformers_on_every_row(ckpt, name, side):
    """Every row of the last hidden state, padded ones included, equals
    AutoModel's `eager` within ATOL: rotary_dim 8 rotates half of each
    16-wide head and passes the rest, 16 the whole head."""
    texts = _texts(6, seed=9) + TEXTS
    got, want, mask = _forward(ckpt[f"{name}-{side}"], texts)
    assert int((mask == 0).sum()) > 0
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


def test_the_rotary_covers_only_rotary_dim_channels(ckpt):
    """Mutation guard: rotating the whole 16-wide head where rotary_dim is 8
    moves the last hidden state past BITES."""
    texts = _texts(6, seed=10, lo=5) + TEXTS
    got, want, _mask = _forward(ckpt["gptj-right"], texts)
    assert float((got - want).abs().max()) <= ATOL
    c = checkpoint.load_checkpoint(ckpt["gptj-right"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    for block in model.h:
        block.attn.rotary = 16
    model.config["rotary_dim"] = 16
    with torch.no_grad():
        assert float((model(ids, mask) - want).abs().max()) > BITES


# -- the encoder ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_encoder_matches_jax(ckpt, side, pooling, chunk, monkeypatch):
    """The JAX package's torch branch, pooled and normalized; chunks of 3
    are cut from the call's one padded batch under left padding."""
    path = ckpt[f"gptj-{side}"]
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "GPTJModel"
    assert jax_enc._tokenizer.padding_side == side
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert float(np.abs(got - want).max()) <= ATOL


def test_left_padded_chunks_are_cut_from_one_batch(ckpt, monkeypatch):
    """Mutation guard: the rotary counts positions from the padded start.
    Its scores depend on positions only through their difference, so a
    text padded otherwise moves only by rounding (under ATOL), yet the
    bits move: chunks padded on their own differ from the JAX package's
    one batch, while the port's chunks, cut from the call's batch, run
    the reference's ops on the same positions and give its bits."""
    texts = ["rust", "hello world", "café"] + _texts(5, seed=17, lo=20) + ["中文"] * 3
    want = FlaxTextEncoder(ckpt["gptj-left"], "useModel").encode(texts)
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    enc = hf_encoder.TextEncoder(ckpt["gptj-left"], "useModel", device=None)
    got = enc.encode(texts)
    assert np.array_equal(got, want)
    apart = np.concatenate([enc.encode(texts[s:s + 3]) for s in range(0, len(texts), 3)])
    assert not np.array_equal(apart, want) and float(np.abs(apart - want).max()) <= ATOL


def test_chunk_texts_counts_the_masks(ckpt, monkeypatch):
    """The additive (L, L) mask and the divided scores counted on top of
    the common per-text count (the arithmetic, free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["gptj-right"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
    per_text += 4 * L * L + 4 * heads * L * L
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40
