"""DeBERTa-v2 in the text encoder (K8): the port's `deberta-v2` model type
(models/deberta_v2.py: disentangled attention over log-bucketed relative
positions, the mask that replaces the scores, the masked embeddings), its
weight names, the Unigram tokenizer's `Sequence` pre-tokenizer with
`Punctuation` and DeBERTa-v3's tokenizer.json layout, and the encoder
against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny DeBERTa-v2 models (hidden 64, 4 heads,
intermediate 96) are built from a `DebertaV2Config`, their weights drawn
with numpy from a seed (the projections with a standard deviation of
0.15, so attention is peaked and a misplaced relative term moves the
output far beyond the tolerance):
- `v3`: deberta-v3-base's flags (`relative_attention`, `pos_att_type`
  "p2c|c2p", `share_att_key`, `norm_rel_ebd` "layer_norm", no absolute
  positions, no token types, eps 1e-7), 3 layers, with 16 position
  buckets (mid 8), so short texts reach the log buckets;
- `b20`: 20 buckets over a maximum distance of 64 (where a `math.log`
  bucket edge moves at distance 63), separate `pos_key_proj` and
  `pos_query_proj`, absolute positions, two token types and 48-wide
  embeddings through `embed_proj`;
- `nobucket`: no buckets, distances clamped at 24, c2p only (scale
  factor 2);
- `abs`: no relative attention, absolute positions only;
- `conv`: deberta-v2-xlarge's flags at these widths: `v3`'s with the
  `ConvLayer` after layer 0 (kernel 3, `gelu`, here 2 groups);
- `norel`: no relative attention and no absolute positions (no position
  at all, as transformers runs it), the scale still counting c2p and p2c.
They sit beside a seeded Unigram tokenizer.json in `DebertaV2Converter`'s
layout (`models/fixtures.py::deberta_v3_tokenizer_json`, held here
against the converter itself). transformers has no Flax DeBERTa-v2, so
the JAX package's encoder runs the torch `DebertaV2Model`. The port is
held against it within 1e-5 on every row of padded batches (padded rows
too: they show a mask that adds instead of replacing), on texts longer
than the buckets reach, for each pooling and through HTTP; the tokenizer
against `AutoTokenizer`; the bucket table and the scale bit for bit."""

import json
import math
import os
import shutil
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from transformers.models.deberta_v2 import modeling_deberta_v2 as hf_deberta  # noqa: E402

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    checkpoint,
    deberta_v2,
    fixtures,
    hf_encoder,
    unigram,
)
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "Hello", "World", "GPU", "it's", "we'll"]
CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,!?'-()éï"
TEXTS = [
    "Hello, World! it's (a) test.", "Café naïve — déjà vu", "runs    of   spaces",
    "[MASK] and [CLS] inside [SEP] [PAD] [UNK]", "hello [MASK] world", "x[MASK]y  [MASK]  z",
    "  leading and trailing  ", "", "Ａｂｃ ﬁne", "punct...!?,,(x)-y 'q'", "UPPER lower MiXeD",
    "tab\there new\nline", "✈ unknown ☃",
]
BUCKETS = 16
PUBLISHED = {  # microsoft/deberta-v3-base's config.json
    "model_type": "deberta-v2", "vocab_size": 128_100, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "relative_attention": True, "position_buckets": 256,
    "max_relative_positions": -1, "pos_att_type": "p2c|c2p", "norm_rel_ebd": "layer_norm",
    "share_att_key": True, "position_biased_input": False, "type_vocab_size": 0,
    "layer_norm_eps": 1e-7, "hidden_act": "gelu", "pad_token_id": 0,
}


def _pieces() -> list:
    rng = np.random.default_rng(7)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:], w.lower()]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


CHARSMAP = fixtures.build_charsmap({"é": "é", "Ａ": "A", "ｂ": "b", "ｃ": "c", "ﬁ": "fi"})
SPEC = fixtures.deberta_v3_tokenizer_json(_pieces(), CHARSMAP)
PUNCT_SPEC = fixtures.deberta_v3_tokenizer_json(_pieces(), CHARSMAP, do_lower_case=True,
                                                split_by_punct=True)
VOCAB_SIZE = len(SPEC["model"]["vocab"]) + 100  # deberta-v3-base: 128,001 tokens, 128,100 rows
CONFIGS = {
    "v3": dict(num_hidden_layers=3, relative_attention=True, position_buckets=BUCKETS,
               max_relative_positions=-1, pos_att_type="p2c|c2p", norm_rel_ebd="layer_norm",
               share_att_key=True, position_biased_input=False, type_vocab_size=0),
    "b20": dict(num_hidden_layers=2, relative_attention=True, position_buckets=20,
                max_relative_positions=64, pos_att_type=["c2p", "p2c"], share_att_key=False,
                position_biased_input=True, type_vocab_size=2, embedding_size=48),
    "nobucket": dict(num_hidden_layers=2, relative_attention=True, position_buckets=-1,
                     max_relative_positions=24, pos_att_type=["c2p"], share_att_key=True,
                     position_biased_input=False, norm_rel_ebd="layer_norm"),
    "abs": dict(num_hidden_layers=2, relative_attention=False, position_biased_input=True),
    "conv": dict(num_hidden_layers=2, relative_attention=True, position_buckets=BUCKETS,
                 max_relative_positions=-1, pos_att_type="p2c|c2p", norm_rel_ebd="layer_norm",
                 share_att_key=True, position_biased_input=False, type_vocab_size=0,
                 conv_kernel_size=3, conv_act="gelu", conv_groups=2),
    "norel": dict(num_hidden_layers=2, relative_attention=False, position_biased_input=False,
                  pos_att_type="p2c|c2p"),
}


def _config(kind):
    return transformers.DebertaV2Config(
        vocab_size=VOCAB_SIZE, hidden_size=64, num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=512, layer_norm_eps=1e-7, pad_token_id=0, **CONFIGS[kind])


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if "_proj." in name and name.endswith("weight") else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, spec=SPEC, config=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config or fixtures.deberta_v2_tokenizer_config(spec), f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """One pytorch_model.bin directory per CONFIGS entry with SPEC; `v3_st`:
    `v3` as model.safetensors; `punct`: `v3` with PUNCT_SPEC (lowercase,
    split_by_punct); `minimal`: `v3` with deberta-v3-base's published
    tokenizer_config.json (no special tokens named); `port`: the port's
    write_checkpoint of `v3`."""
    root = tmp_path_factory.mktemp("deberta")
    out = {k: str(root / k) for k in (*CONFIGS, "v3_st", "punct", "minimal", "port")}
    for seed, kind in enumerate(CONFIGS, start=31):
        model = transformers.DebertaV2Model(_config(kind))
        _draw_weights(model, seed)
        model.save_pretrained(out[kind], safe_serialization=False)
        _write_tokenizer(out[kind])
        if kind == "v3":
            model.save_pretrained(out["v3_st"], safe_serialization=True)
            _write_tokenizer(out["v3_st"])
    for kind, spec, config in (("punct", PUNCT_SPEC, None),
                               ("minimal", SPEC, {"do_lower_case": False, "vocab_type": "spm"})):
        shutil.copytree(out["v3"], out[kind])
        _write_tokenizer(out[kind], spec, config)
    c = checkpoint.load_checkpoint(out["v3"])
    checkpoint.write_checkpoint(out["port"], c.config, c.state_dict, tokenizer_json=SPEC)
    return out


def _texts(n, seed, lo=0, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


def _batch():
    """A padded batch: one word beside texts of 30 to 120 tokens (past
    every bucket and clamp here), the specials, punctuation and spaces."""
    return ["rust", *_texts(4, seed=9, lo=15, hi=60), *TEXTS]


# -- relative positions and the scale --------------------------------------------------


@pytest.fixture
def one_thread():
    """Torch's many small table ops on one intra-op thread, the port's
    cached tables built afresh: under the test run's worker processes each
    op's thread pool otherwise waits on the others' (minutes, not
    seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    deberta_v2.relative_positions.cache_clear()
    yield
    torch.set_num_threads(threads)
    deberta_v2.relative_positions.cache_clear()


@pytest.mark.parametrize("buckets, max_position, longest", [
    (256, 512, 600), (BUCKETS, 512, 300), (20, 64, 200), (74, 512, 600), (16, 40, 100),
    (-1, 24, 60),
])
def test_the_bucket_table_is_transformers(one_thread, buckets, max_position, longest):
    """Every length up to `longest`, bit for bit, against transformers'
    `build_relative_position`; at (20, 64) and (74, 512) a table built
    with `math.log` differs at distance 63 and 511."""
    for n in range(1, longest + 1):
        layer = torch.zeros(1, n, 1)
        want = hf_deberta.build_relative_position(layer, layer, buckets, max_position)[0]
        assert torch.equal(deberta_v2.relative_positions(n, buckets, max_position), want), n


@pytest.mark.parametrize("d", [16, 32, 64, 89, 128, 333])
@pytest.mark.parametrize("kinds", [[], ["c2p"], ["p2c", "c2p"]])
def test_the_scale_is_transformers_float32_sqrt(d, kinds):
    """sqrt(d * factor) as a float32 tensor op, bit for bit; at 89 * 3 and
    333 * 3 `math.sqrt` rounds to another float32."""
    config = {"hidden_size": d, "num_attention_heads": 1, "pos_att_type": kinds}
    got = deberta_v2.attention_scale(config, torch.device("cpu"))
    want = hf_deberta.scaled_size_sqrt(torch.zeros(1, 1, d), 1 + len(kinds))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    if d in (89, 333) and len(kinds) == 2:
        assert float(np.float32(math.sqrt(3 * d))) != float(want)


# -- configs, modules and weight names --------------------------------------------------


def test_the_config_reads_as_deberta_v3(ckpt):
    c = checkpoint.load_checkpoint(ckpt["v3"])
    model = checkpoint.build_model(c)
    assert isinstance(model, deberta_v2.DebertaV2Model)
    config = model.config
    assert config["pos_att_type"] == ["p2c", "c2p"] and deberta_v2.scale_factor(config) == 3
    assert deberta_v2.attention_span(config) == BUCKETS
    assert config["max_relative_positions"] == 512
    assert model.embeddings.position_embeddings is None
    assert model.embeddings.token_type_embeddings is None
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, Unigram) and tok.punct is None
    assert (tok.before, tok.after, tok.pad, tok.unk_id) == ([1], [2], 0, 3)


def test_the_published_widths_give_deberta_v3_base():
    """deberta-v3-base's config.json: 256 buckets over 512 positions, 512
    relative embeddings, scale factor 3; the module's parameters are
    transformers' by name and shape (built on the meta device)."""
    config = deberta_v2.check_config(PUBLISHED)
    assert deberta_v2.attention_span(config) == 256 and deberta_v2.scale_factor(config) == 3
    with torch.device("meta"):
        ours = deberta_v2.DebertaV2Model(PUBLISHED).state_dict()
        theirs = transformers.DebertaV2Model(transformers.DebertaV2Config(**PUBLISHED)).state_dict()
    assert set(ours) == set(theirs) - {"embeddings.position_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["encoder.rel_embeddings.weight"].shape == (512, 768)


def test_the_published_widths_give_deberta_v2_xlarge():
    """deberta-v2-xlarge's config.json: the ConvLayer's (1536, 1536, 3)
    Conv1d and its LayerNorm under transformers' names, `gelu` as its
    activation; every parameter by name and shape (built on the meta
    device)."""
    config = {**PUBLISHED, "vocab_size": 128_100, "hidden_size": 1536,
              "num_hidden_layers": 24, "num_attention_heads": 24, "intermediate_size": 6144,
              "conv_kernel_size": 3, "conv_act": "gelu", "max_relative_positions": -1}
    with torch.device("meta"):
        model = deberta_v2.DebertaV2Model(config)
        ours = model.state_dict()
        theirs = transformers.DebertaV2Model(transformers.DebertaV2Config(**config)).state_dict()
    assert set(ours) == set(theirs) - {"embeddings.position_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["encoder.conv.conv.weight"].shape == (1536, 1536, 3)
    assert model.encoder.conv.act is torch.nn.functional.gelu


def test_the_conv_layer_reads_the_embedding_output(ckpt):
    """Layer 0's output goes through the ConvLayer over the EMBEDDING
    output: fed layer 0's own output instead, or left unmasked, the
    forward moves beyond the tolerance."""
    c = checkpoint.load_checkpoint(ckpt["conv"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    layer0 = model.encoder.layer[0]
    conv_layer = model.encoder.conv
    with torch.no_grad():
        want = model(ids, mask)
        x = model.embeddings(ids, mask)
        real = mask > 0
        rel = model.relative(ids.shape[1], x.device)
        scale = deberta_v2.attention_scale(model.config, x.device)
        out0 = layer0(x, real[:, None, None, :] & real[:, None, :, None], scale, rel)
        moved = conv_layer(out0, out0, mask)
        unmasked = conv_layer(x, out0, torch.ones_like(mask))
        assert float((moved - conv_layer(x, out0, mask)).abs().max()) > 1e-3
        assert float(unmasked[~real].abs().max()) > 1e-3
        assert float(conv_layer(x, out0, mask)[~real].abs().max()) == 0.0
    assert bool(torch.isfinite(want).all())


@pytest.mark.parametrize("change, match", [
    ({"conv_kernel_size": 3, "conv_act": "gelu_10"}, "conv_act"),
    ({"conv_kernel_size": 3, "conv_groups": 5}, "conv_groups"),
    ({"hidden_act": "gelu_new"}, "hidden_act"),
    ({"attention_head_size": 8}, "attention_head_size"),
    ({"pos_att_type": "p2c|p2p"}, "pos_att_type"),
    ({"conv_kernel_size": 2}, "conv_kernel_size"),
])
def test_unread_deberta_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["v3"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)
    with pytest.raises(ValueError, match=match):
        deberta_v2.DebertaV2Model(config)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_the_module_names_are_transformers(ckpt, kind):
    """Every configuration's parameters load by name, strict, from
    transformers' checkpoint (pos_key_proj, pos_query_proj, embed_proj,
    position and token-type embeddings, the relative LayerNorm where the
    config has them)."""
    state = checkpoint.read_weights(ckpt[kind])
    names = set(checkpoint.build_model(checkpoint.load_checkpoint(ckpt[kind])).state_dict())
    assert set(state) == names
    if kind == "b20":
        assert {"embeddings.embed_proj.weight",
                "encoder.layer.0.attention.self.pos_key_proj.weight",
                "encoder.layer.0.attention.self.pos_query_proj.bias",
                "embeddings.position_embeddings.weight"} <= names


@pytest.mark.parametrize("legacy", [True, False])
def test_masked_lm_checkpoints_load_under_the_base_names(ckpt, legacy):
    """`DebertaV2ForMaskedLM` in both layouts transformers saves (`cls.`,
    legacy, and `lm_predictions.`) drops its head and the `deberta.`
    prefix; the torch state_dict's numpy arrays map the same."""
    state = checkpoint.read_weights(ckpt["v3"])
    mlm = transformers.DebertaV2ForMaskedLM.from_pretrained(ckpt["v3"], legacy=legacy)
    named = mlm.state_dict()
    assert any(k.startswith("cls." if legacy else "lm_predictions.") for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ---------------------------------------------------------


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "DebertaV2Model"
    return ref


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_deberta_forward_matches_transformers_torch(ckpt, kind):
    """A padded batch whose short row pads past the buckets and whose long
    rows reach the log buckets (and the clamp), on EVERY row: the padded
    rows too, whose queries see only masked scores (uniform, as
    `masked_fill` leaves them; a mask added to the scores moves them, or
    makes them NaN)."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    lengths = mask.sum(1)
    assert int(lengths.max()) > 64 and int(lengths.min()) <= 3
    with torch.no_grad():
        want = _reference(ckpt[kind])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL
    assert float(got[~mask.bool()].abs().max()) > 0.1  # padded rows are not all zero


def test_unequal_query_and_key_weights_place_p2c(ckpt):
    """p2c is gathered from K's products and transposed: with Q and K
    drawn apart, and the batch padded, a p2c left untransposed (or c2p
    and p2c swapped) moves the output by far more than the tolerance."""
    c = checkpoint.load_checkpoint(ckpt["v3"])
    model = checkpoint.build_model(c)
    attention = model.encoder.layer[0].attention.self
    assert float((attention.query_proj.weight - attention.key_proj.weight).abs().max()) > 0.1
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    with torch.no_grad():
        want = _reference(ckpt["v3"])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
        index = deberta_v2.gather_indexes(ids.shape[1], BUCKETS, 512, BUCKETS,
                                          torch.device("cpu"))
        assert not torch.equal(index[0], index[0].T)  # the table is not symmetric
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
@pytest.mark.parametrize("kind", [*CONFIGS, "v3_st", "minimal", "port"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch (no Flax DeBERTa-v2 exists), pooled
    and normalized; the port's own writing of `v3` embeds as `v3`."""
    texts = _batch() + _texts(6, seed=4)
    source = "v3" if kind == "port" else kind
    jax_enc = FlaxTextEncoder(ckpt[source], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "DebertaV2Model"
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_chunk_texts_counts_the_disentangled_terms(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with DeBERTa's c2p and p2c products (heads, L, 2 span) and
    their gathers (heads, L, L) counted (the arithmetic, with the device's
    free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["v3"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads, span = enc.max_len, c["num_attention_heads"], BUCKETS
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
    per_text += 4 * (2 * heads * L * 2 * span + 2 * heads * L * L)
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- the tokenizer -------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["v3", "punct", "minimal", "port"])
def test_tokenizer_matches_autotokenizer(ckpt, kind):
    """deberta-v3-base's layout (Strip, the charsmap, spaces collapsed,
    Sequence[Metaspace]), the same lowercased with split_by_punct
    (Sequence[Punctuation, Metaspace]), the published tokenizer_config.json
    that names no special token, and the port's own writing: ids and
    masks text by text and as padded batches cut at 512 and at 8."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == "DebertaV2TokenizerFast"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    assert (tok.punct is not None) == (kind == "punct")
    for text in TEXTS:
        assert tok([text], 512)[0].tolist() == ref([text], truncation=True,
                                                   max_length=512)["input_ids"], text
    texts = TEXTS + _batch() + [" ".join(["engine,"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def test_punctuation_is_tokenizers_class_on_every_code_point():
    """The Sequence's Punctuation pieces, the port's split against
    `tokenizers`' pre-tokenizer, over every code point between two
    letters."""
    tok = Unigram(PUNCT_SPEC, {}, "deberta-v2")
    ref = tokenizers.pre_tokenizers.Punctuation()
    points = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
    for i in range(0, len(points), 1 << 15):
        text = "".join(f"a{chr(c)}b" for c in points[i:i + (1 << 15)])
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert [p for p in tok.punct.split(text) if p] == want, hex(points[i])


@pytest.mark.parametrize("pre, match", [
    ([{"type": "WhitespaceSplit"}, fixtures.METASPACE], "Sequence"),
    ([fixtures.METASPACE, {"type": "Punctuation", "behavior": "Isolated"}], "Sequence"),
    ([{"type": "Punctuation", "behavior": "Removed"}, fixtures.METASPACE], "behavior"),
    ([{"type": "Punctuation", "behavior": "Isolated"}, {"type": "Whitespace"}], "Sequence"),
])
def test_an_unread_sequence_pre_tokenizer_is_refused(pre, match):
    spec = dict(SPEC, pre_tokenizer={"type": "Sequence", "pretokenizers": pre})
    with pytest.raises(ValueError, match=match):
        Unigram(spec, fixtures.deberta_v2_tokenizer_config(SPEC))


def test_the_class_pad_stands_in_for_an_unnamed_one():
    """With no pad_token in tokenizer_config.json, a deberta-v2 checkpoint
    pads with DebertaV2TokenizerFast's `[PAD]`; another type keeps `<pad>`,
    which this vocabulary lacks."""
    assert Unigram(SPEC, {}, "deberta-v2").pad == 0
    with pytest.raises(ValueError, match="<pad>"):
        Unigram(SPEC, {}, "xlm-roberta")


@pytest.mark.parametrize("lower, punct", [(False, False), (True, True), (False, True)])
@pytest.mark.parametrize("charsmap", [None, CHARSMAP])
def test_the_deberta_fixture_is_the_converters_file(tmp_path, lower, punct, charsmap):
    """`deberta_v3_tokenizer_json` equals what `DebertaV2Converter` and
    `DebertaV2TokenizerFast.save_pretrained` write for a sentencepiece
    model of `[PAD] [CLS] [SEP] [UNK]` and the same pieces, and
    `deberta_v2_tokenizer_config` what it writes beside it."""
    from transformers.convert_slow_tokenizer import DebertaV2Converter
    from transformers.utils import sentencepiece_model_pb2_new as pb

    vocab = _pieces()
    head = [(p, 0.0, 2 if p == "[UNK]" else 3) for p in fixtures.DEBERTA_HEAD]
    m = pb.ModelProto()
    m.trainer_spec.model_type = 1  # Unigram
    m.trainer_spec.unk_id = 3
    m.normalizer_spec.precompiled_charsmap = charsmap or b""
    for piece, score, kind in head + [(p, s, 1) for p, s in vocab]:
        entry = m.pieces.add()
        entry.piece, entry.score, entry.type = piece, score, kind
    (tmp_path / "spm.model").write_bytes(m.SerializeToString())
    index = {p: i for i, p in enumerate([*fixtures.DEBERTA_HEAD, *(p for p, _s in vocab)])}
    slow = types.SimpleNamespace(vocab_file=str(tmp_path / "spm.model"), do_lower_case=lower,
                                 split_by_punct=punct, convert_tokens_to_ids=index.__getitem__)
    out = str(tmp_path / "out")
    transformers.DebertaV2TokenizerFast(
        tokenizer_object=DebertaV2Converter(slow).converted(), do_lower_case=lower,
        split_by_punct=punct).save_pretrained(out)
    with open(os.path.join(out, "tokenizer.json"), encoding="utf-8") as f:
        written = json.load(f)
    spec = fixtures.deberta_v3_tokenizer_json(vocab, charsmap, lower, punct)
    as_f32 = [[p, np.float32(s)] for p, s in spec["model"]["vocab"]]
    assert [[p, np.float32(s)] for p, s in written["model"]["vocab"]] == as_f32
    assert {k: v for k, v in written.items() if k != "model"} == {
        k: v for k, v in spec.items() if k != "model"}
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        config = json.load(f)
    del config["model_max_length"]
    mine = fixtures.deberta_v2_tokenizer_config(spec)
    assert mine.pop("model_max_length") == 512 and config == mine


def test_the_fixture_layout_is_deberta_v3_base():
    """At 127,996 pieces the fixture holds deberta-v3-base's 128,000
    sentencepiece entries and `[MASK]` at 128,000."""
    spec = fixtures.deberta_v3_tokenizer_json([(f"p{i}", -1.0) for i in range(127_996)])
    assert len(spec["model"]["vocab"]) == 128_000
    assert [(t["id"], t["content"]) for t in spec["added_tokens"]] == [
        (0, "[PAD]"), (1, "[CLS]"), (2, "[SEP]"), (3, "[UNK]"), (128_000, "[MASK]")]
    assert unigram.Unigram(spec, fixtures.deberta_v2_tokenizer_config(spec)).token_to_id(
        "[MASK]") == 128_000


# -- through HTTP --------------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(45)
    return [
        {"id": i, "title": " ".join(rng.choice(WORDS[:10], size=int(rng.integers(2, 40)))),
         "points": int(rng.integers(0, 2000))}
        for i in range(50)
    ]


def _same_within_ties(got, want):
    ids_g, sc_g = [h["id"] for h in got], [h["_rankingScore"] for h in got]
    ids_w, sc_w = [h["id"] for h in want], [h["_rankingScore"] for h in want]
    assert len(ids_g) == len(ids_w)
    np.testing.assert_allclose(sc_g, sc_w, atol=ATOL)
    start = 0
    for i in range(1, len(ids_w) + 1):
        if i == len(ids_w) or abs(sc_w[i] - sc_w[i - 1]) > ATOL:
            assert set(ids_g[start:i]) == set(ids_w[start:i])
            start = i


def test_http_hybrid_with_a_deberta_embedder_matches_jax(ckpt):
    # fault 3.10: the JAX package caches query vectors by embedder name and
    # text across models
    jax_embedders._search_cache.clear()
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt["v3"]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings("db", settings)["status"] == "succeeded"
            assert c.add_documents("db", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("db"), apps[0].scheduler.index("db")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("rust search engine", "cloud database"):
            for ratio in (1.0, 0.5):
                for filt in (None, "points > 1000"):
                    body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                            "showRankingScore": True, "limit": 20}
                    if filt:
                        body["filter"] = filt
                    want, got = (c.post("/indexes/db/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
