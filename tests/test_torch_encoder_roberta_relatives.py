"""data2vec-text, XLM-RoBERTa-XL and BigBird (full attention) in the text
encoder (K8): three of RoBERTa's relatives that models/bert.py runs, their
weight names, BigBird's Unigram tokenizer.json layout and class specials,
and the encoder against transformers and the JAX package's
`FlaxTextEncoder`.

Nothing is downloaded. Tiny models (2 layers, hidden 32, 4 heads,
intermediate 64), weights drawn with numpy from a seed (Q and K with a
standard deviation of 0.15, so attention is peaked):
- data2vec-text (RoBERTa's layers and positions from pad id 1) beside a
  seeded byte-level BPE tokenizer.json and a tokenizer_config.json that
  names no class (AutoTokenizer's default for the type is RoBERTa's);
- XLM-RoBERTa-XL (XLM-R's positions, no embedding LayerNorm, a LayerNorm
  before self-attention and one before the intermediate in each layer, a
  final LayerNorm), also with relative keys, beside a seeded Unigram
  tokenizer.json in XLM-R's layout;
- BigBird (positions from 0, `gelu_new`, two token types, pad id 0):
  `original_full` with `rescale_embeddings`, `block_sparse` at the
  published block 64 and 3 random blocks (a threshold of 704 tokens), and
  block 32 with 6 random blocks (544), each of which transformers runs
  with full attention at the encoder's 512 tokens (thresholds under 512,
  which run sparse, are tests/test_torch_encoder_bigbird_sparse.py's),
  beside a seeded Unigram
  tokenizer.json in `BigBirdConverter`'s layout (held here against the
  converter on a sentencepiece `ModelProto` built with transformers' own
  protobuf module). BigBird references are written as pytorch_model.bin:
  from a model.safetensors the JAX package's encoder takes its Flax branch
  and raises (fault 3.27, pinned here).
transformers has no Flax model of the first two, so the JAX package's
encoder runs the torch model of each. The port is held against
transformers on every row and against the JAX package's vectors within
1e-5 under both poolings; the tokenizers against `AutoTokenizer`."""

import json
import os
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    bert,
    bpe,
    checkpoint,
    fixtures,
    hf_encoder,
)
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "recherche", "données"]
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-éèàçï"
TEXTS = ["<mask> and <s> inside </s> <pad> <unk>", "hello <mask> world", "x<mask>y  <mask>  z",
         "[CLS] x [SEP] y [MASK] z", "x[MASK]y  [MASK]  z", "runs    of   spaces and ✈ unknown",
         "", "  leading and trailing  ", "Café naïve — déjà vu"]
# published config.json widths
DATA2VEC_TEXT_BASE = {
    "model_type": "data2vec-text", "vocab_size": 50265, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu"}
XLM_ROBERTA_XL = {
    "model_type": "xlm-roberta-xl", "vocab_size": 250880, "hidden_size": 2560,
    "num_hidden_layers": 36, "num_attention_heads": 32, "intermediate_size": 10240,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu"}
BIGBIRD_ROBERTA_BASE = {
    "model_type": "big_bird", "vocab_size": 50358, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu_new",
    "max_position_embeddings": 4096, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
    "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2, "sep_token_id": 66,
    "attention_type": "block_sparse", "block_size": 64, "num_random_blocks": 3,
    "rescale_embeddings": False, "use_bias": True}


def _texts(n, seed, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, hi, n)]


def _pieces() -> list:
    rng = np.random.default_rng(5)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:]]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


BPE_SPEC = fixtures.roberta_tokenizer_json(_texts(200, seed=1) + TEXTS, 600, seed=2)
XLMR_SPEC = fixtures.xlmr_tokenizer_json(_pieces())
BIGBIRD_SPEC = fixtures.bigbird_tokenizer_json(_pieces())
XLMR_CONFIG = {"tokenizer_class": "XLMRobertaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
               "sep_token": "</s>", "cls_token": "<s>", "unk_token": "<unk>",
               "pad_token": "<pad>", "mask_token": "<mask>"}
TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 64}


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if "LayerNorm.weight" in name or "layer_norm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, spec, config):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)


def _roberta_widths(vocab):
    return dict(vocab_size=vocab, max_position_embeddings=514, type_vocab_size=1,
                layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2, **TINY)


def _bigbird_config(**over):
    return transformers.BigBirdConfig(
        vocab_size=len(BIGBIRD_SPEC["model"]["vocab"]), max_position_embeddings=512,
        **TINY, **over)


# kind -> (transformers config, weights' seed, file: safetensors or not,
# tokenizer.json, tokenizer_config.json)
def _checkpoints():
    n_bpe, n_xlmr = len(BPE_SPEC["model"]["vocab"]), len(XLMR_SPEC["model"]["vocab"])
    bigbird_tok = fixtures.bigbird_tokenizer_config(BIGBIRD_SPEC)
    return {
        "d2v": (transformers.Data2VecTextConfig(**_roberta_widths(n_bpe)), 41, True,
                BPE_SPEC, {"add_prefix_space": False}),
        "xl": (transformers.XLMRobertaXLConfig(**_roberta_widths(n_xlmr)), 42, True,
               XLMR_SPEC, XLMR_CONFIG),
        "xl_rel": (transformers.XLMRobertaXLConfig(
            **_roberta_widths(n_xlmr), position_embedding_type="relative_key_query"), 43, True,
            XLMR_SPEC, XLMR_CONFIG),
        "bb_full": (_bigbird_config(attention_type="original_full", rescale_embeddings=True), 44,
                    False, BIGBIRD_SPEC, bigbird_tok),
        "bb_sparse": (_bigbird_config(), 45, False, BIGBIRD_SPEC, bigbird_tok),
        "bb_544": (_bigbird_config(block_size=32, num_random_blocks=6), 46, False,
                   BIGBIRD_SPEC, bigbird_tok),
    }


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Each of `_checkpoints()` as transformers saves it; `bb_st`:
    `bb_full` as model.safetensors; `*_port`: the port's write_checkpoint
    of `d2v`, `xl` and `bb_full`. Each with its tokenizer files."""
    root = tmp_path_factory.mktemp("relatives")
    out = {}
    for kind, (config, seed, safe, spec, tok_config) in _checkpoints().items():
        model = transformers.AutoModel.from_config(config)
        _draw_weights(model, seed)
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=safe)
        _write_tokenizer(out[kind], spec, tok_config)
        if kind == "bb_full":
            out["bb_st"] = str(root / "bb_st")
            model.save_pretrained(out["bb_st"], safe_serialization=True)
            _write_tokenizer(out["bb_st"], spec, tok_config)
    for kind, spec in (("d2v", BPE_SPEC), ("xl", XLMR_SPEC), ("bb_full", BIGBIRD_SPEC)):
        c = checkpoint.load_checkpoint(out[kind])
        out[f"{kind}_port"] = str(root / f"{kind}_port")
        checkpoint.write_checkpoint(out[f"{kind}_port"], c.config, c.state_dict,
                                    tokenizer_json=spec)
    return out


def _batch(seed=9):
    """Padded texts of every family's specials, and a row over 64 tokens."""
    return _texts(5, seed) + TEXTS + [" ".join(WORDS * 4)]


# -- configs, modules and weight names --------------------------------------------


def test_each_config_reads_as_its_family(ckpt):
    c = checkpoint.load_checkpoint(ckpt["d2v"])
    model = checkpoint.build_model(c)
    assert isinstance(model, bert.BertModel) and model.embeddings.padding_idx == 1
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE) and (tok.before, tok.after, tok.pad) == ([0], [2], 1)
    c = checkpoint.load_checkpoint(ckpt["xl"])
    model = checkpoint.build_model(c)
    assert model.embeddings.padding_idx == 1 and model.embeddings.LayerNorm is None
    layer = model.encoder.layer[0]
    assert layer.attention.ln is not None and layer.ln is not None
    assert layer.attention.output.LayerNorm is None and layer.output.LayerNorm is None
    assert model.encoder.ln is not None
    assert isinstance(checkpoint.build_tokenizer(c), Unigram)
    for kind, scale in (("bb_full", 32 ** 0.5), ("bb_sparse", None), ("bb_544", None)):
        c = checkpoint.load_checkpoint(ckpt[kind])
        model = checkpoint.build_model(c)
        assert model.embeddings.padding_idx is None  # positions 0..L-1
        assert model.embeddings.scale == scale
        assert model.config["hidden_act"] == "gelu_new"
        tok = checkpoint.build_tokenizer(c)
        ids = {t: tok.token_to_id(t) for t in ("[CLS]", "[SEP]", "<pad>")}
        assert isinstance(tok, Unigram) and (tok.before, tok.after, tok.pad) == (
            [ids["[CLS]"]], [ids["[SEP]"]], ids["<pad>"])


@pytest.mark.parametrize("published", [DATA2VEC_TEXT_BASE, XLM_ROBERTA_XL, BIGBIRD_ROBERTA_BASE],
                         ids=["data2vec-text-base", "xlm-roberta-xl", "bigbird-roberta-base"])
def test_the_published_widths_give_transformers_names(published):
    """facebook/data2vec-text-base's, facebook/xlm-roberta-xl's and
    google/bigbird-roberta-base's config.json: the module's parameters are
    transformers' (under the port's names for XLM-RoBERTa-XL's pre-norms),
    shape for shape, the pooler left out (both built on the meta device)."""
    with torch.device("meta"):
        ours = bert.BertModel(published).state_dict()
        config = transformers.AutoConfig.for_model(**published)
        theirs = transformers.AutoModel.from_config(config).state_dict()
    renamed = {}
    for name, value in theirs.items():  # each name through the port's mapping
        for ours_name in checkpoint.hf_to_state_dict({name: torch.zeros(1)},
                                                     published["model_type"]):
            renamed[ours_name] = value.shape
    renamed = {k: v for k, v in renamed.items() if not k.startswith("pooler.")}
    assert set(ours) == set(renamed)
    assert all(ours[k].shape == renamed[k] for k in ours)


def test_xlm_roberta_xl_names_map_by_where_the_norms_run(ckpt):
    """`attention.self_attn_layer_norm` (before self-attention) is the
    port's `attention.ln`, the layer's own `LayerNorm` (before the
    intermediate) its `ln`, `encoder.LayerNorm` its `encoder.ln`; the
    port's write names them back."""
    named = transformers.AutoModel.from_pretrained(ckpt["xl"]).state_dict()
    state = checkpoint.hf_to_state_dict(named, "xlm-roberta-xl")
    pairs = {"encoder.layer.1.attention.self_attn_layer_norm.weight":
             "encoder.layer.1.attention.ln.weight",
             "encoder.layer.1.LayerNorm.bias": "encoder.layer.1.ln.bias",
             "encoder.LayerNorm.weight": "encoder.ln.weight"}
    for theirs, ours in pairs.items():
        assert torch.equal(state[ours], named[theirs])
    assert not any("LayerNorm" in k for k in state)
    ref, info = transformers.AutoModel.from_pretrained(ckpt["xl_port"], output_loading_info=True)
    assert type(ref).__name__ == "XLMRobertaXLModel"
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias"}
    assert not info["unexpected_keys"]


@pytest.mark.parametrize("kind, cls", [
    ("d2v", "Data2VecTextForMaskedLM"), ("xl", "XLMRobertaXLForMaskedLM"),
    ("bb_full", "BigBirdForMaskedLM"), ("bb_sparse", "BigBirdForPreTraining"),
])
def test_head_checkpoints_load_under_the_base_names(ckpt, kind, cls):
    """The `data2vec_text.`, `roberta.` and `bert.` prefixes are dropped,
    and so are the heads; the torch state_dict's numpy arrays (what the JAX
    package holds) map onto the same tensors."""
    model_type = checkpoint.load_checkpoint(ckpt[kind]).config["model_type"]
    state = checkpoint.read_weights(ckpt[kind], model_type)
    named = getattr(transformers, cls).from_pretrained(ckpt[kind]).state_dict()
    assert any(k.startswith(("lm_head.", "cls.")) for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors, model_type)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


@pytest.mark.parametrize("kind", ["d2v_port", "bb_full_port"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == {"d2v_port": "Data2VecTextModel",
                                  "bb_full_port": "BigBirdModel"}[kind]
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias",
                                         "pooler.weight", "pooler.bias"}
    assert not info["unexpected_keys"]
    assert os.listdir(ckpt[kind]).count("pytorch_model.bin") == 1


# -- BigBird's attention type and threshold ----------------------------------------


@pytest.mark.parametrize("block, blocks, threshold", [(64, 3, 704), (32, 6, 544), (64, 2, 576)])
def test_a_threshold_of_512_or_more_runs_full_attention(block, blocks, threshold):
    """At or above 512 the reference falls back to full attention on every
    batch the encoder gives it, and stays there; the port runs the same
    full attention at 512 tokens, and a longer batch than the threshold
    (the module alone: the encoder stops at 512) sparse, as a fresh
    reference does (tests/test_torch_encoder_bigbird_sparse.py holds
    thresholds under 512)."""
    config = {**BIGBIRD_ROBERTA_BASE, **TINY, "vocab_size": 100, "max_position_embeddings": 1024,
              "block_size": block, "num_random_blocks": blocks}
    assert bert.sparse_threshold(bert.check_config(config)) == threshold
    model = bert.BertModel(config)
    for n, kind in ((512, "original_full"), (threshold + 1, "block_sparse")):
        ref = transformers.BigBirdModel(transformers.BigBirdConfig(**config)).eval()
        _draw_weights(ref, 47)
        state = checkpoint.hf_to_state_dict(ref.state_dict(), "big_bird")
        model.load_state_dict({k: v for k, v in state.items() if not k.startswith("pooler.")})
        ids, mask = torch.full((2, n), 5), torch.ones(2, n, dtype=torch.long)
        mask[1, n // 3:] = 0
        with torch.no_grad():
            want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
            got = model(ids, mask)
        assert ref.attention_type == kind
        assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("change, match", [
    ({"attention_type": "sparse"}, "attention_type `sparse`"),
    ({"use_bias": False}, "use_bias false"),
    ({"position_embedding_type": "relative_key"}, "position_embedding_type"),
])
def test_unread_bigbird_configs_are_refused(change, match):
    with pytest.raises(ValueError, match=match):
        bert.BertModel({**BIGBIRD_ROBERTA_BASE, **TINY, "vocab_size": 100, **change})


# -- the forward and the encoder ----------------------------------------------------


def _reference(path):
    return transformers.AutoModel.from_pretrained(path).eval()


@pytest.mark.parametrize("kind", ["d2v", "xl", "xl_rel", "bb_full", "bb_sparse", "bb_544"])
def test_forward_matches_transformers_torch(ckpt, kind):
    """Padded batches, every special, on every row (padded rows too)."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    with torch.no_grad():
        want = _reference(ckpt[kind])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["d2v", "d2v_port", "xl", "xl_port", "xl_rel", "bb_full",
                                  "bb_sparse", "bb_544", "bb_full_port"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch, pooled and normalized; the port's
    own writing of each checkpoint embeds as the original."""
    texts = _batch(seed=10)
    source = kind.removesuffix("_port")
    jax_enc = FlaxTextEncoder(ckpt[source], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and jax_enc._torch is not None
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_fault_327_the_jax_flax_branch_raises_on_bigbird_safetensors(ckpt):
    """From a model.safetensors FlaxAutoModel loads BigBird, and the JAX
    package's `module.apply(params, input_ids, attention_mask)` lacks
    FlaxBigBirdModule's token_type_ids, position_ids and head_mask: it
    raises. The port embeds that directory as the JAX package's torch
    branch embeds the pytorch_model.bin one."""
    jax_enc = FlaxTextEncoder(ckpt["bb_st"], "useModel")
    with pytest.raises(TypeError, match="token_type_ids"):
        jax_enc.encode(["hello world"])
    assert jax_enc._flax is not None
    texts = _batch()
    want = FlaxTextEncoder(ckpt["bb_full"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt["bb_st"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


# -- the tokenizers ------------------------------------------------------------------


@pytest.mark.parametrize("kind, cls", [
    ("d2v", "RobertaTokenizerFast"), ("d2v_port", "RobertaTokenizerFast"),
    ("xl", "XLMRobertaTokenizerFast"), ("bb_full", "BigBirdTokenizerFast"),
    ("bb_full_port", "BigBirdTokenizerFast"),
])
def test_tokenizer_matches_autotokenizer(ckpt, kind, cls):
    """Ids and masks text by text and as padded batches cut at 512 and at
    8 tokens: data2vec-text's RoBERTa BPE (the type's default class),
    XLM-R-XL's Unigram, BigBird's `[CLS] $A [SEP]` and `[MASK]` with
    lstrip."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == cls
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    for text in TEXTS:
        assert tok([text], 512)[0].tolist() == ref([text], truncation=True,
                                                   max_length=512)["input_ids"], text
    texts = TEXTS + _batch() + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


@pytest.mark.parametrize("config", [{}, {"mask_token": "[MASK]", "cls_token": "[CLS]"},
                                    {"mask_token": {"__type": "AddedToken", "content": "[MASK]", "lstrip": False,
                                                    "rstrip": False, "normalized": False,
                                                    "single_word": False, "special": True}}],
                         ids=["class-defaults", "strings", "mask-without-lstrip"])
def test_bigbird_class_specials_stand_in_for_missing_added_tokens(ckpt, tmp_path, config):
    """A tokenizer.json whose added tokens lack `[MASK]`, `[SEP]` and
    `<s>`: BigBirdTokenizerFast adds its special tokens (a string
    `[MASK]` with lstrip, a dict with its own flags), and so does the
    port."""
    spec = dict(BIGBIRD_SPEC, added_tokens=[t for t in BIGBIRD_SPEC["added_tokens"]
                                            if t["content"] not in ("[MASK]", "[SEP]", "<s>")])
    path = tmp_path / "bb"
    _write_tokenizer(str(path), spec, {"tokenizer_class": "BigBirdTokenizerFast", **config})
    os.link(os.path.join(ckpt["bb_full"], "config.json"), path / "config.json")
    os.link(os.path.join(ckpt["bb_full"], "pytorch_model.bin"), path / "pytorch_model.bin")
    ref = transformers.AutoTokenizer.from_pretrained(str(path))
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(str(path)))
    texts = TEXTS + ["a [MASK] b [SEP] c <s> d", "x  [MASK]"]
    want = ref(texts, padding=True, truncation=True, max_length=512)
    ids, mask = tok(texts, 512)
    assert ids.tolist() == want["input_ids"]
    assert mask.tolist() == want["attention_mask"]


def test_a_bigbird_class_over_another_tokenizer_is_refused(ckpt, tmp_path):
    """BigBirdTokenizer(Fast) reads a Unigram tokenizer.json; over a BPE one
    the port refuses it by name."""
    path = tmp_path / "bpe"
    _write_tokenizer(str(path), BPE_SPEC, {"tokenizer_class": "BigBirdTokenizer"})
    for name in ("config.json", "pytorch_model.bin"):
        os.link(os.path.join(ckpt["bb_full"], name), path / name)
    with pytest.raises(ValueError, match="BigBirdTokenizer` over a BPE tokenizer"):
        checkpoint.load_checkpoint(str(path))


def _spm_model(path, pieces, unk_id):
    """A sentencepiece Unigram ModelProto of (piece, score, type) written
    with transformers' protobuf module (no sentencepiece needed)."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    m.trainer_spec.model_type = 1  # Unigram
    m.trainer_spec.unk_id = unk_id
    for piece, score, kind in pieces:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


def _float32_scores(spec):
    """`spec` with its pieces' scores as float32, as the sentencepiece
    model holds them (`tokenizers` writes them back with 15 digits)."""
    model = dict(spec["model"], vocab=[[p, np.float32(s)] for p, s in spec["model"]["vocab"]])
    return dict(spec, model=model)


@pytest.mark.parametrize("n_pieces", [20, None])
def test_the_bigbird_fixture_is_the_converters_file(tmp_path, n_pieces):
    """`bigbird_tokenizer_json` equals what `BigBirdConverter` and
    `BigBirdTokenizerFast.save_pretrained` write for a sentencepiece model
    of the same pieces (the specials control pieces, `<unk>` the unknown
    one; `[CLS] [SEP] [MASK]` at 65-67, or after all of a shorter
    vocabulary), and `bigbird_tokenizer_config` what it writes beside it."""
    from transformers.convert_slow_tokenizer import BigBirdConverter

    vocab = _pieces()[:n_pieces]
    spec = fixtures.bigbird_tokenizer_json(vocab)
    pieces = [(p, s, {"<unk>": 2}.get(p, 3 if p in fixtures.BIGBIRD_HEAD + fixtures.BIGBIRD_MARKS
                                       else 1)) for p, s in spec["model"]["vocab"]]
    _spm_model(str(tmp_path / "spiece.model"), pieces, 3)
    index = {p: i for i, (p, _s, _t) in enumerate(pieces)}
    assert index["[SEP]"] == (66 if n_pieces is None else len(fixtures.BIGBIRD_HEAD) + 21)
    slow = types.SimpleNamespace(vocab_file=str(tmp_path / "spiece.model"),
                                 convert_tokens_to_ids=lambda t: index[t])
    out = str(tmp_path / "out")
    transformers.BigBirdTokenizerFast(
        tokenizer_object=BigBirdConverter(slow).converted()).save_pretrained(out)
    with open(os.path.join(out, "tokenizer.json"), encoding="utf-8") as f:
        written = json.load(f)
    assert _float32_scores(written) == _float32_scores(spec)
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        config = json.load(f)
    del config["model_max_length"]
    mine = fixtures.bigbird_tokenizer_config(spec)
    assert mine.pop("model_max_length") == 4096 and config == mine
