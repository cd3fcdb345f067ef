"""SqueezeBERT and XLM in the text encoder (K8): the port's `squeezebert`
(models/squeezebert.py: grouped 1 x 1 convolutions in NCW layout,
models/conv.py) and `xlm` (models/xlm.py: token types looked up in the word
table, the masked rows, sinusoidal tables read from the file, `causal`)
model types, their weight names, XLM's own Moses tokenizer read from a
named or a legacy directory, and the encoder against transformers and the
JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny models (2 layers, width 32, 4 heads) are
built from transformers' configs, their weights drawn with numpy from a
seed (LayerNorm scales near 1, every bias off zero, Q and K with a
standard deviation of 0.15), beside a WordPiece vocab.txt:
- `sq_uncased`: squeezebert-uncased's groups (q, k, v 4, post-attention
  1, intermediate and output 4);
- `sq_mixed`: groups 2, 4, 8, 2, 8 and 4, `gelu_new`;
- `xlm_en`: xlm-mlm-en-2048's flags (learned positions, GELU, one
  language), with `BertTokenizerFast`, whose zero token types add word
  row 0 (`<s>`) to every token in the reference;
- `xlm_sin`: `sinusoidal_embeddings`, ReLU, two languages (the language
  table held, never read);
- `xlm_causal`: `causal`;
- `xlm_xlmr`: `xlm_en`'s weights with an XLM-R Unigram tokenizer.json,
  whose class passes no token types: no type row is added.
Each is saved as pytorch_model.bin (the JAX package's torch branch:
transformers has no Flax SqueezeBERT or XLM); `sq_uncased` and `xlm_en`
also as model.safetensors and as the port's `write_checkpoint` writes
them. Every grouped test uses groups above 1, where a grouped
convolution read as a dense product goes wrong."""

import json
import os
import shutil
import string

import numpy as np
import pytest
import torch
import torch.nn.functional as F

transformers = pytest.importorskip("transformers")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    checkpoint,
    conv,
    fixtures,
    hf_encoder,
    squeezebert,
    xlm,
)

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "run", "##ning", "##s", "the", "a", "of", "cafe", "gpu"]
# XLM's vocabulary opens with <s>, </s> and its pad (pad_index 2)
VOCAB = list(dict.fromkeys(
    ["<s>", "</s>", "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    + list(string.ascii_lowercase + string.digits + string.punctuation + "中文éü")
    + ["##" + c for c in string.ascii_lowercase + string.digits]
))
TEXTS = ["Hello, World!", "Café naïve — RÉSUMÉ", "中文 search中文", "running [MASK] engines",
         "", "gpu " * 40]
SQUEEZE = {
    "sq_uncased": dict(),
    "sq_mixed": dict(q_groups=2, k_groups=4, v_groups=8, post_attention_groups=2,
                     intermediate_groups=8, output_groups=4, hidden_act="gelu_new"),
}
XLM = {
    "xlm_en": dict(),
    "xlm_sin": dict(sinusoidal_embeddings=True, gelu_activation=False, n_langs=2),
    "xlm_causal": dict(causal=True),
}
SQUEEZEBERT_UNCASED = {  # squeezebert/squeezebert-uncased's config.json
    "model_type": "squeezebert", "vocab_size": 30528, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "hidden_act": "gelu", "max_position_embeddings": 512, "type_vocab_size": 2,
    "embedding_size": 768, "q_groups": 4, "k_groups": 4, "v_groups": 4,
    "post_attention_groups": 1, "intermediate_groups": 4, "output_groups": 4,
    "layer_norm_eps": 1e-12, "pad_token_id": 0,
}
XLM_EN_2048 = {  # FacebookAI/xlm-mlm-en-2048's config.json (XLMConfig's names)
    "model_type": "xlm", "n_words": 30145, "emb_dim": 2048, "n_layers": 12, "n_heads": 16,
    "gelu_activation": True, "sinusoidal_embeddings": False, "causal": False,
    "n_langs": 1, "use_lang_emb": True, "max_position_embeddings": 512,
    "layer_norm_eps": 1e-12, "pad_index": 2, "pad_token_id": 2, "is_encoder": True,
}


def _config(kind):
    if kind in SQUEEZE:
        return transformers.SqueezeBertConfig(
            vocab_size=len(VOCAB), hidden_size=32, embedding_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, max_position_embeddings=128,
            **SQUEEZE[kind])
    return transformers.XLMConfig(vocab_size=len(VOCAB), emb_dim=32, n_layers=2, n_heads=4,
                                  max_position_embeddings=128, pad_index=2, **XLM[kind])


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else (biases too) normal(0, 0.05); but a
    sinusoidal position table, which transformers fills and never trains."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "position_embeddings.weight" and model.config.sinusoidal_embeddings:
                continue
            query_key = name.endswith(("query.weight", "key.weight", "q_lin.weight",
                                       "k_lin.weight"))
            draw = rng.normal(0.0, 0.15 if query_key else 0.05, tuple(p.shape))
            if name.endswith(("LayerNorm.weight", "layernorm.weight", "layer_norm_emb.weight")) \
                    or ".layer_norm1." in name and name.endswith("weight") \
                    or ".layer_norm2." in name and name.endswith("weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path):
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in VOCAB))
    transformers.BertTokenizerFast(os.path.join(path, "vocab.txt"),
                                   do_lower_case=True).save_pretrained(path)


def _xlmr_spec():
    pieces = [("▁" + w.strip("#"), -float(i + 1)) for i, w in enumerate(WORDS)]
    pieces += [(c, -20.0) for c in string.ascii_lowercase] + [("▁", -5.0)]
    return fixtures.xlmr_tokenizer_json(pieces)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """For each of SQUEEZE and XLM a pytorch_model.bin directory;
    `sq_uncased_st`, `xlm_en_st` as model.safetensors; `sq_uncased_port`,
    `xlm_en_port` the port's write_checkpoint; `xlm_xlmr`: `xlm_en` with an
    XLM-R Unigram tokenizer.json."""
    root = tmp_path_factory.mktemp("squeezebert_xlm")
    out = {}
    for seed, kind in enumerate([*SQUEEZE, *XLM], start=61):
        model = transformers.AutoModel.from_config(_config(kind))
        _draw_weights(model, seed)
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=False)
        _write_tokenizer(out[kind])
        if kind in ("sq_uncased", "xlm_en"):
            out[f"{kind}_st"] = str(root / f"{kind}_st")
            model.save_pretrained(out[f"{kind}_st"], safe_serialization=True)
            _write_tokenizer(out[f"{kind}_st"])
            c = checkpoint.load_checkpoint(out[kind])
            out[f"{kind}_port"] = str(root / f"{kind}_port")
            checkpoint.write_checkpoint(out[f"{kind}_port"], c.config, c.state_dict, vocab=VOCAB)
    out["xlm_xlmr"] = str(root / "xlm_xlmr")
    os.makedirs(out["xlm_xlmr"])
    shutil.copy(os.path.join(out["xlm_en"], "config.json"), out["xlm_xlmr"])
    shutil.copy(os.path.join(out["xlm_en"], "pytorch_model.bin"), out["xlm_xlmr"])
    spec = _xlmr_spec()
    with open(os.path.join(out["xlm_xlmr"], "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(out["xlm_xlmr"], "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "XLMRobertaTokenizerFast", "bos_token": "<s>",
                   "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>",
                   "unk_token": "<unk>", "pad_token": "<pad>", "mask_token": "<mask>"}, f)
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS[:10], size=int(k))) for k in rng.integers(0, hi, n)]


def _batch():
    return _texts(5, seed=9) + TEXTS


# -- the grouped convolution --------------------------------------------------------


@pytest.mark.parametrize("channels, out, groups, kernel", [
    (32, 32, 4, 1), (32, 64, 8, 1), (64, 32, 4, 1), (32, 32, 1, 3), (32, 32, 2, 3),
    (48, 48, 3, 5),
])
def test_the_grouped_product_is_conv1d(channels, out, groups, kernel):
    """models/conv.py's grouped product against torch's own `Conv1d`
    (stride 1, padding (k - 1) / 2) within a millionth of the output's
    largest value, and a dense product of the same weights is not it."""
    g = torch.Generator().manual_seed(channels + groups)
    x = torch.randn(3, channels, 17, generator=g)
    w = torch.randn(out, channels // groups, kernel, generator=g)
    b = torch.randn(out, generator=g)
    pad = (kernel - 1) // 2
    want = F.conv1d(x, w, b, padding=pad, groups=groups)
    got = conv.conv1d(x, w, b, pad, groups)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    module = conv.Conv1d(channels, out, kernel, padding=pad, groups=groups)
    assert module.weight.shape == w.shape
    if groups > 1 and kernel == 1:
        dense = torch.einsum("oc,ncw->now", w[:, :, 0].repeat(1, groups), x) + b[:, None]
        assert float((dense - want).abs().max()) > 1e-2


# -- configs, modules and weight names ----------------------------------------------


def test_the_published_widths_give_squeezebert_uncased():
    with torch.device("meta"):
        ours = squeezebert.SqueezeBertModel(SQUEEZEBERT_UNCASED).state_dict()
        theirs = transformers.SqueezeBertModel(
            transformers.SqueezeBertConfig(**SQUEEZEBERT_UNCASED)).state_dict()
    assert set(ours) == set(theirs) - {"embeddings.position_ids", "pooler.dense.weight",
                                       "pooler.dense.bias"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["encoder.layers.0.attention.query.weight"].shape == (768, 192, 1)
    assert ours["encoder.layers.0.post_attention.conv1d.weight"].shape == (768, 768, 1)


def test_the_published_widths_give_xlm_mlm_en_2048():
    """XLMConfig's `n_words` stands for `vocab_size`; the FFN is 4 x
    emb_dim wide; names and shapes are XLMModel's."""
    config = xlm.check_config(XLM_EN_2048)
    assert (config["vocab_size"], config["hidden_size"], config["intermediate_size"]) == (
        30145, 2048, 8192)
    with torch.device("meta"):
        ours = xlm.XLMModel(XLM_EN_2048).state_dict()
        theirs = transformers.XLMModel(transformers.XLMConfig(**XLM_EN_2048)).state_dict()
    assert set(ours) == set(theirs) - {"position_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["embeddings.weight"].shape == (30145, 2048)


@pytest.mark.parametrize("alias, name", sorted(xlm.ALIASES.items()))
def test_xlm_aliases_win_as_transformers_sets_them(alias, name):
    """A file's `hidden_size` (...) sets `emb_dim` (...) after it, as
    `PretrainedConfig.__init__` sets its kwargs last."""
    config = {**XLM_EN_2048, "vocab_size": 100, "emb_dim": 64, "n_heads": 4, "n_layers": 2,
              alias: {"hidden_size": 32, "num_attention_heads": 2, "num_hidden_layers": 1,
                      "n_words": 50}[alias]}
    theirs = transformers.XLMConfig(**config)
    assert xlm.check_config(config)[name] == getattr(theirs, name)


@pytest.mark.parametrize("kind, change, match", [
    ("sq_uncased", {"embedding_size": 16}, "embedding_size"),
    ("sq_uncased", {"q_groups": 3}, "q_groups"),
    ("sq_uncased", {"intermediate_groups": 5}, "intermediate_groups"),
    ("sq_uncased", {"hidden_act": "gelu_10"}, "hidden_act"),
    ("xlm_en", {"is_encoder": False}, "is_encoder"),
    ("xlm_en", {"n_heads": 5}, "n_heads"),
])
def test_unread_configs_are_refused(ckpt, kind, change, match):
    config = {**checkpoint.load_checkpoint(ckpt[kind]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


@pytest.mark.parametrize("kind, cls, heads", [
    ("sq_uncased", "SqueezeBertForMaskedLM", ("cls.",)),
    ("sq_uncased", "SqueezeBertForSequenceClassification", ("classifier.",)),
    ("xlm_en", "XLMWithLMHeadModel", ("pred_layer.",)),
    ("xlm_en", "XLMForSequenceClassification", ("sequence_summary.",)),
])
def test_head_checkpoints_load_under_the_base_names(ckpt, kind, cls, heads):
    """The `transformer.` prefix and the heads are dropped, from torch
    tensors and numpy arrays (a classifier's own `classifier.` included)."""
    state = checkpoint.read_weights(ckpt[kind])
    named = getattr(transformers, cls).from_pretrained(ckpt[kind]).state_dict()
    assert any(k.startswith("transformer.") for k in named)
    assert any(k.startswith(heads) for k in named)
    named = {k: v for k, v in named.items() if not k.startswith("classifier.")}
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


# -- XLM's tokenizers ------------------------------------------------------------


def _moses_directories(ckpt, root):
    """`xlm_en`'s weights beside XLM's own tokenizer files (a seeded BPE in
    XLM's layout, `fixtures.moses_bpe_files`, as many entries as the word
    table): `named`, its tokenizer_config.json naming XLMTokenizer;
    `legacy`, vocab.json and merges.txt alone (AutoTokenizer's class for
    the model type)."""
    vocab, merges = fixtures.moses_bpe_files(TEXTS + _texts(40, seed=5), len(VOCAB), 5,
                                             n_trained=60, counts=True)
    out = {}
    for name in ("named", "legacy"):
        out[name] = path = os.path.join(root, name)
        os.makedirs(path)
        shutil.copy(os.path.join(ckpt["xlm_en"], "config.json"), path)
        shutil.copy(os.path.join(ckpt["xlm_en"], "pytorch_model.bin"), path)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write(merges)
    with open(os.path.join(out["named"], "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "XLMTokenizer", "do_lowercase_and_remove_accent": True},
                  f)
    return out


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", ["named", "legacy"])
def test_an_xlm_tokenizer_directory_embeds(ckpt, tmp_path, name, pooling, monkeypatch):
    """XLM's own tokenizer (`XLMTokenizer`: Moses and a `</w>` BPE), named
    in tokenizer_config.json or, with none named, AutoTokenizer's class for
    the model type, tokenizes as transformers' class and embeds as the JAX
    package; its vocab.json and merges.txt are never read as RoBERTa's
    byte-level BPE."""
    monkeypatch.setattr(checkpoint, "legacy_spec", None)  # calling it raises
    path = _moses_directories(ckpt, str(tmp_path))[name]
    texts = _batch()
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == "XLMTokenizer"
    enc = hf_encoder.TextEncoder(path, pooling, device=None)
    enc._load()
    ids, mask, types = enc.tokenize(texts)
    want = ref(texts, padding=True, truncation=True, max_length=512, return_tensors="pt")
    assert torch.equal(ids, want["input_ids"]) and torch.equal(mask, want["attention_mask"])
    assert torch.equal(types, want["token_type_ids"])
    got = enc.encode(texts)
    assert float(np.abs(got - FlaxTextEncoder(path, pooling).encode(texts)).max()) <= ATOL


@pytest.mark.parametrize("kind, typed", [("xlm_en", True), ("xlm_xlmr", False),
                                         ("sq_uncased", False)])
def test_the_token_types_reach_the_models_that_read_them(ckpt, kind, typed):
    """BertTokenizerFast gives token types, so XLM is passed its zeros;
    XLMRobertaTokenizerFast gives none (the reference passes none);
    SqueezeBERT reads type row 0 either way."""
    enc = hf_encoder.TextEncoder(ckpt[kind], "useModel", device=None)
    enc._load()
    assert enc._types is typed
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert ("token_type_ids" in ref(["hello"])) is (typed or kind == "sq_uncased")
    _ids, _mask, tt = enc.tokenize(["hello world", "rust"])
    assert (tt is not None) is typed and (tt is None or not bool(tt.any()))


def test_xlm_adds_the_word_row_of_each_type(ckpt):
    """XLM looks its token types up in the word table: zeros add word row
    0 to every token, so the output moves with that row, and equals
    AutoModel's with and without types."""
    c = checkpoint.load_checkpoint(ckpt["xlm_en"])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    zeros = torch.zeros_like(ids)
    ref = transformers.AutoModel.from_pretrained(ckpt["xlm_en"]).eval()
    model = checkpoint.build_model(c)
    with torch.no_grad():
        for tt in (zeros, None):
            want = ref(input_ids=ids, attention_mask=mask, token_type_ids=tt).last_hidden_state
            got = model(ids, mask, tt)
            assert float((got - want).abs().max()) <= ATOL
        assert float((model(ids, mask, zeros) - model(ids, mask)).abs().max()) > 1e-2


def test_xlm_never_reads_its_language_table(ckpt):
    """With two languages the table is held (loaded by name) but the
    reference passes no `langs`: moving it moves neither output."""
    c = checkpoint.load_checkpoint(ckpt["xlm_sin"])
    model = checkpoint.build_model(c)
    assert model.lang_embeddings.weight.shape == (2, 32)
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    ref = transformers.AutoModel.from_pretrained(ckpt["xlm_sin"]).eval()
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        ref.lang_embeddings.weight.add_(1.0)
        assert torch.equal(ref(input_ids=ids, attention_mask=mask).last_hidden_state, want)
        model.lang_embeddings.weight = torch.nn.Parameter(model.lang_embeddings.weight + 1.0)
        assert float((model(ids, mask) - want).abs().max()) <= ATOL


def test_a_sinusoidal_table_is_read_from_the_file(ckpt, tmp_path):
    """`sinusoidal_embeddings` fills the table at init; a checkpoint's own
    table wins on load (transformers 4.57.6) and the port reads it."""
    path = str(tmp_path / "moved")
    shutil.copytree(ckpt["xlm_sin"], path)
    state = torch.load(os.path.join(path, "pytorch_model.bin"), weights_only=True)
    table = state["position_embeddings.weight"]
    fresh = transformers.XLMModel(_config("xlm_sin")).position_embeddings.weight
    assert torch.equal(table, fresh.detach())  # the sinusoid, as saved
    state["position_embeddings.weight"] = table.flip(0).contiguous()
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert torch.equal(ref.position_embeddings.weight, state["position_embeddings.weight"])
    c = checkpoint.load_checkpoint(path)
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", [*SQUEEZE, *XLM])
def test_forward_matches_automodel(ckpt, kind):
    """AutoModel's last hidden state on every row of a padded batch, given
    what the reference's tokenizer gives (BertTokenizerFast's zero types)."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    tt = torch.zeros_like(ids)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask, token_type_ids=tt).last_hidden_state
        model = checkpoint.build_model(c)
        got = model(ids, mask, tt) if kind in XLM else model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["sq_uncased", "sq_uncased_st", "sq_uncased_port", "sq_mixed",
                                  "xlm_en", "xlm_en_st", "xlm_en_port", "xlm_sin", "xlm_causal",
                                  "xlm_xlmr"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory
    (its tokenizer's outputs all passed), pooled and normalized; chunks of
    3 put the texts in several passes, each padded to its own longest."""
    texts = _batch()
    source = kind.removesuffix("_st").removesuffix("_port")
    jax_enc = FlaxTextEncoder(ckpt[source], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("kind", ["sq_uncased_port", "xlm_en_port"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == ("SqueezeBertModel" if kind.startswith("sq") else "XLMModel")
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias"}
    assert not info["unexpected_keys"]


def test_chunk_texts_counts_the_squeezebert_copies(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk fits a quarter of the free memory
    with SqueezeBERT's channel-last copies and the grouped products'
    copies counted (the arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["sq_uncased"], "useModel", device=None)
    enc._load()
    L, heads = enc.max_len, 4
    per_text = 4 * (3 * heads * L * L + L * (6 * 32 + 2 * 64)) + 4 * L * (2 * 32 + 64)
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(59)
    return [{"id": i, "title": " ".join(rng.choice(WORDS[:10], size=int(rng.integers(2, 20)))),
             "points": int(rng.integers(0, 2000))} for i in range(50)]


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


@pytest.mark.parametrize("kind", ["sq_mixed", "xlm_en"])
def test_http_hybrid_matches_jax(ckpt, kind):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt[kind]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings("sx", settings)["status"] == "succeeded"
            assert c.add_documents("sx", _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index("sx"), apps[0].scheduler.index("sx")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("hello world search", "rust python"):
            for ratio in (1.0, 0.5):
                body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "showRankingScore": True, "limit": 20}
                want, got = (c.post("/indexes/sx/search", body=dict(body)) for c in clients)
                assert want.status == got.status == 200, (want.json, got.json)
                _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
