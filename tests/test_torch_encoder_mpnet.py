"""MPNet in the text encoder (K8): the port's `mpnet` model type (relative
position bias, positions from the padding id), weight names, WordPiece
tokenizer with MPNet's special tokens, and encoder against transformers
and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. A tiny MPNet (2 layers, hidden 32, 4 heads,
intermediate 64, 514 positions, 32 relative buckets) is built from an
`MPNetConfig`, its weights drawn with numpy from a seed (the relative
attention bias with a standard deviation of 1, so one bucket off moves
the output far beyond the tolerance), and saved as `pytorch_model.bin`
and as `model.safetensors`, beside a vocabulary laid out as
all-mpnet-base-v2's (`models/fixtures.py::mpnet_vocab`) and the files of
`MPNetTokenizerFast.save_pretrained`. transformers has no Flax MPNet, so
the JAX package's encoder runs transformers' torch `MPNetModel` (its
AutoModel branch) for both. The port is held against it within 1e-5, for
every pooling, and through HTTP; the tokenizer against `AutoTokenizer`
on four directory layouts; BERT's and DistilBERT's tokenization against
theirs on the same texts."""

import json
import os
import shutil
import string

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from transformers.models.mpnet.modeling_mpnet import MPNetEncoder  # noqa: E402

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import bert, checkpoint, fixtures, hf_encoder  # noqa: E402
from meilisearch_tpu_torch.models.wordpiece import WordPiece  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "run", "##ning", "##s", "the", "a", "of", "cafe", "gpu", "x",
         "y", "b"]
WORDPIECE = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    + list(string.ascii_lowercase + string.digits + string.punctuation + "中文éü")
    + ["##" + c for c in string.ascii_lowercase + string.digits]
))
VOCAB = fixtures.mpnet_vocab(WORDPIECE)
# special tokens in every case and spacing, MPNet's and BERT's, and the
# characters of the other encoder checks
TEXTS = [
    "HELLO <MASK>world", "a<s>b", "x </S> y", "hello[UNK]world", "hello [MASK] a",
    "hello <mask> a", "a   <mask>  b", "<pad>x </s><s>", "[CLS] run [SEP] [PAD] [unk] [Mask]",
    "<mask>", "Hello, World!", "Café naïve — RÉSUMÉ", "中文 search中文", "running engines",
    "", "   ", "a⹃b x\u0000y", "tab\there\nnew\rline", "don't stop-me now (ok) <tag> a_b ~x",
    "İstanbul ΣΑΣ ǅ ß", "gpu " * 40,
]


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.02, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            if "relative_attention_bias" in name:
                draw = rng.normal(0.0, 1.0, tuple(p.shape))
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_vocab(path, vocab):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in vocab))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`bin`: pytorch_model.bin; `st`: model.safetensors; both with
    tokenizer.json and tokenizer_config.json. Tokenizer layouts beside
    `bin`'s config.json and weights: `vocab` (vocab.txt and the saved
    tokenizer_config.json), `plain` (vocab.txt alone) and `port`
    (write_checkpoint's: vocab.txt and fixtures.mpnet_tokenizer_config)."""
    root = tmp_path_factory.mktemp("mpnet")
    config = transformers.MPNetConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=514, layer_norm_eps=1e-5)
    model = transformers.MPNetModel(config)
    _draw_weights(model, seed=23)
    out = {k: str(root / k) for k in ("bin", "st", "vocab", "plain", "port")}
    model.save_pretrained(out["bin"], safe_serialization=False)
    model.save_pretrained(out["st"])
    for kind in ("bin", "st"):
        _write_vocab(out[kind], VOCAB)
        transformers.MPNetTokenizerFast(
            os.path.join(out[kind], "vocab.txt")).save_pretrained(out[kind])
    for kind in ("vocab", "plain"):
        _write_vocab(out[kind], VOCAB)
        for name in ("config.json", "pytorch_model.bin"):
            shutil.copy(os.path.join(out["bin"], name), out[kind])
    shutil.copy(os.path.join(out["bin"], "tokenizer_config.json"), out["vocab"])
    state = checkpoint.read_weights(out["bin"])
    checkpoint.write_checkpoint(out["port"], checkpoint.load_checkpoint(out["bin"]).config,
                                state, VOCAB)
    return out


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS[:10], size=int(k))) for k in rng.integers(0, 30, n)]


# -- the relative position bias -------------------------------------------------


def test_bucket_table_matches_transformers_at_every_length():
    """Every L in 1..514, element for element, against transformers'
    bucketing of compute_position_bias's raw-index distances (on one
    intra-op thread, the port's cached tables built afresh: under the test
    run's worker processes each small op's thread pool otherwise waits on
    the others')."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bert.relative_position_buckets.cache_clear()
    try:
        _bucket_tables_match()
    finally:
        torch.set_num_threads(threads)
        bert.relative_position_buckets.cache_clear()


def _bucket_tables_match():
    for n in range(1, 515):
        pos = torch.arange(n, dtype=torch.long)
        want = MPNetEncoder.relative_position_bucket(pos[None, :] - pos[:, None],
                                                     num_buckets=32)
        got = bert.relative_position_buckets(n)
        assert got.shape == (n, n)
        assert torch.equal(got.long(), want), n


# -- config and weights ---------------------------------------------------------


def test_the_config_reads_as_mpnet(ckpt):
    c = checkpoint.load_checkpoint(ckpt["bin"])
    assert c.config["model_type"] == "mpnet"
    model = checkpoint.build_model(c)
    assert model.embeddings.token_type_embeddings is None
    assert model.embeddings.padding_idx == 1
    assert tuple(model.encoder.relative_attention_bias.weight.shape) == (32, 4)
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, WordPiece)
    assert (tok.before, tok.after, tok.pad) == ([0], [2], 1)


def test_weight_routes_give_identical_tensors(ckpt):
    st = checkpoint.read_weights(ckpt["st"])
    pt = checkpoint.read_weights(ckpt["bin"])
    names = set(bert.BertModel(checkpoint.load_checkpoint(ckpt["bin"]).config).state_dict())
    assert "encoder.relative_attention_bias.weight" in names
    assert set(st) == set(pt) == names
    for name in names:
        assert torch.equal(st[name], pt[name]), name


def test_weight_names_with_and_without_the_mpnet_prefix(ckpt):
    """MPNetModel's names and MPNetForMaskedLM's (`mpnet.` prefix, an
    `lm_head.`) map onto the same BertModel names and tensors; the port
    writes MPNet's names back."""
    state = checkpoint.read_weights(ckpt["bin"])
    base = transformers.MPNetModel.from_pretrained(ckpt["bin"]).state_dict()
    mlm = transformers.MPNetForMaskedLM.from_pretrained(ckpt["bin"]).state_dict()
    assert any(k.startswith("mpnet.") for k in mlm) and any(k.startswith("lm_head.") for k in mlm)
    for named in (base, mlm):
        got = checkpoint.hf_to_state_dict(named)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name
    raw = torch.load(os.path.join(ckpt["bin"], "pytorch_model.bin"), weights_only=True)
    assert {checkpoint._to_mpnet(k) for k in state} == {
        k for k in raw if not k.startswith("pooler.") and not k.endswith("position_ids")}


@pytest.mark.parametrize("change, match", [
    ({"pad_token_id": 0}, "pad_token_id"),
    ({"relative_attention_num_buckets": 16}, "relative_attention_num_buckets"),
    ({"hidden_act": "gelu_10"}, "hidden_act"),
    ({"position_embedding_type": "relative_key"}, "position_embedding_type"),
])
def test_unread_mpnet_configs_are_refused(ckpt, change, match):
    """MPNet's attention reads no relative keys; its activation goes through
    models/activations.py's list, which lacks `gelu_10`."""
    config = {**checkpoint.load_checkpoint(ckpt["bin"]).config, **change}
    with pytest.raises(ValueError, match=match):
        bert.BertModel(config)


# -- the forward and the encoder --------------------------------------------------


def test_mpnet_forward_matches_transformers_torch(ckpt):
    """Padded rows of 2 to over 300 tokens: the exact buckets (distance
    under 8) and the logarithmic ones (up to and past 128)."""
    ref = transformers.MPNetModel.from_pretrained(ckpt["bin"]).eval()
    c = checkpoint.load_checkpoint(ckpt["bin"])
    model = checkpoint.build_model(c)
    rng = np.random.default_rng(4)
    long_texts = [" ".join(rng.choice(WORDS[:10], size=n)) for n in (6, 60, 140, 300)]
    ids, mask = checkpoint.build_tokenizer(c)(_texts(4, seed=9) + long_texts + TEXTS, 512)
    assert ids.shape[1] > 300 and int((mask == 0).sum()) > 0
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
@pytest.mark.parametrize("kind", ["bin", "st"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch (no Flax MPNet exists) on both
    weight files."""
    rng = np.random.default_rng(8)
    texts = _texts(8, seed=3) + TEXTS + [" ".join(rng.choice(WORDS[:10], size=200))]
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "MPNetModel"
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


# -- the tokenizer ------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["bin", "vocab", "plain", "port"])
def test_tokenizer_matches_autotokenizer(ckpt, layout):
    """tokenizer.json (`bin`), vocab.txt with the saved tokenizer_config.json
    (its flags: every special matched on the normalized text), vocab.txt
    alone (transformers' defaults: matched on the raw text) and the port's
    own writing: ids and masks, text by text and as padded batches cut at
    512 and at 8 tokens."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[layout])
    assert type(ref).__name__ == "MPNetTokenizerFast"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[layout]))
    for text in TEXTS:
        want = ref([text], truncation=True, max_length=512)
        assert tok([text], 512)[0].tolist() == want["input_ids"], text
    texts = TEXTS + _texts(6, seed=5) + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def test_the_normalized_specials_differ_from_the_raw_ones(ckpt):
    """The layouts disagree where transformers does: `<MASK>` is `<mask>`
    only when the specials are matched on the normalized text."""
    ids = {layout: checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[layout]))(
        ["HELLO <MASK>world"], 512)[0].tolist()[0] for layout in ("bin", "plain")}
    mask_id = VOCAB.index("<mask>")
    assert mask_id in ids["bin"] and mask_id not in ids["plain"]


@pytest.mark.parametrize("layout", ["json", "vocab"])
@pytest.mark.parametrize("family", ["bert", "distilbert"])
def test_bert_and_distilbert_tokenization_is_unchanged(tmp_path, family, layout):
    """BERT's and DistilBERT's WordPiece on the same texts, with and without
    their tokenizer.json, still equal AutoTokenizer's: their specials stay
    matched on the raw text, `[CLS] $A [SEP]`."""
    path = str(tmp_path / family)
    _write_vocab(path, WORDPIECE)
    fast = (transformers.BertTokenizerFast if family == "bert"
            else transformers.DistilBertTokenizerFast)
    fast(os.path.join(path, "vocab.txt"), do_lower_case=True).save_pretrained(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": family}, f)
    if layout == "vocab":
        os.remove(os.path.join(path, "tokenizer.json"))
    ref = transformers.AutoTokenizer.from_pretrained(path)
    vocab = WORDPIECE
    config = json.load(open(os.path.join(path, "tokenizer_config.json")))
    spec = None
    if layout == "json":
        spec = json.load(open(os.path.join(path, "tokenizer.json")))
    tok = WordPiece.from_config(vocab, config, spec, family)
    for text in TEXTS:
        want = ref([text], truncation=True, max_length=512)["input_ids"]
        assert tok([text], 512)[0].tolist() == want, text
        assert WordPiece(vocab)([text], 512)[0].tolist() == want, text


def test_a_bert_processing_template_is_read(tmp_path):
    """Older BERT tokenizer.json files give their template as
    BertProcessing; it reads as the TemplateProcessing it stands for."""
    path = str(tmp_path)
    _write_vocab(path, WORDPIECE)
    transformers.BertTokenizerFast(os.path.join(path, "vocab.txt")).save_pretrained(path)
    spec = json.load(open(os.path.join(path, "tokenizer.json")))
    config = json.load(open(os.path.join(path, "tokenizer_config.json")))
    want = WordPiece.from_config(WORDPIECE, config, spec, "bert")(TEXTS, 512)[0].tolist()
    spec["post_processor"] = {"type": "BertProcessing", "sep": ["[SEP]", WORDPIECE.index("[SEP]")],
                              "cls": ["[CLS]", WORDPIECE.index("[CLS]")]}
    assert WordPiece.from_config(WORDPIECE, config, spec, "bert")(TEXTS, 512)[0].tolist() == want


def test_the_fixture_vocabulary_and_config(ckpt):
    """all-mpnet-base-v2's id layout, and a tokenizer_config.json that
    MPNetTokenizerFast reads with the flags it writes."""
    assert VOCAB[:4] == ["<s>", "<pad>", "</s>", "<unk>"] and VOCAB[-1] == "<mask>"
    assert len(VOCAB) == len(WORDPIECE) + 5
    written = json.load(open(os.path.join(ckpt["port"], "tokenizer_config.json")))
    saved = json.load(open(os.path.join(ckpt["bin"], "tokenizer_config.json")))
    assert written["added_tokens_decoder"] == saved["added_tokens_decoder"]
    for key in ("bos_token", "eos_token", "sep_token", "cls_token", "unk_token", "pad_token",
                "mask_token", "do_lower_case", "tokenizer_class"):
        assert written[key] == saved[key], key


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt):
    """write_checkpoint's MPNet names load into transformers' MPNetModel
    with nothing missing, and it computes the port's forward."""
    ref, info = transformers.MPNetModel.from_pretrained(
        ckpt["port"], add_pooling_layer=False, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    c = checkpoint.load_checkpoint(ckpt["port"])
    ids, mask = checkpoint.build_tokenizer(c)(TEXTS, 512)
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(41)
    return [
        {"id": i, "title": " ".join(rng.choice(WORDS[:10], size=int(rng.integers(2, 9)))),
         "points": int(rng.integers(0, 2000))}
        for i in range(60)
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


def test_http_hybrid_with_an_mpnet_embedder_matches_jax(ckpt):
    # fault 3.10: the JAX package caches query vectors by embedder name and
    # text across models, so another test's model would answer these queries
    jax_embedders._search_cache.clear()
    settings = {
        "filterableAttributes": ["points"],
        "embedders": {"default": {"source": "huggingFace", "model": ckpt["st"]}},
    }
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings("mp", settings)["status"] == "succeeded"
            assert c.add_documents("mp", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("mp"), apps[0].scheduler.index("mp")
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
                    want, got = (c.post("/indexes/mp/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
