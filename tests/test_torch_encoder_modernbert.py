"""ModernBERT in the text encoder (K8): the port's `modernbert` model type
(models/modernbert.py: rotary positions, alternating sliding-window and
global attention, GeGLU, pre-norm without biases), its weight names, the
byte-level BPE tokenizer with ModernBERT's NFC normalizer, `[CLS]`/`[SEP]`
template and added tokens, and the encoder against transformers and the
JAX package's `FlaxTextEncoder`.

Nothing is downloaded. A seeded tokenizer.json in ModernBERT's layout
(`models/fixtures.py::modernbert_tokenizer_json`: GPT-NeoX's head, a
byte-level BPE trained on the tests' texts, non-special added tokens,
`[UNK] [CLS] [SEP] [PAD] [MASK]`, `[unusedN]` slots) and the
tokenizer_config.json published beside it (`PreTrainedTokenizerFast`,
`model_input_names` without token types) sit beside tiny ModernBERTs
built from a `ModernBertConfig` (hidden 64, 4 heads, intermediate 96;
5 layers with `local_attention` 16, so the window bites on short texts,
and 4 with the published 128), their weights drawn with numpy from a seed
(`Wqkv` with a standard deviation of 0.15, so attention is peaked and a
wrong window or rotary theta moves the output far beyond the tolerance).
transformers has no Flax ModernBERT, so the JAX package's encoder runs
transformers' torch `ModernBertModel` (its AutoModel branch, `sdpa`).
The port is held against it within 1e-5 for every pooling and through
HTTP; the tokenizer against `AutoTokenizer`; and fault 3.15, the JAX
package's encoder passing token types to ModernBERT, is pinned."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    bpe,
    checkpoint,
    fixtures,
    hf_encoder,
    modernbert,
)

ATOL = 1e-5
VOCAB_SIZE = 1200
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "привет", "中文", "it's", "we'll", "HELLO",
         "2024", "gpu"]
# a non-special added token that NFC decides: the text's "cafe" + U+0301
# composes to it only after the normalizer
NFC_ADDED = "caf\u00e9"
TEXTS = [
    "hello [MASK] world", "hello   [MASK]", "a[MASK]b", "[MASK]", " [MASK] x",
    "[CLS] [SEP] [PAD] [UNK] [unused3]", "<|endoftext|> <|padding|>",
    "|||IP_ADDRESS||| and |||EMAIL_ADDRESS|||x |||PHONE_NUMBER|||",
    "a  b   c    d", "x" + " " * 30 + "y", "  leading", "trailing  ", "tab\there\nnew  line",
    "cafe\u0301 and caf\u00e9, A\u030a and \u00c5, \u017f\u0323\u0307, q\u0307\u0323",
    "a⹃b ㋿ Ᲊ ꟲ \U00010781", "Hello, World! it's we'll", "",
    "中文 search中文 привет мир", "straße über " * 8,
]


def _texts(n, seed, lo=0, hi=30):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


def _spec(added_normalized=True):
    return fixtures.modernbert_tokenizer_json(
        TEXTS + _texts(200, seed=1), VOCAB_SIZE, seed=13,
        added=(*fixtures.MODERNBERT_ADDED, NFC_ADDED), added_normalized=added_normalized)


def _write_tokenizer(path, spec, config=None):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config or fixtures.modernbert_tokenizer_config(spec), f)


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.15 if "Wqkv" in name else 0.05, tuple(p.shape))
            if "norm" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _config(spec, layers, window):
    vocab = spec["model"]["vocab"]
    return transformers.ModernBertConfig(
        vocab_size=len(vocab), hidden_size=64, intermediate_size=96, num_hidden_layers=layers,
        num_attention_heads=4, local_attention=window, pad_token_id=vocab["[PAD]"],
        cls_token_id=vocab["[CLS]"], sep_token_id=vocab["[SEP]"], bos_token_id=vocab["[CLS]"],
        eos_token_id=vocab["[SEP]"])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`st`: model.safetensors, `bin`: pytorch_model.bin (5 layers, window
    16); `w128`: 4 layers, window 128; each with the tokenizer files.
    `raw`: `st`'s tokenizer with the non-special added tokens matched on
    the raw text; `nonames`: `st` with a tokenizer_config.json that lacks
    `model_input_names` (fault 3.15); `port`: `st` as the port writes it."""
    root = tmp_path_factory.mktemp("modernbert")
    spec = _spec()
    out = {k: str(root / k) for k in ("st", "bin", "w128", "raw", "nonames", "port")}
    for kind, layers, window, seed in (("st", 5, 16, 31), ("w128", 4, 128, 32)):
        model = transformers.ModernBertModel(_config(spec, layers, window))
        _draw_weights(model, seed)
        model.save_pretrained(out[kind])
        _write_tokenizer(out[kind], spec)
        if kind == "st":
            model.save_pretrained(out["bin"], safe_serialization=False)
            _write_tokenizer(out["bin"], spec)
    shutil.copytree(out["st"], out["raw"])
    _write_tokenizer(out["raw"], _spec(added_normalized=False))
    shutil.copytree(out["st"], out["nonames"])
    config = fixtures.modernbert_tokenizer_config(spec)
    del config["model_input_names"]
    _write_tokenizer(out["nonames"], spec, config)
    c = checkpoint.load_checkpoint(out["st"])
    checkpoint.write_checkpoint(out["port"], c.config, c.state_dict, tokenizer_json=spec)
    return out


def _long_texts(seed):
    """Texts of about 20 to 250 tokens, crossing the 16- and 128-token
    windows."""
    return _texts(6, seed, lo=20, hi=120)


# -- config, layers and weights --------------------------------------------------


def test_the_config_reads_as_modernbert(ckpt):
    c = checkpoint.load_checkpoint(ckpt["st"])
    assert c.config["model_type"] == "modernbert"
    model = checkpoint.build_model(c)
    assert isinstance(model, modernbert.ModernBertModel)
    assert [modernbert.is_global(model.config, i) for i in range(5)] == [
        True, False, False, True, False]
    assert isinstance(model.layers[0].attn_norm, torch.nn.Identity)
    tok = checkpoint.build_tokenizer(c)
    vocab = c.tokenizer_json["model"]["vocab"]
    assert isinstance(tok, bpe.BPE) and tok.normalize is not None
    assert (tok.before, tok.after, tok.pad) == ([vocab["[CLS]"]], [vocab["[SEP]"]],
                                                vocab["[PAD]"])


def test_the_published_widths_give_8_global_and_14_local_layers():
    """ModernBertConfig's defaults are answerdotai/ModernBERT-base's."""
    config = modernbert.check_config(json.loads(transformers.ModernBertConfig().to_json_string()))
    assert (config["vocab_size"], config["hidden_size"], config["intermediate_size"],
            config["num_hidden_layers"], config["num_attention_heads"]) == (
        50368, 768, 1152, 22, 12)
    kinds = [modernbert.is_global(config, i) for i in range(22)]
    assert (kinds.count(True), kinds.count(False)) == (8, 14)
    assert {modernbert.layer_theta(config, i) for i in range(22)} == {160000.0, 10000.0}
    assert not any((config["norm_bias"], config["attention_bias"], config["mlp_bias"]))


def test_weight_routes_give_identical_tensors(ckpt):
    st = checkpoint.read_weights(ckpt["st"])
    pt = checkpoint.read_weights(ckpt["bin"])
    names = set(modernbert.ModernBertModel(checkpoint.load_checkpoint(ckpt["st"]).config)
                .state_dict())
    assert "layers.1.attn_norm.weight" in names and "layers.0.attn_norm.weight" not in names
    assert not any(n.endswith(".bias") for n in names)  # norm_bias, attention_bias, mlp_bias
    assert set(st) == set(pt) == names
    for name in names:
        assert torch.equal(st[name], pt[name]), name


def test_weight_names_with_and_without_the_model_prefix(ckpt):
    """ModernBertModel's names and ModernBertForMaskedLM's (`model.` prefix,
    `head.` and `decoder.` tensors) map onto the same names and tensors."""
    state = checkpoint.read_weights(ckpt["st"])
    base = transformers.ModernBertModel.from_pretrained(ckpt["st"]).state_dict()
    mlm = transformers.ModernBertForMaskedLM.from_pretrained(ckpt["st"]).state_dict()
    assert any(k.startswith("model.") for k in mlm) and any(k.startswith("head.") for k in mlm)
    assert any(k.startswith("decoder.") for k in mlm)
    for named in (base, mlm):
        got = checkpoint.hf_to_state_dict(named)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


@pytest.mark.parametrize("change, match", [
    ({"hidden_activation": "silu"}, "hidden_activation"),
    ({"rope_scaling": {"rope_type": "linear", "factor": 2.0}}, "rope_scaling"),
    ({"partial_rotary_factor": 0.5}, "partial_rotary_factor"),
    ({"head_dim": 8}, "head_dim"),
    ({"num_attention_heads": 3}, "num_attention_heads"),
])
def test_unread_modernbert_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["st"]).config, **change}
    with pytest.raises(ValueError, match=match):
        modernbert.ModernBertModel(config)


def test_the_module_reads_biases_when_the_config_asks(ckpt):
    """norm_bias, attention_bias and mlp_bias add the biases transformers
    adds, under its names."""
    config = {**checkpoint.load_checkpoint(ckpt["st"]).config, "norm_bias": True,
              "attention_bias": True, "mlp_bias": True}
    ours = set(modernbert.ModernBertModel(config).state_dict())
    theirs = set(transformers.ModernBertModel(transformers.ModernBertConfig(**config))
                 .state_dict())
    assert ours == theirs and "layers.1.mlp.Wi.bias" in ours


# -- the forward and the encoder --------------------------------------------------


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "ModernBertModel"
    assert ref.config._attn_implementation in ("sdpa", "eager")
    return ref


@pytest.mark.parametrize("kind", ["st", "w128"])
def test_modernbert_forward_matches_transformers_torch(ckpt, kind):
    """Padded batches whose texts cross the window (16, or the published
    128 with texts over 65 tokens), every special and added token, on the
    real tokens."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    model = checkpoint.build_model(c)
    texts = _texts(4, seed=9) + _long_texts(seed=10) + TEXTS
    if kind == "w128":
        texts += [" ".join(WORDS * 12)]
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    half = c.config["local_attention"] // 2
    assert int(mask.sum(1).max()) > 2 * half + 1 and int((mask == 0).sum()) > 0
    with torch.no_grad():
        want = _reference(ckpt[kind])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    real = mask.bool()
    assert float((got - want)[real].abs().max()) <= ATOL


def test_a_padding_run_longer_than_half_the_window(ckpt):
    """A short text beside a long one: the short row's padded queries past
    its last token + half the window see only padding in local layers.
    Every value stays finite (the masks replace, never add: no -inf) and
    equals transformers; without the window, or with the global theta in
    local layers, the output moves far beyond the tolerance."""
    c = checkpoint.load_checkpoint(ckpt["st"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(["rust", " ".join(WORDS * 3)], 512)
    half = c.config["local_attention"] // 2
    assert ids.shape[1] - int(mask[0].sum()) > half + 1
    glob, local = model.masks(mask, torch.float32)
    assert bool(torch.isfinite(glob).all()) and bool(torch.isfinite(local).all())
    assert bool((local[0, 0, ids.shape[1] - 1] == torch.finfo(torch.float32).min).all())
    with torch.no_grad():
        want = _reference(ckpt["st"])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
        assert bool(torch.isfinite(got).all())
        real = mask.bool()
        assert float((got - want)[real].abs().max()) <= ATOL
        for change in ({"local_attention": 10 ** 6},
                       {"local_rope_theta": c.config["global_rope_theta"]}):
            other = checkpoint.new_model({**c.config, **change})
            other.load_state_dict(c.state_dict)
            assert float((other.eval()(ids, mask) - want)[real].abs().max()) > 1e-2, change


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
@pytest.mark.parametrize("kind", ["st", "bin", "w128"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch (no Flax ModernBERT exists), pooled
    and normalized, on both weight files and both windows."""
    texts = _texts(8, seed=3) + _long_texts(seed=4) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "ModernBertModel"
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_fault_315_the_jax_encoder_passes_token_types_to_modernbert(ckpt):
    """Without `model_input_names` in tokenizer_config.json the tokenizer
    returns token types and the JAX package's encoder passes them to
    `ModernBertModel.forward`, which takes none: it raises. The port never
    reads token types, and embeds the same directory as the JAX package
    embeds the one whose config names the inputs."""
    with pytest.raises(TypeError, match="token_type_ids"):
        FlaxTextEncoder(ckpt["nonames"], "useModel").encode(["hello world"])
    texts = _texts(6, seed=5)
    want = FlaxTextEncoder(ckpt["st"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt["nonames"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_geglu_width(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with ModernBERT's 2 x intermediate_size GeGLU activations
    counted (the arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["st"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 4 * c["intermediate_size"]))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- the tokenizer ------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["st", "raw", "port"])
def test_tokenizer_matches_autotokenizer(ckpt, layout):
    """The published layout (non-special added tokens matched after NFC),
    the same with them matched on the raw text, and the port's own
    writing: ids and masks, text by text and as padded batches cut at 512
    and at 8 tokens; fault 3.11's characters, `[MASK]` with lstrip, runs
    of spaces, text that NFC composes."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[layout])
    assert type(ref).__name__ == "PreTrainedTokenizerFast"
    assert ref.model_input_names == ["input_ids", "attention_mask"]
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[layout]))
    for text in TEXTS:
        want = ref([text], truncation=True, max_length=512)
        assert tok([text], 512)[0].tolist() == want["input_ids"], text
    texts = TEXTS + _texts(6, seed=6) + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def test_nfc_composes_before_the_normalized_added_tokens(ckpt):
    """"cafe" + U+0301 is the added token "caf\u00e9" only when it is matched
    after the normalizer; the composed spelling is it either way; and
    `[MASK]` takes the spaces before it."""
    specs = {layout: checkpoint.load_checkpoint(ckpt[layout]) for layout in ("st", "raw")}
    added = specs["st"].tokenizer_json["model"]["vocab"][NFC_ADDED]
    ids = {layout: checkpoint.build_tokenizer(c)(["cafe\u0301", "caf\u00e9"], 512)[0].tolist()
           for layout, c in specs.items()}
    assert added in ids["st"][0] and added not in ids["raw"][0]
    assert added in ids["st"][1] and added in ids["raw"][1]
    tok = checkpoint.build_tokenizer(specs["st"])
    vocab = specs["st"].tokenizer_json["model"]["vocab"]
    assert tok.ids("hello   [MASK]") == [*tok.ids("hello"), vocab["[MASK]"]]


def test_roberta_defaults_stay_with_roberta_classes(ckpt):
    """A PreTrainedTokenizerFast file gets no `<s>`/`<mask>` default, a
    RoBERTa class does (and ModernBERT's vocabulary lacks `<s>`), and any
    other class is refused by name."""
    c = checkpoint.load_checkpoint(ckpt["st"])
    assert bpe.BPE(c.tokenizer_json, c.tokenizer, "modernbert").pad == c.config["pad_token_id"]
    no_class = {k: v for k, v in c.tokenizer.items() if k != "tokenizer_class"}
    assert bpe.BPE(c.tokenizer_json, no_class, "modernbert").pad == c.config["pad_token_id"]
    with pytest.raises(ValueError, match="<s>"):
        bpe.BPE(c.tokenizer_json, {**c.tokenizer, "tokenizer_class": "RobertaTokenizer"})
    with pytest.raises(ValueError, match="<s>"):
        bpe.BPE(c.tokenizer_json, no_class, "roberta")
    with pytest.raises(ValueError, match="CodeGenTokenizerFast"):
        bpe.BPE(c.tokenizer_json, {**c.tokenizer, "tokenizer_class": "CodeGenTokenizerFast"})


def test_the_fixture_layout_is_modernbert_base(ckpt):
    """At 50,368 entries the fixture puts ModernBERT-base's specials at
    their ids ([CLS] 50281, [SEP] 50282, [PAD] 50283, [MASK] 50284 lstrip)
    and the first non-special added token at 50254."""
    spec = fixtures.modernbert_tokenizer_json(TEXTS, 50368, seed=2, n_trained=64)
    vocab = spec["model"]["vocab"]
    assert len(vocab) == 50368 and max(vocab.values()) == 50367
    assert [vocab[t] for t in fixtures.MODERNBERT_SPECIALS] == list(range(50280, 50285))
    assert vocab[fixtures.MODERNBERT_ADDED[0]] == 50254
    flags = {t["content"]: t for t in spec["added_tokens"]}
    assert flags["[MASK]"]["lstrip"] and not flags["|||IP_ADDRESS|||"]["special"]


def test_the_port_writes_a_checkpoint_transformers_reads(ckpt):
    """write_checkpoint's model.safetensors (ModernBertModel's names)
    loads into transformers with nothing missing and computes the port's
    forward; AutoTokenizer reads its tokenizer files as the port does."""
    ref, info = transformers.ModernBertModel.from_pretrained(ckpt["port"],
                                                             output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    from safetensors.torch import load_file

    written = load_file(os.path.join(ckpt["port"], "model.safetensors"))
    state = checkpoint.read_weights(ckpt["st"])
    assert set(written) == set(state)
    assert all(torch.equal(written[k], state[k]) for k in state)
    c = checkpoint.load_checkpoint(ckpt["port"])
    ids, mask = checkpoint.build_tokenizer(c)(TEXTS, 512)
    assert ids.tolist() == transformers.AutoTokenizer.from_pretrained(ckpt["port"])(
        TEXTS, padding=True, truncation=True, max_length=512)["input_ids"]
    with torch.no_grad():
        want = ref.eval()(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want)[mask.bool()].abs().max()) <= ATOL


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(43)
    return [
        {"id": i, "title": " ".join(rng.choice(WORDS[:10], size=int(rng.integers(2, 30)))),
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


def test_http_hybrid_with_a_modernbert_embedder_matches_jax(ckpt):
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
            assert c.update_settings("mb", settings)["status"] == "succeeded"
            assert c.add_documents("mb", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("mb"), apps[0].scheduler.index("mb")
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
                    want, got = (c.post("/indexes/mb/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
