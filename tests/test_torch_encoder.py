"""The text encoder (K8): the port's BERT, checkpoint reader and WordPiece
tokenizer against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. A tiny BERT (2 layers, width 32, 4 heads) is built
from a `BertConfig`, its weights drawn with numpy from a seed, and saved
the three ways a checkpoint can hold them: `model.safetensors`,
`pytorch_model.bin` and, converted by transformers, `flax_model.msgpack`,
beside a written `vocab.txt` and the tokenizer files of
`BertTokenizerFast.save_pretrained`. With Flax weights present the JAX
package's encoder takes its Flax branch (a jitted forward on its CPU
backend); the port's `TextEncoder` runs on the CPU (`device=None`).

- tokenizer: input ids and attention masks equal `AutoTokenizer`'s;
- weights: the three routes give identical tensors;
- embeddings: within 1e-5 max abs of the JAX package's (the two sum in
  other orders);
- over HTTP: a JAX App and a port App with the same `huggingFace`
  embedder serve the same hybrid pages, scores within 1e-5.

The encoder on the card is held against this CPU pass in
tests/test_torch_cuda.py (marked `cuda`)."""

import json
import os
import shutil
import string

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("flax")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import bert, checkpoint, hf_encoder  # noqa: E402
from meilisearch_tpu_torch.models.wordpiece import WordPiece  # noqa: E402
from meilisearch_tpu_torch.search.device_batch import serving_stats  # noqa: E402
from meilisearch_tpu_torch.types.errors import EngineError, ErrorCode  # noqa: E402
from meilisearch_tpu_torch.vector.embedders import Embedder, get_embedder  # noqa: E402

ATOL = 1e-5
WORDS = [
    "hello", "world", "search", "engine", "rust", "python", "database", "cloud",
    "machine", "learning", "un", "##able", "##aff", "##s", "##ing", "##ed", "run",
    "the", "a", "of", "cafe", "naive", "resume", "gpu", "vector", "title", "url",
]
CHARS = list(string.ascii_lowercase + string.digits + string.punctuation) + list(
    "中文字日本éüñ€—…«»¿"
)
VOCAB = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + CHARS
    + ["##" + c for c in string.ascii_lowercase + string.digits]
))
TEXTS = [
    "Hello, World!",
    "Café naïve RÉSUMÉ — déjà vu",
    "中文字 search中文 日本",
    "x\u0000y\u0007z� w​q­r",
    "emoji 😀 here 👍🏽",
    "a" * 101 + " b " + "c" * 100,
    "[MASK] hello[SEP]world [mask] [CLS]",
    "unaffable running",
    "tab\there\nnew\rline\x0bvt\x0cff\x85nel ls nb　ideo",
    "x\U0002B81Fy x\U0002B820y x\U0002B920y x͸y xy",
    "İstanbul ΣΑΣ ǅ ß Å",
    "",
    "   ",
    "don't stop-me now (ok) $5 <tag> a_b ~x ¿qué? «guillemets» …",
    "½ ² ﬁ Ⅻ ①",
]


def _draw_weights(model, seed):
    """Every parameter of a transformers torch model drawn with numpy:
    LayerNorm scales near 1, everything else normal(0, 0.02) plus a
    seeded offset (so a bias or a scale loaded in the wrong place shows)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.02, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Directories of one tiny BERT: `dir` holds model.safetensors,
    flax_model.msgpack and the tokenizer; `bin` pytorch_model.bin."""
    root = tmp_path_factory.mktemp("bert")
    d, d_bin = str(root / "st"), str(root / "bin")
    config = transformers.BertConfig(
        vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=512,
    )
    model = transformers.BertModel(config)
    _draw_weights(model, seed=11)
    model.save_pretrained(d)
    model.save_pretrained(d_bin, safe_serialization=False)
    flax_model = transformers.FlaxBertModel.from_pretrained(d, from_pt=True)
    flax_model.save_pretrained(d)
    for path in (d, d_bin):
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in VOCAB))
        transformers.BertTokenizerFast(
            os.path.join(path, "vocab.txt"), do_lower_case=True
        ).save_pretrained(path)
    return {"dir": d, "bin": d_bin, "flax_params": flax_model.params}


def _wordpiece(path):
    c = checkpoint.load_checkpoint(path)
    return WordPiece.from_config(c.vocab, c.tokenizer)


# -- tokenizer -------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(TEXTS)))
def test_tokenizer_matches_autotokenizer(ckpt, case):
    ref_tok = transformers.AutoTokenizer.from_pretrained(ckpt["dir"])
    text = TEXTS[case]
    ref = ref_tok([text], padding=True, truncation=True, max_length=512)
    ids, mask = _wordpiece(ckpt["dir"])([text], 512)
    assert ids.dtype == mask.dtype == torch.int64
    assert ids.tolist() == ref["input_ids"]
    assert mask.tolist() == ref["attention_mask"]


@pytest.mark.parametrize("max_len", [512, 8, 3])
def test_tokenizer_pads_and_truncates_as_autotokenizer(ckpt, max_len):
    """A batch of mixed lengths padded to its longest; texts longer than
    max_len (one of over 600 tokens) cut with [CLS] and [SEP] kept."""
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice(WORDS[:10], size=n)) for n in (0, 3, 40, 700)]
    texts += TEXTS[:4]
    ref = transformers.AutoTokenizer.from_pretrained(ckpt["dir"])(
        texts, padding=True, truncation=True, max_length=max_len
    )
    ids, mask = _wordpiece(ckpt["dir"])(texts, max_len)
    assert ids.tolist() == ref["input_ids"]
    assert mask.tolist() == ref["attention_mask"]


def test_tokenizer_without_lower_case(ckpt):
    ref = transformers.BertTokenizerFast(
        os.path.join(ckpt["dir"], "vocab.txt"), do_lower_case=False
    )
    wp = WordPiece(VOCAB, do_lower_case=False)
    for text in TEXTS:
        want = ref([text], truncation=True, max_length=512)
        assert wp([text])[0].tolist() == want["input_ids"], text


# -- weights ----------------------------------------------------------------


def test_three_weight_routes_give_identical_tensors(ckpt):
    st = checkpoint.read_weights(ckpt["dir"])
    pt = checkpoint.read_weights(ckpt["bin"])

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    params = to_numpy(ckpt["flax_params"])
    fx = checkpoint.flax_to_state_dict(params)
    names = set(bert.BertModel(checkpoint.load_checkpoint(ckpt["dir"]).config).state_dict())
    assert set(st) == set(pt) == set(fx) == names
    for name in names:
        assert torch.equal(st[name], pt[name]), name
        assert torch.equal(st[name], fx[name]), name


def test_safetensors_reader_dtypes(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(3)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 4, generator=g).bfloat16(),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = checkpoint.read_safetensors(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert got[name].shape == want.shape
        assert np.array_equal(got[name].astype(want.dtype), want), name


@pytest.mark.parametrize(
    "change, match",
    [({"model_type": "funnel"}, "model_type"), ({"hidden_act": "gelu_10"}, "hidden_act")]
    + [({"model_type": kind}, "model_type") for kind in ("nystromformer", "bart", "t5")]
    + [({"model_type": "mobilebert", "normalization_type": "batch_norm"}, "normalization_type"),
       ({"model_type": "xlm", "tokenizer_class": "XLMTokenizer"}, "XLMTokenizer.*Moses"),
       ({"model_type": "xlm", "tokenizer_class": None}, "XLMTokenizer.*Moses")],
)
def test_other_model_families_are_refused(ckpt, change, match, tmp_path):
    """Whole directories: the families the reference cannot run either
    (`funnel`: AutoModel raises on a config.json without `architectures`;
    `nystromformer`: a shape error unless the batch is
    `segment_means_seq_len` long; `bart`: `BartModel` is passed
    `token_type_ids`; `t5`: the JAX package raises), an activation outside
    models/activations.py's list (transformers runs `gelu_10`), a
    MobileBERT norm transformers does not know, and a directory whose
    tokenizer is XLM's Moses BPE, named in tokenizer_config.json
    (`tokenizer_class`) or, where that names none, AutoTokenizer's class for
    an `xlm` directory, but which holds no vocab.json and merges.txt (a
    vocab.txt beside them is never read for it)."""
    path = str(tmp_path / "changed")
    shutil.copytree(ckpt["dir"], path)
    change = dict(change)
    tok_class = change.pop("tokenizer_class", False)
    config = {**checkpoint.load_checkpoint(ckpt["dir"]).config, **change}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    if tok_class is not False:
        with open(os.path.join(path, "tokenizer_config.json")) as f:
            tok = json.load(f)
        tok.pop("tokenizer_class", None)
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({**tok, **({"tokenizer_class": tok_class} if tok_class else {})}, f)
    else:
        with pytest.raises(ValueError, match=match):
            checkpoint.check_config(config)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_checkpoint(path)


# -- the encoder ------------------------------------------------------------


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS[:12], size=int(k))) for k in rng.integers(0, 30, n)]


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("chunk", [3, 256])
def test_encoder_matches_jax(ckpt, pooling, chunk, monkeypatch):
    """Mixed lengths (0 to 30 words, the accented and CJK texts); chunks of
    3 put the texts in three passes, each padded to its own longest."""
    texts = _texts(7, seed=chunk) + TEXTS[1:3]
    jax_enc = FlaxTextEncoder(ckpt["dir"], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is not None  # the Flax branch, not its torch fallback
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    enc = hf_encoder.TextEncoder(ckpt["dir"], pooling, device=None)
    before = hf_encoder.FORWARDS.value
    got = enc.encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_encode_text_matches_jax(ckpt):
    from meilisearch_tpu.models.hf_encoder import encode_text as jax_encode_text

    for text in ("rust search engine", TEXTS[4]):
        got = hf_encoder.encode_text(ckpt["dir"], text, "useModel")
        want = jax_encode_text(ckpt["dir"], text, "useModel")
        assert float(np.abs(got - want).max()) <= ATOL


def test_bert_forward_matches_transformers_torch(ckpt):
    """The module alone against transformers' torch BertModel on the same
    weights, padded batch included (the masked positions' states too)."""
    ref = transformers.BertModel.from_pretrained(ckpt["dir"]).eval()
    model = checkpoint.build_model(checkpoint.load_checkpoint(ckpt["dir"]))
    ids, mask = _wordpiece(ckpt["dir"])(_texts(5, seed=9), 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


def test_a_missing_checkpoint_is_an_embedding_error_counted_on_a_device(tmp_path):
    conf = {"source": "huggingFace", "model": str(tmp_path / "absent")}
    before = serving_stats()["device_errors"]
    with pytest.raises(EngineError) as err:
        Embedder("e", conf, torch.device("cpu")).embed_documents(["a text"])
    assert err.value.code == ErrorCode.VECTOR_EMBEDDING_ERROR
    assert "not a local checkpoint directory" in str(err.value)
    assert serving_stats()["device_errors"] == before + 1
    with pytest.raises(EngineError):
        Embedder("e", conf).embed_documents(["a text"])  # no device: not counted
    assert serving_stats()["device_errors"] == before + 1


# -- through HTTP ------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(31)
    return [
        {"id": i, "title": " ".join(rng.choice(WORDS[:10], size=int(rng.integers(2, 9)))),
         "points": int(rng.integers(0, 2000))}
        for i in range(60)
    ]


def _same_within_ties(got, want):
    """Ids equal in order except inside a run of hits whose JAX scores lie
    within ATOL of each other (compared as a set); scores within ATOL."""
    ids_g, sc_g = [h["id"] for h in got], [h["_rankingScore"] for h in got]
    ids_w, sc_w = [h["id"] for h in want], [h["_rankingScore"] for h in want]
    assert len(ids_g) == len(ids_w)
    np.testing.assert_allclose(sc_g, sc_w, atol=ATOL)
    start = 0
    for i in range(1, len(ids_w) + 1):
        if i == len(ids_w) or abs(sc_w[i] - sc_w[i - 1]) > ATOL:
            assert set(ids_g[start:i]) == set(ids_w[start:i])
            start = i


def test_http_hybrid_with_a_huggingface_embedder_matches_jax(ckpt):
    """Documents embedded at ingest by each package's encoder (the port's
    on the store's device, the CPU here), then hybrid searches with a
    text q at semanticRatio 1.0 and 0.5, with and without a filter."""
    # fault 3.10: the JAX package caches query vectors by embedder name and
    # text across models, so another test's model would answer these queries
    jax_embedders._search_cache.clear()
    settings = {
        "filterableAttributes": ["points"],
        "embedders": {"default": {"source": "huggingFace", "model": ckpt["dir"]}},
    }
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings("hf", settings)["status"] == "succeeded"
            assert c.add_documents("hf", _docs())["status"] == "succeeded"
        store = apps[1].scheduler.index("hf")
        assert store.device == torch.device("cpu")
        assert get_embedder(store, "default").device == store.device
        assert hf_encoder.FORWARDS.value > before  # embedded by the port's encoder
        jstore = apps[0].scheduler.index("hf")
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("rust search engine", "cloud database"):
            for ratio in (1.0, 0.5):
                for filt in (None, "points > 1000"):
                    body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                            "showRankingScore": True, "limit": 20}
                    if filt:
                        body["filter"] = filt
                    want, got = (c.post("/indexes/hf/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
