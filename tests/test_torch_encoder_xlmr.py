"""The XLM-RoBERTa family in the text encoder (K8): the port's model, weight
routes and Unigram tokenizer against the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. A tiny XLM-R (2 layers, width 32, 4 heads, pad id
1, `layer_norm_eps` 1e-5, one token type) is built from an
`XLMRobertaConfig`, its weights drawn with numpy from a seed, and saved
as `pytorch_model.bin` (and `model.safetensors` in a second directory)
beside a seeded Unigram `tokenizer.json` written as transformers' XLM-R
converter writes it. With `pytorch_model.bin` alone the JAX package's
encoder cannot load Flax weights and runs transformers' torch
`XLMRobertaModel` (its `AutoModel` branch), which computes the model as
defined; the port is held against that branch within 1e-5.

Fault 3.9 is pinned here: where Flax can load the weights (a
`flax_model.msgpack`, or a `model.safetensors` that transformers converts
from PyTorch on load) the JAX package takes its Flax branch, whose
`module.apply` gives RoBERTa positions 0..L-1 instead of counting from
the padding id, and its embeddings differ from the torch branch's by more
than 1e-2; a BERT's two branches agree within 1e-5 (BERT's positions do
start at 0)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("flax")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import bert, checkpoint, hf_encoder  # noqa: E402
from meilisearch_tpu_torch.models.fixtures import (  # noqa: E402
    build_charsmap,
    xlmr_tokenizer_json,
)
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402

ATOL = 1e-5
FAULT_39_GAP = 1e-2
WORDS = [
    "hello", "world", "search", "engine", "rust", "python", "database", "cloud",
    "machine", "learning", "café", "naïve", "привет", "мир", "поиск", "中文", "検索",
    "مرحبا", "بحث", "über", "straße",
]
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-éïüßпривтмоскна中文検索مرحباب"
TEXTS = [
    "Hello, World!",
    "Café naïve — déjà vu",
    "Привет, мир! поиск",
    "中文 検索 search中文",
    "مرحبا بحث",
    "runs    of   spaces and ✈ unknown",
    "",
    "straße über alles " * 5,
]


def _pieces() -> list:
    rng = np.random.default_rng(3)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:]]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


SPEC = xlmr_tokenizer_json(_pieces(), build_charsmap({"é": "é", "Ａ": "A", "​": ""}))
VOCAB_SIZE = len(SPEC["model"]["vocab"])


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1,
    everything else normal(0, 0.02)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.02, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _save_tokenizer(path):
    transformers.XLMRobertaTokenizerFast(
        tokenizer_object=tokenizers.Tokenizer.from_str(json.dumps(SPEC)),
        bos_token="<s>", eos_token="</s>", unk_token="<unk>", pad_token="<pad>",
        cls_token="<s>", sep_token="</s>", mask_token="<mask>",
    ).save_pretrained(path)


def _save(model, path, flax_cls=None, safe=False):
    """`model` saved to `path` with the Unigram tokenizer; with Flax
    weights too when `flax_cls` is given. Returns the Flax params."""
    model.save_pretrained(path, safe_serialization=safe)
    _save_tokenizer(path)
    if flax_cls is None:
        return None
    flax_model = flax_cls.from_pretrained(path, from_pt=True)
    flax_model.save_pretrained(path)
    return flax_model.params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`xlmr`: pytorch_model.bin only; `st`: model.safetensors only;
    `xlmr_flax`: pytorch_model.bin and flax_model.msgpack; `bert` and
    `bert_flax`: a tiny BERT over the same Unigram vocabulary, the same
    two ways."""
    root = tmp_path_factory.mktemp("xlmr")
    config = transformers.XLMRobertaConfig(
        vocab_size=VOCAB_SIZE, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=514, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2,
    )
    model = transformers.XLMRobertaModel(config)
    _draw_weights(model, seed=13)
    out = {k: str(root / k) for k in ("xlmr", "st", "xlmr_flax", "bert", "bert_flax")}
    _save(model, out["xlmr"])
    _save(model, out["st"], safe=True)
    out["flax_params"] = _save(model, out["xlmr_flax"], transformers.FlaxXLMRobertaModel)
    bconfig = transformers.BertConfig(
        vocab_size=VOCAB_SIZE, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=512, pad_token_id=1,
    )
    bmodel = transformers.BertModel(bconfig)
    _draw_weights(bmodel, seed=17)
    _save(bmodel, out["bert"])
    _save(bmodel, out["bert_flax"], transformers.FlaxBertModel)
    return out


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, 25, n)]


# -- the checkpoint ------------------------------------------------------------


def test_the_checkpoint_reads_the_unigram_tokenizer(ckpt):
    c = checkpoint.load_checkpoint(ckpt["xlmr"])
    assert c.config["model_type"] == "xlm-roberta" and c.vocab == []
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, Unigram)
    ref = transformers.AutoTokenizer.from_pretrained(ckpt["xlmr"])
    want = ref(TEXTS, padding=True, truncation=True, max_length=512)
    ids, mask = tok(TEXTS, 512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]
    # a BERT with XLM-R's vocabulary gets the Unigram tokenizer too
    assert isinstance(checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt["bert"])), Unigram)


def test_three_weight_routes_give_identical_tensors(ckpt):
    st = checkpoint.read_weights(ckpt["st"])
    pt = checkpoint.read_weights(ckpt["xlmr"])

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    fx = checkpoint.flax_to_state_dict(to_numpy(ckpt["flax_params"]))
    names = set(bert.BertModel(checkpoint.load_checkpoint(ckpt["xlmr"]).config).state_dict())
    assert set(st) == set(pt) == set(fx) == names
    for name in names:
        assert torch.equal(st[name], pt[name]), name
        assert torch.equal(st[name], fx[name]), name


def test_prefixed_names_load(ckpt):
    """A masked-LM checkpoint's `roberta.` prefix is dropped and its
    `lm_head.` left out."""
    named = {f"roberta.{k}": v for k, v in checkpoint.read_weights(ckpt["xlmr"]).items()}
    named["lm_head.dense.weight"] = torch.zeros(3, 3)
    assert set(checkpoint.hf_to_state_dict(named)) == set(checkpoint.read_weights(ckpt["xlmr"]))


def test_a_bpe_tokenizer_is_refused(ckpt, tmp_path):
    path = str(tmp_path / "bpe")
    shutil.copytree(ckpt["xlmr"], path)
    spec = dict(SPEC, model={"type": "BPE", "vocab": {"a": 0}, "merges": []})
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with pytest.raises(ValueError, match="BPE"):
        checkpoint.load_checkpoint(path)


def test_a_roberta_config_needs_its_pad_id(ckpt):
    config = dict(checkpoint.load_checkpoint(ckpt["xlmr"]).config)
    del config["pad_token_id"]
    with pytest.raises(ValueError, match="pad_token_id"):
        bert.BertModel(config)


def test_xlmr_forward_matches_transformers_torch(ckpt):
    """The module alone against transformers' torch XLMRobertaModel on the
    same weights, padded batch included (the padded positions too), and
    a literal pad id inside a text."""
    ref = transformers.XLMRobertaModel.from_pretrained(ckpt["xlmr"]).eval()
    c = checkpoint.load_checkpoint(ckpt["xlmr"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(5, seed=9) + ["hello <pad> world"], 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


# -- the encoder ----------------------------------------------------------------


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("chunk", [3, 256])
def test_encoder_matches_jax_torch_branch(ckpt, pooling, chunk, monkeypatch):
    texts = _texts(7, seed=chunk) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt["xlmr"], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None  # the AutoModel branch: pytorch_model.bin only
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    enc = hf_encoder.TextEncoder(ckpt["xlmr"], pooling, device=None)
    before = hf_encoder.FORWARDS.value
    got = enc.encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_bert_with_a_unigram_tokenizer_matches_jax(ckpt):
    """A BERT over XLM-R's kind of vocabulary (the multilingual MiniLM
    layout); the JAX package takes its Flax branch, right for BERT."""
    texts = _texts(6, seed=4) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt["bert_flax"], "useModel")
    want = jax_enc.encode(texts)
    assert jax_enc._flax is not None
    got = hf_encoder.TextEncoder(ckpt["bert_flax"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


def test_fault_39_the_jax_flax_branch_misplaces_xlmr_positions(ckpt):
    """The JAX package gives two answers for one XLM-R model: its Flax
    branch (Flax weights present, or PyTorch safetensors it converts)
    against its torch branch (pytorch_model.bin only) differ by more than
    1e-2; the port equals the torch branch from every directory. A BERT's
    two branches agree."""
    texts = _texts(6, seed=8) + TEXTS[:5]
    torch_branch = FlaxTextEncoder(ckpt["xlmr"], "useModel").encode(texts)
    for key in ("xlmr_flax", "st"):
        flax_enc = FlaxTextEncoder(ckpt[key], "useModel")
        flax = flax_enc.encode(texts)
        assert flax_enc._flax is not None
        assert float(np.abs(flax - torch_branch).max()) > FAULT_39_GAP
        port = hf_encoder.TextEncoder(ckpt[key], "useModel", device=None).encode(texts)
        assert float(np.abs(port - torch_branch).max()) <= ATOL
    bert_flax = FlaxTextEncoder(ckpt["bert_flax"], "useModel").encode(texts)
    bert_torch_enc = FlaxTextEncoder(ckpt["bert"], "useModel")
    bert_torch = bert_torch_enc.encode(texts)
    assert bert_torch_enc._torch is not None
    assert float(np.abs(bert_flax - bert_torch).max()) <= ATOL


# -- the query vectors' cache --------------------------------------------------


def test_query_vectors_are_cached_per_model(ckpt):
    """Two embedders of one name on two checkpoints (two indexes, or one
    index before and after a settings change) each embed the query with
    their own model (fault 3.10: the JAX package keys its query cache by
    the embedder's name and the text alone, and answers the second with
    the first model's vector)."""
    from meilisearch_tpu.vector.embedders import Embedder as JaxEmbedder
    from meilisearch_tpu_torch.vector.embedders import Embedder

    q = "search engine 中文"
    confs = [{"source": "huggingFace", "model": ckpt[k]} for k in ("xlmr", "bert")]
    got = [Embedder("default", c).embed_search(q) for c in confs]
    for conf, vec in zip(confs, got):
        want = hf_encoder.TextEncoder(conf["model"], "useModel").encode([q])[0]
        np.testing.assert_array_equal(vec, want)
    assert float(np.abs(got[0] - got[1]).max()) > FAULT_39_GAP
    jax_got = [JaxEmbedder("default", c).embed_search(q) for c in confs]
    np.testing.assert_array_equal(jax_got[0], jax_got[1])


# -- through HTTP ----------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(41)
    return [
        {"id": i, "title": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8)))),
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


def test_http_hybrid_with_an_xlmr_embedder_matches_jax(ckpt):
    settings = {
        "filterableAttributes": ["points"],
        "embedders": {"default": {"source": "huggingFace", "model": ckpt["xlmr"]}},
    }
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings("ml", settings)["status"] == "succeeded"
            assert c.add_documents("ml", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("ml"), apps[0].scheduler.index("ml")
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("поиск мир", "café search", "中文 検索"):
            for ratio in (1.0, 0.5):
                for filt in (None, "points > 1000"):
                    body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                            "showRankingScore": True, "limit": 20}
                    if filt:
                        body["filter"] = filt
                    want, got = (c.post("/indexes/ml/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
