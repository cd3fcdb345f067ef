"""MobileBERT in the text encoder (K8): the port's `mobilebert` model type
(models/mobilebert.py: the trigram embedding, `NoNorm`, the bottlenecks and
the stacked FFNs), its weight names, and the encoder against transformers
and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny MobileBERTs (2 layers, hidden 64, 4 heads,
intermediate 48, 16-wide embeddings, a 32-wide bottleneck) are built from
a `MobileBertConfig`, their weights drawn with numpy from a seed (norm
scales near 1 and every bias off its default, Q and K with a standard
deviation of 0.15), beside a WordPiece vocab.txt and
`MobileBertTokenizerFast`'s tokenizer_config.json:
- `published`: google/mobilebert-uncased's flags (`no_norm`, `relu`,
  `trigram_input`, `key_query_shared_bottleneck`, 4 FFNs);
- `ln`: `layer_norm` (whose embeddings and `output.LayerNorm` take torch's
  default eps), `use_bottleneck_attention`, 2 FFNs, `gelu`;
- `plain`: no bottleneck and no trigram, 32-wide embeddings equal to the
  hidden width (no `embedding_transformation` on the path), 1 FFN;
- `split`: the bottleneck without the shared one (Q, K and V from the
  hidden state, as wide as the bottleneck: transformers raises otherwise).
Each is saved as pytorch_model.bin (the JAX package's torch branch:
transformers has no Flax MobileBERT); `published` also as
model.safetensors and as the port's `write_checkpoint` writes it. The port
is held against AutoModel on every row of a padded batch, and against the
JAX package within 1e-5 under both poolings, at chunks of 3 and 256, and
through HTTP. Real MobileBERT checkpoints are known for activations in
the thousands, which seeded weights do not reach."""

import json
import os
import string

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, hf_encoder, mobilebert  # noqa: E402
from meilisearch_tpu_torch.models.wordpiece import WordPiece  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "run", "##ning", "##s", "the", "a", "of", "cafe", "gpu"]
VOCAB = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    + list(string.ascii_lowercase + string.digits + string.punctuation + "中文éü")
    + ["##" + c for c in string.ascii_lowercase + string.digits]
))
TEXTS = ["Hello, World!", "Café naïve — RÉSUMÉ", "中文 search中文", "running [MASK] engines",
         "", "gpu " * 40]
WIDTHS = dict(vocab_size=len(VOCAB), hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=48, embedding_size=16,
              intra_bottleneck_size=32, max_position_embeddings=128)
CONFIGS = {
    "published": dict(),
    "ln": dict(normalization_type="layer_norm", use_bottleneck_attention=True,
               num_feedforward_networks=2, hidden_act="gelu"),
    "plain": dict(hidden_size=32, embedding_size=32, use_bottleneck=False,
                  trigram_input=False, num_feedforward_networks=1),
    "split": dict(hidden_size=32, key_query_shared_bottleneck=False,
                  num_feedforward_networks=3),
}
PUBLISHED = {  # google/mobilebert-uncased's config.json
    "model_type": "mobilebert", "vocab_size": 30522, "hidden_size": 512,
    "num_hidden_layers": 24, "num_attention_heads": 4, "intermediate_size": 512,
    "hidden_act": "relu", "max_position_embeddings": 512, "type_vocab_size": 2,
    "embedding_size": 128, "true_hidden_size": 128, "intra_bottleneck_size": 128,
    "num_feedforward_networks": 4, "normalization_type": "no_norm", "trigram_input": True,
    "key_query_shared_bottleneck": True, "use_bottleneck": True,
    "use_bottleneck_attention": False, "layer_norm_eps": 1e-12, "pad_token_id": 0,
}


def _config(kind):
    return transformers.MobileBertConfig(**{**WIDTHS, **CONFIGS[kind]})


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: norm scales near 1, Q and K
    normal(0, 0.15), everything else (biases too) normal(0, 0.05); but the
    pad's word row, zero as `nn.Embedding(padding_idx=0)` makes it and
    training keeps it (the trigram reads it beside a text's last token, so
    a row drawn nonzero makes a vector depend on how far its batch pads,
    in transformers as in the port)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if name.endswith("LayerNorm.weight"):
                draw += 1.0
            if name == "embeddings.word_embeddings.weight":
                draw[0] = 0.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path):
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in VOCAB))
    transformers.MobileBertTokenizerFast(os.path.join(path, "vocab.txt"),
                                         do_lower_case=True).save_pretrained(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """For each of CONFIGS a pytorch_model.bin directory; `published_st`
    as model.safetensors; `published_port` the port's write_checkpoint."""
    root = tmp_path_factory.mktemp("mobilebert")
    out = {}
    for seed, kind in enumerate(CONFIGS, start=41):
        model = transformers.MobileBertModel(_config(kind))
        _draw_weights(model, seed)
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=False)
        _write_tokenizer(out[kind])
        if kind == "published":
            out["published_st"] = str(root / "published_st")
            model.save_pretrained(out["published_st"], safe_serialization=True)
            _write_tokenizer(out["published_st"])
    c = checkpoint.load_checkpoint(out["published"])
    out["published_port"] = str(root / "published_port")
    checkpoint.write_checkpoint(out["published_port"], c.config, c.state_dict, vocab=VOCAB)
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


# -- configs, modules and weight names ----------------------------------------------


def test_the_published_widths_give_mobilebert_uncased():
    """google/mobilebert-uncased's config.json: the module's parameters
    are MobileBertModel's by name and shape (built on the meta device),
    true_hidden_size the bottleneck's 128, NoNorm everywhere."""
    config = mobilebert.check_config(PUBLISHED)
    assert config["true_hidden_size"] == 128
    with torch.device("meta"):
        ours = mobilebert.MobileBertModel(PUBLISHED)
        theirs = transformers.MobileBertModel(transformers.MobileBertConfig(**PUBLISHED),
                                              add_pooling_layer=False)
    assert isinstance(ours.embeddings.LayerNorm, mobilebert.NoNorm)
    ours, theirs = ours.state_dict(), theirs.state_dict()
    assert set(ours) == set(theirs) - {"embeddings.position_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["embeddings.embedding_transformation.weight"].shape == (512, 384)
    assert len([k for k in ours if k.startswith("encoder.layer.0.ffn.")]) == 3 * 6


def test_the_layer_norm_eps_is_transformers_per_norm():
    """With `layer_norm`, the embeddings' norm and each layer's
    `output.LayerNorm` take torch's default 1e-5 (transformers passes no
    eps there); the others `layer_norm_eps`."""
    config = {**PUBLISHED, "normalization_type": "layer_norm", "num_hidden_layers": 1}
    ours = mobilebert.MobileBertModel(config)
    theirs = transformers.MobileBertModel(transformers.MobileBertConfig(**config))
    mine = {n: m.eps for n, m in ours.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    want = {n: m.eps for n, m in theirs.named_modules() if isinstance(m, torch.nn.LayerNorm)}
    assert mine == {n: e for n, e in want.items() if not n.startswith("pooler")}
    assert mine["embeddings.LayerNorm"] == 1e-5 and mine["encoder.layer.0.output.LayerNorm"] == 1e-5


@pytest.mark.parametrize("change, match", [
    ({"normalization_type": "batch_norm"}, "normalization_type"),
    ({"num_feedforward_networks": 0}, "num_feedforward_networks"),
    ({"hidden_act": "gelu_10"}, "hidden_act"),
    ({"intra_bottleneck_size": 30}, "true_hidden_size"),
    ({"key_query_shared_bottleneck": False}, "key_query_shared_bottleneck"),
])
def test_unread_mobilebert_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["published"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)
    with pytest.raises(ValueError, match=match):
        mobilebert.MobileBertModel(config)


@pytest.mark.parametrize("cls", ["MobileBertForMaskedLM", "MobileBertForPreTraining"])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls):
    """The `mobilebert.` prefix, the `cls.` heads and the pooler are
    dropped, from torch tensors and numpy arrays."""
    state = checkpoint.read_weights(ckpt["published"])
    named = getattr(transformers, cls).from_pretrained(ckpt["published"]).state_dict()
    assert any(k.startswith("cls.") for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


def test_the_trigram_reads_next_then_previous(ckpt):
    """Token t's embedding is [x[t + 1], x[t], x[t - 1]], zeros past the
    ends, before `embedding_transformation`."""
    model = checkpoint.build_model(checkpoint.load_checkpoint(ckpt["published"]))
    emb = model.embeddings
    ids = torch.tensor([[7, 8, 9]])
    x = emb.word_embeddings(ids)[0]
    zero = torch.zeros_like(x[0])
    want = torch.stack([torch.cat([x[1], x[0], zero]), torch.cat([x[2], x[1], x[0]]),
                        torch.cat([zero, x[2], x[1]])])
    captured = {}

    def capture(_module, args, _out):
        captured["x"] = args[0]

    handle = emb.embedding_transformation.register_forward_hook(capture)
    try:
        with torch.no_grad():
            emb(ids)
    finally:
        handle.remove()
    assert torch.equal(captured["x"][0], want)


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_forward_matches_automodel(ckpt, kind):
    """AutoModel's last hidden state on every row of a padded batch."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    assert type(ref).__name__ == "MobileBertModel"
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL
    assert float(want.abs().max()) > 0.1


def test_the_port_writes_checkpoints_transformers_reads(ckpt):
    ref, info = transformers.AutoModel.from_pretrained(ckpt["published_port"],
                                                       output_loading_info=True)
    assert type(ref).__name__ == "MobileBertModel"
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias"}
    assert not info["unexpected_keys"]
    c = checkpoint.load_checkpoint(ckpt["published_port"])
    assert isinstance(checkpoint.build_tokenizer(c), WordPiece)
    with open(os.path.join(ckpt["published_port"], "config.json")) as f:
        assert json.load(f)["hidden_act"] == "relu"


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["published", "published_st", "published_port", "ln", "plain",
                                  "split"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory,
    pooled and normalized; chunks of 3 put the texts in several passes,
    each padded to its own longest."""
    texts = _batch()
    jax_enc = FlaxTextEncoder(ckpt[kind.split("_")[0]], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


def test_chunk_texts_counts_the_widest_activations(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk fits a quarter of the free memory
    counting the 64-wide hidden state and the 48-wide intermediate, each of
    the stacked FFNs run after the other (the arithmetic, with the device's
    free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["published"], "useModel", device=None)
    enc._load()
    L, heads = enc.max_len, 4
    per_text = 4 * (3 * heads * L * L + L * (6 * 64 + 2 * 48))
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(47)
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


def test_http_hybrid_with_a_mobilebert_embedder_matches_jax(ckpt):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt["published"]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings("mb", settings)["status"] == "succeeded"
            assert c.add_documents("mb", _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index("mb"), apps[0].scheduler.index("mb")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("hello world search", "rust python"):
            for ratio in (1.0, 0.5):
                body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "showRankingScore": True, "limit": 20}
                want, got = (c.post("/indexes/mb/search", body=dict(body)) for c in clients)
                assert want.status == got.status == 200, (want.json, got.json)
                _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
