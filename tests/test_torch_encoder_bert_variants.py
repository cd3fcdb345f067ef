"""The BERT-shaped families models/bert.py runs beside BERT: ERNIE (`ernie`,
its task-type embedding), BertGeneration (`bert-generation`, no token
types), RemBERT (`rembert`, narrow embeddings projected by
`encoder.embedding_hidden_mapping_in`), Megatron-BERT (`megatron-bert`,
pre-LayerNorm layers and a final `encoder.ln`), BERT's `relative_key` and
`relative_key_query` positions on every family that reads them, and the
encoders' activations; their weight names, and the encoder against
transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny models (2 layers, hidden 32, 4 heads,
intermediate 64) are built from each family's transformers config with
weights drawn with numpy from a seed (LayerNorm scales and every bias off
their defaults, Q and K with a standard deviation of 0.15, so a dropped
norm, a dropped task row or a misplaced scale moves the output far beyond
the tolerance), beside a WordPiece vocab.txt (ERNIE's with CJK
characters, `models/fixtures.py::ernie_vocab`). transformers has no Flax
model of ERNIE, BertGeneration, RemBERT or Megatron-BERT, so the JAX
package's encoder runs the torch model; BERT with relative keys is saved
as pytorch_model.bin only, for with Flax weights the JAX package runs
absolute positions instead (fault 3.22, pinned here). Each family is
held, on pytorch_model.bin, model.safetensors and the port's own
`write_checkpoint`, against the torch branch within 1e-5, for each
pooling and at chunks of 3 and 256 texts, and against `AutoModel`'s last
hidden state on every row of a padded batch."""

import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    activations,
    bert,
    checkpoint,
    fixtures,
    hf_encoder,
)

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "un", "##able", "##s", "##ing", "the", "a", "of", "gpu"]
TEXTS = ["Hello, World!", "unable searching [MASK] engine", "gpu [SEP] rust", "",
         "Café naïve RÉSUMÉ", "the cloud of machine learning " * 4, "机器学习的搜索引擎",
         "一二三 四五 search 六"]
VOCAB = fixtures.ernie_vocab(WORDS, size=480, n_cjk=200)
WIDTHS = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64, max_position_embeddings=128,
              layer_norm_eps=1e-12, pad_token_id=0)
# kind -> (transformers config class, its arguments, do_lower_case)
KINDS = {
    "ernie": ("ErnieConfig", dict(type_vocab_size=4, use_task_id=True, task_type_vocab_size=3,
                                  layer_norm_eps=1e-5), True),
    "bertgen": ("BertGenerationConfig", dict(), True),
    "rembert": ("RemBertConfig", dict(type_vocab_size=2, input_embedding_size=16,
                                      output_embedding_size=24), True),
    "megatron": ("MegatronBertConfig", dict(type_vocab_size=2), False),
    "bert_rk": ("BertConfig", dict(type_vocab_size=2, position_embedding_type="relative_key",
                                   hidden_act="gelu_new"), True),
    "bert_rkq": ("BertConfig", dict(type_vocab_size=2,
                                    position_embedding_type="relative_key_query"), True),
}
MODEL_CLASSES = {"ernie": "ErnieModel", "bertgen": "BertGenerationEncoder",
                 "rembert": "RemBertModel", "megatron": "MegatronBertModel",
                 "bert_rk": "BertModel", "bert_rkq": "BertModel"}


def _config(kind, **change):
    cls, args, _lower = KINDS[kind]
    return getattr(transformers, cls)(**{**WIDTHS, **args, **change})


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else (biases too) normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if name.endswith(("LayerNorm.weight", "ln.weight")):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, lower):
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in VOCAB))
    transformers.BertTokenizerFast(os.path.join(path, "vocab.txt"),
                                   do_lower_case=lower).save_pretrained(path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """For each kind: `{kind}` pytorch_model.bin, `{kind}_st`
    model.safetensors, `{kind}_port` the port's write_checkpoint; `flax`:
    `bert_rk` with transformers' flax_model.msgpack beside its
    pytorch_model.bin."""
    root = tmp_path_factory.mktemp("variants")
    out = {}
    for i, (kind, (_cls, _args, lower)) in enumerate(KINDS.items()):
        model = transformers.AutoModel.from_config(_config(kind))
        _draw_weights(model, seed=51 + i)
        for name, safe in ((kind, False), (f"{kind}_st", True)):
            out[name] = str(root / name)
            model.save_pretrained(out[name], safe_serialization=safe)
            _write_tokenizer(out[name], lower)
        c = checkpoint.load_checkpoint(out[kind])
        out[f"{kind}_port"] = str(root / f"{kind}_port")
        checkpoint.write_checkpoint(out[f"{kind}_port"], c.config, c.state_dict, VOCAB,
                                    do_lower_case=lower)
    out["flax"] = str(root / "flax")
    transformers.BertModel.from_pretrained(out["bert_rk"]).save_pretrained(
        out["flax"], safe_serialization=False)
    transformers.FlaxBertModel.from_pretrained(out["bert_rk"], from_pt=True).save_pretrained(
        out["flax"])
    _write_tokenizer(out["flax"], True)
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops on one thread: seconds, not minutes, beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed, hi=25):
    rng = np.random.default_rng(seed)
    words = WORDS + ["机器", "学习", "搜索"]
    return [" ".join(rng.choice(words, size=int(k))) for k in rng.integers(0, hi, n)]


def _batch():
    """Padded texts: the specials, CJK characters, and a row over 64 tokens."""
    return _texts(5, seed=9) + TEXTS + [" ".join(WORDS * 4)]


# -- configs, modules and weight names ----------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_the_module_names_are_transformers(ckpt, kind):
    """The port's state_dict has transformers' names (RemBERT's projection
    under `embeddings_project`) and shapes, nothing more or less."""
    model = checkpoint.build_model(checkpoint.load_checkpoint(ckpt[kind]))
    ref = transformers.AutoModel.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == MODEL_CLASSES[kind]
    theirs = {k.replace("encoder.embedding_hidden_mapping_in.", "embeddings_project."): v
              for k, v in ref.state_dict().items()
              if not k.startswith("pooler.") and not k.endswith(("position_ids",
                                                                 "token_type_ids"))}
    ours = model.state_dict()
    assert set(ours) == set(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)


@pytest.mark.parametrize("kind, names", [
    ("ernie", ["embeddings.task_type_embeddings.weight"]),
    ("rembert", ["embeddings_project.weight"]),
    ("megatron", ["encoder.ln.weight", "encoder.layer.1.ln.weight",
                  "encoder.layer.1.attention.ln.weight"]),
    ("bert_rkq", ["encoder.layer.0.attention.self.distance_embedding.weight"]),
])
def test_each_family_reads_its_own_tensors(ckpt, kind, names):
    """The mechanisms each family adds load from its file (Megatron-BERT's
    `attention.ln.` and `ln.` survive the MPNet rename), and BERT's
    post-norms are absent where Megatron-BERT has none."""
    state = checkpoint.load_checkpoint(ckpt[kind]).state_dict
    assert all(n in state for n in names)
    if kind == "megatron":
        assert not any("LayerNorm" in n for n in state)


def test_the_published_widths():
    """ernie-3.0-base-zh, google/rembert, megatron-bert-cased-345m and
    bert_for_seq_generation_L-24_bbc_encoder at their config.json widths
    (2 layers) build with transformers' names and shapes."""
    published = {
        "ErnieConfig": dict(vocab_size=40_000, hidden_size=768, num_attention_heads=12,
                            intermediate_size=3072, max_position_embeddings=2048,
                            type_vocab_size=4, task_type_vocab_size=3, use_task_id=True,
                            layer_norm_eps=1e-5),
        "RemBertConfig": dict(vocab_size=250_300, hidden_size=1152, num_attention_heads=18,
                              intermediate_size=4608, input_embedding_size=256,
                              output_embedding_size=1664, max_position_embeddings=512,
                              type_vocab_size=2, layer_norm_eps=1e-12),
        "MegatronBertConfig": dict(vocab_size=29_056, hidden_size=1024, num_attention_heads=16,
                                   intermediate_size=4096),
        "BertGenerationConfig": dict(vocab_size=50_358, hidden_size=1024,
                                     num_attention_heads=16, intermediate_size=4096),
    }
    for cls, widths in published.items():
        config = getattr(transformers, cls)(num_hidden_layers=2, **widths)
        with torch.device("meta"):
            ours = checkpoint.new_model(config.to_dict()).state_dict()
            ref = transformers.AutoModel.from_config(config)
        theirs = {k.replace("encoder.embedding_hidden_mapping_in.", "embeddings_project."): v
                  for k, v in ref.state_dict().items()
                  if not k.startswith("pooler.") and not k.endswith(("position_ids",
                                                                     "token_type_ids"))}
        assert set(ours) == set(theirs), cls
        assert all(ours[k].shape == theirs[k].shape for k in ours), cls


@pytest.mark.parametrize("model_type, positions", [
    ("rembert", "relative_key"), ("rembert", "relative_key_query"),
    ("bert", "rotary"), ("ernie", "relative_value"), ("camembert", "rotary"),
])
def test_positions_a_family_does_not_read_are_refused(model_type, positions):
    """RemBERT's attention reads no relative keys (nor do MPNet's and
    DistilBERT's), and no family knows another position type."""
    config = {**WIDTHS, "model_type": model_type, "type_vocab_size": 2,
              "position_embedding_type": positions, "input_embedding_size": 16}
    with pytest.raises(ValueError, match="position_embedding_type"):
        bert.BertModel(config)


@pytest.mark.parametrize("cls, prefix, head", [
    ("ErnieForMaskedLM", "ernie.", "cls."), ("RemBertForMaskedLM", "rembert.", "cls."),
    ("MegatronBertForPreTraining", "bert.", "cls."),
    ("BertGenerationDecoder", "bert.", "lm_head."),
])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls, prefix, head):
    kind = {"Ernie": "ernie", "RemBe": "rembert", "Megat": "megatron",
            "BertG": "bertgen"}[cls[:5]]
    state = checkpoint.read_weights(ckpt[kind])
    named = getattr(transformers, cls).from_pretrained(ckpt[kind]).state_dict()
    assert any(k.startswith(prefix) for k in named) and any(k.startswith(head) for k in named)
    got = checkpoint.hf_to_state_dict(named)
    assert set(got) == set(state)
    for name in state:
        assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_automodel(ckpt, kind):
    """AutoModel's last hidden state on every row of a padded batch."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


RELATIVE_FAMILIES = {
    "bert": ("BertConfig", {}), "roberta": ("RobertaConfig", {"pad_token_id": 1}),
    "xlm-roberta": ("XLMRobertaConfig", {"pad_token_id": 1}),
    "camembert": ("CamembertConfig", {"pad_token_id": 1}),
    "electra": ("ElectraConfig", {"embedding_size": 16}),
    "ernie": ("ErnieConfig", {"use_task_id": True}), "megatron-bert": ("MegatronBertConfig", {}),
    "bert-generation": ("BertGenerationConfig", {}),
}


@pytest.mark.parametrize("positions", ["relative_key", "relative_key_query"])
@pytest.mark.parametrize("family", list(RELATIVE_FAMILIES))
def test_relative_keys_on_every_family_that_reads_them(tmp_path, family, positions):
    """Each family whose transformers module reads the relative keys, with
    them, against AutoModel on a padded batch of seeded ids (the RoBERTa
    family's absolute positions dropped, BertGeneration's kept)."""
    cls, extra = RELATIVE_FAMILIES[family]
    config = getattr(transformers, cls)(**{**WIDTHS, "type_vocab_size": 2, **extra,
                                           "position_embedding_type": positions})
    model = transformers.AutoModel.from_config(config).eval()
    _draw_weights(model, seed=61)
    model.save_pretrained(str(tmp_path), safe_serialization=False)
    c = checkpoint.Checkpoint(config.to_dict(), checkpoint.read_weights(str(tmp_path)), [])
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(5, len(VOCAB), (4, 40)))
    mask = torch.ones_like(ids)
    mask[1, 23:], mask[2, 6:] = 0, 0
    ids[mask == 0] = config.pad_token_id
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("act", sorted(activations.ACTIVATIONS))
@pytest.mark.parametrize("cls", ["BertConfig", "ErnieConfig", "RemBertConfig",
                                 "MegatronBertConfig", "RoFormerConfig", "AlbertConfig"])
def test_the_encoders_run_every_listed_activation(tmp_path, cls, act):
    """`hidden_act` goes through models/activations.py in every encoder
    family, against AutoModel (transformers' ACT2FN)."""
    extra = {"RemBertConfig": {"input_embedding_size": 16},
             "AlbertConfig": {"embedding_size": 16}}.get(cls, {})
    config = getattr(transformers, cls)(**{**WIDTHS, "type_vocab_size": 2, **extra,
                                           "hidden_act": act})
    model = transformers.AutoModel.from_config(config).eval()
    _draw_weights(model, seed=62)
    model.save_pretrained(str(tmp_path), safe_serialization=False)
    config = config.to_dict()
    c = checkpoint.Checkpoint(config, checkpoint.read_weights(str(tmp_path)), [])
    if config["model_type"] == "roformer":
        c.state_dict = checkpoint.roformer.with_positions(config, c.state_dict)
    ids = torch.from_numpy(np.random.default_rng(8).integers(5, len(VOCAB), (3, 30)))
    mask = torch.ones_like(ids)
    mask[2, 11:] = 0
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("kind", [f"{k}_port" for k in KINDS])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == MODEL_CLASSES[kind[:-5]]
    assert all(k.startswith("pooler.") for k in info["missing_keys"])
    assert not info["unexpected_keys"]
    assert "pytorch_model.bin" in os.listdir(ckpt[kind])


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("route", ["", "_st", "_port"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_encoder_matches_jax(ckpt, kind, route, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory,
    pooled and normalized, against each weight route; chunks of 3 put the
    texts in several passes, each padded to its own longest."""
    texts = _batch()
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and jax_enc._torch is not None
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[kind + route], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_fault_322_flax_bert_ignores_relative_keys(ckpt):
    """With flax_model.msgpack the JAX package runs FlaxBertModel, which
    has no distance_embedding and adds absolute positions: its two
    branches differ on the same weights. The port equals the torch
    branch."""
    texts = _batch()
    flax_enc = FlaxTextEncoder(ckpt["flax"], "useModel")
    flax = flax_enc.encode(texts)
    assert flax_enc._flax is not None
    torch_branch = FlaxTextEncoder(ckpt["bert_rk"], "useModel").encode(texts)
    assert float(np.abs(flax - torch_branch).max()) > 1e-2
    got = hf_encoder.TextEncoder(ckpt["flax"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - torch_branch).max()) <= ATOL


def test_chunk_texts_counts_the_relative_terms(ckpt, monkeypatch):
    """On a CUDA device the chunk shrinks with the (B, heads, L, L) terms of
    the relative keys: one more for relative_key, two for
    relative_key_query."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1 << 33, 1 << 34))
    chunks = {}
    for kind in ("ernie", "bert_rk", "bert_rkq"):
        enc = hf_encoder.TextEncoder(ckpt[kind], "useModel", device=None)
        enc._load()
        enc.device = torch.device("cuda")
        chunks[kind] = enc.chunk_texts()
    L, heads = 512, 4
    base = 4 * (3 * heads * L * L + L * (6 * 32 + 2 * 64))
    assert chunks["ernie"] == min(hf_encoder.CHUNK_TEXTS, (1 << 33) // 4 // base)
    assert chunks["bert_rk"] == (1 << 33) // 4 // (base + 4 * heads * L * L)
    assert chunks["bert_rkq"] == (1 << 33) // 4 // (base + 8 * heads * L * L)


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(46)
    words = WORDS[:10] + ["机器", "学习", "搜索"]
    return [{"id": i, "title": " ".join(rng.choice(words, size=int(rng.integers(2, 20)))),
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


@pytest.mark.parametrize("kind", ["ernie", "megatron"])
def test_http_hybrid_matches_jax(ckpt, kind):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt[kind]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings(kind, settings)["status"] == "succeeded"
            assert c.add_documents(kind, _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index(kind), apps[0].scheduler.index(kind)
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("hello world search", "机器 学习"):
            for ratio in (1.0, 0.5):
                for filt in (None, "points > 1000"):
                    body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                            "showRankingScore": True, "limit": 20}
                    if filt:
                        body["filter"] = filt
                    want, got = (c.post(f"/indexes/{kind}/search", body=dict(body))
                                 for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
