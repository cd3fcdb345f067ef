"""ALBERT in the text encoder (K8): the port's `albert` model type
(models/albert.py: factorized embeddings, `embedding_hidden_mapping_in`,
layers shared across groups), its weight names, ALBERT's Unigram
tokenizer.json (the converter's NFKD, StripAccents and Regex Replace
normalizers; tests/test_torch_unicode_tables.py holds the first two on
every code point) and RemBERT's order of the same normalizers, and the encoder
against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny ALBERTs (hidden 32, 4 heads, intermediate 64,
`embedding_size` 16, `gelu_new` as published) are built from an
`AlbertConfig` with weights drawn with numpy from a seed (LayerNorm
scales and every bias off their defaults, Q and K with a standard
deviation of 0.15, so a dropped norm or a layer run from the wrong group
moves the output far beyond the tolerance):
- `one`: 3 layers over one group of one layer (paraphrase-albert-small-v2's
  layout, whose 6 passes share one layer's weights);
- `groups`: 4 layers over 2 groups of 2 inner layers (8 passes);
- `rkq`: 2 groups of 2 at `relative_key_query`, which ALBERT adds after the
  mask and unscaled.
Each is saved as pytorch_model.bin (the JAX package's torch branch), as
model.safetensors, and as the port's `write_checkpoint` writes it, beside
a seeded Unigram tokenizer.json in `AlbertConverter`'s layout
(`models/fixtures.py::albert_tokenizer_json`, held against the converter
on a sentencepiece `ModelProto` built with transformers' protobuf module).
`one` is also saved with transformers' own `flax_model.msgpack`, so the
JAX package takes its Flax branch, `FlaxAlbertModel`, which agrees with
the torch branch."""

import json
import os
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    albert,
    checkpoint,
    fixtures,
    hf_encoder,
)
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "cafe", "naive", "eleve", "resume", "recherche", "12,"]
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'\"-"
TEXTS = [
    "Hello, World!", "Café naïve — déjà vu, ÉLÈVE", "``quoted'' and ''again``",
    "runs    of   spaces", "[MASK] and [CLS] inside [SEP] <pad> <unk>", "hello [MASK] world",
    "x[MASK]y  [MASK]  z", "", "  leading and trailing  ", "Ａｂｃ ﬁne ½", "Ωmega ǅ ﬀ",
    "ক্ষ ड़ नि", "résumé 12, 3,4", "✈ unknown ☃",
]
LAYOUTS = {"one": (3, 1, 1, "absolute"), "groups": (4, 2, 2, "absolute"),
           "rkq": (4, 2, 2, "relative_key_query")}


def _pieces() -> list:
    rng = np.random.default_rng(8)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:]]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


CHARSMAP = fixtures.build_charsmap({"Ａ": "A", "ｂ": "b", "ｃ": "c", "ﬁ": "fi"})
SPEC = fixtures.albert_tokenizer_json(_pieces(), CHARSMAP)
VOCAB_SIZE = len(SPEC["model"]["vocab"])


def _config(kind):
    layers, groups, inner, positions = LAYOUTS[kind]
    return transformers.AlbertConfig(
        vocab_size=VOCAB_SIZE, embedding_size=16, hidden_size=32, num_hidden_layers=layers,
        num_hidden_groups=groups, inner_group_num=inner, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=128, type_vocab_size=2,
        layer_norm_eps=1e-12, hidden_act="gelu_new", position_embedding_type=positions,
        pad_token_id=0)


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else (biases too) normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if name.endswith(("LayerNorm.weight", "layer_norm.weight")):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, spec=SPEC):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.albert_tokenizer_config(spec), f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """For each layout: `{kind}` pytorch_model.bin, `{kind}_st`
    model.safetensors, `{kind}_port` the port's write_checkpoint; `flax`:
    `one` with transformers' flax_model.msgpack beside its
    pytorch_model.bin."""
    root = tmp_path_factory.mktemp("albert")
    out = {}
    for i, kind in enumerate(LAYOUTS):
        model = transformers.AlbertModel(_config(kind))
        _draw_weights(model, seed=31 + i)
        for name, safe in ((kind, False), (f"{kind}_st", True)):
            out[name] = str(root / name)
            model.save_pretrained(out[name], safe_serialization=safe)
            _write_tokenizer(out[name])
        c = checkpoint.load_checkpoint(out[kind])
        out[f"{kind}_port"] = str(root / f"{kind}_port")
        checkpoint.write_checkpoint(out[f"{kind}_port"], c.config, c.state_dict,
                                    tokenizer_json=SPEC)
    out["flax"] = str(root / "flax")
    transformers.AlbertModel.from_pretrained(out["one"]).save_pretrained(
        out["flax"], safe_serialization=False)
    transformers.FlaxAlbertModel.from_pretrained(out["one"], from_pt=True).save_pretrained(
        out["flax"])
    _write_tokenizer(out["flax"])
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
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, hi, n)]


def _batch():
    """Padded texts: the specials, accents, quotes, and a row over 64 tokens."""
    return _texts(5, seed=9) + TEXTS + [" ".join(WORDS * 4)]


# -- configs, modules and weight names ----------------------------------------------


def test_the_published_albert_small_widths():
    """paraphrase-albert-small-v2's config.json: 6 passes over one layer,
    128-wide embeddings projected to 768; the module's names are
    AlbertModel's but for the projection."""
    config = {"model_type": "albert", "vocab_size": 30_000, "embedding_size": 128,
              "hidden_size": 768, "num_hidden_layers": 6, "num_hidden_groups": 1,
              "inner_group_num": 1, "num_attention_heads": 12, "intermediate_size": 3072,
              "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
              "hidden_act": "gelu_new", "pad_token_id": 0}
    with torch.device("meta"):
        ours = albert.AlbertModel(config)
        theirs = transformers.AlbertModel(transformers.AlbertConfig(**config),
                                          add_pooling_layer=False)
    ours = ours.state_dict()
    theirs = {k.replace("encoder.embedding_hidden_mapping_in.", "embeddings_project."): v
              for k, v in theirs.state_dict().items()}
    assert set(ours) == set(theirs) - {"embeddings.position_ids", "embeddings.token_type_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["embeddings_project.weight"].shape == (768, 128)


@pytest.mark.parametrize("layers, groups, inner", [(6, 1, 1), (4, 2, 2), (12, 4, 3), (6, 3, 2),
                                                   (5, 2, 1), (7, 3, 2), (5, 3, 2)])
def test_the_pass_order_is_albert_transformers(layers, groups, inner):
    """Pass i runs group int(i / (layers / groups)), every inner layer of
    it, as AlbertTransformer does (5 layers over 3 groups of 2 is refused:
    transformers raises on it)."""
    config = {**_config("one").to_dict(), "num_hidden_layers": layers,
              "num_hidden_groups": groups, "inner_group_num": inner}
    per = int(layers / groups)
    if any(len(range(layers)[int(i / (layers / groups)) * per:][:per]) < inner
           for i in range(layers)):
        with pytest.raises(ValueError, match="inner_group_num"):
            albert.check_config(config)
        return
    model = albert.AlbertModel(config)
    groups_ = model.encoder.albert_layer_groups
    want = [groups_[int(i / (layers / groups))].albert_layers[j]
            for i in range(layers) for j in range(inner)]
    assert [id(m) for m in model.passes()] == [id(m) for m in want]


def test_shared_layers_hold_one_copy(ckpt):
    """A group's weights load once: every pass over it reads the same
    tensors, and the module holds no more parameters than the file."""
    c = checkpoint.load_checkpoint(ckpt["one"])
    model = checkpoint.build_model(c)
    passes = model.passes()
    assert len(passes) == 3 and all(p is passes[0] for p in passes)
    assert sum(p.numel() for p in model.parameters()) == sum(
        t.numel() for t in c.state_dict.values())
    assert model.encoder.albert_layer_groups[0].albert_layers[0].ffn.weight.data_ptr() == \
        c.state_dict["encoder.albert_layer_groups.0.albert_layers.0.ffn.weight"].data_ptr()


@pytest.mark.parametrize("change, match", [
    ({"hidden_act": "gelu_10"}, "hidden_act"),
    ({"position_embedding_type": "rotary"}, "position_embedding_type"),
    ({"num_hidden_groups": 5}, "num_hidden_groups"),
    ({"inner_group_num": 3}, "inner_group_num"),
])
def test_unread_albert_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["groups"]).config, **change}
    with pytest.raises(ValueError, match=match):
        albert.AlbertModel(config)


@pytest.mark.parametrize("cls", ["AlbertForMaskedLM", "AlbertForPreTraining"])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls):
    """The `albert.` prefix, the `predictions.` and `sop_classifier.` heads
    and the pooler are dropped; `encoder.embedding_hidden_mapping_in`
    becomes `embeddings_project`, from torch tensors and numpy arrays."""
    state = checkpoint.read_weights(ckpt["groups"])
    named = getattr(transformers, cls).from_pretrained(ckpt["groups"]).state_dict()
    assert any(k.startswith(("predictions.", "sop_classifier.")) for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", ["one", "groups", "rkq"])
def test_forward_matches_automodel(ckpt, kind):
    """AutoModel's last hidden state on every row of a padded batch."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    assert int((mask == 0).sum()) > 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    assert type(ref).__name__ == "AlbertModel"
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("kind", ["one_port", "groups_port", "rkq_port"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == "AlbertModel"
    assert set(info["missing_keys"]) <= {"pooler.weight", "pooler.bias"}
    assert not info["unexpected_keys"]
    assert "pytorch_model.bin" in os.listdir(ckpt[kind])


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["one", "one_st", "one_port", "groups", "groups_st",
                                  "groups_port", "rkq", "rkq_st", "rkq_port"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory,
    pooled and normalized, against each of the three weight routes; chunks
    of 3 put the texts in several passes, each padded to its own longest."""
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


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_the_jax_flax_branch_agrees(ckpt, pooling):
    """With transformers' flax_model.msgpack the JAX package runs
    FlaxAlbertModel under jax.jit; the port reads the same directory's
    pytorch_model.bin and agrees with it."""
    texts = _batch()
    jax_enc = FlaxTextEncoder(ckpt["flax"], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is not None
    got = hf_encoder.TextEncoder(ckpt["flax"], pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


# -- the tokenizers -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["one", "one_port"])
def test_tokenizer_matches_autotokenizer(ckpt, kind):
    """Ids and masks text by text and as padded batches cut at 512 and at
    8 tokens: `[MASK]` with lstrip, the quotes, accents stripped after
    NFKD, runs of spaces, the charsmap."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == "AlbertTokenizerFast"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    assert isinstance(tok, Unigram) and (tok.before, tok.after, tok.pad) == ([2], [3], 0)
    for text in TEXTS:
        assert tok([text], 512)[0].tolist() == ref([text], truncation=True,
                                                   max_length=512)["input_ids"], text
    texts = TEXTS + _batch() + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def _spm_model(path, pieces, unk_id, charsmap):
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    m.trainer_spec.model_type = 1  # Unigram
    m.trainer_spec.unk_id = unk_id
    m.normalizer_spec.precompiled_charsmap = charsmap or b""
    for piece, score, kind in pieces:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


def _float32_scores(spec):
    model = dict(spec["model"], vocab=[[p, np.float32(s)] for p, s in spec["model"]["vocab"]])
    return dict(spec, model=model)


def _converted(tmp_path, name, charsmap, **flags):
    """The tokenizer.json and tokenizer_config.json transformers' `name`
    converter and fast class write for ALBERT_HEAD then _pieces()."""
    from transformers.convert_slow_tokenizer import AlbertConverter, RemBertConverter

    vocab = _pieces()
    pieces = [(p, 0.0, 2 if p == "<unk>" else 3) for p in fixtures.ALBERT_HEAD]
    pieces += [(p, s, 1) for p, s in vocab]
    model_file = str(tmp_path / "spiece.model")
    _spm_model(model_file, pieces, 1, charsmap)
    index = {p: i for i, (p, _s, _t) in enumerate(pieces)}
    slow = types.SimpleNamespace(vocab_file=model_file, remove_space=True,
                                 convert_tokens_to_ids=index.__getitem__, **flags)
    fast = getattr(transformers, f"{name}TokenizerFast")
    out = str(tmp_path / name)
    converter = {"Albert": AlbertConverter, "RemBert": RemBertConverter}[name]
    fast(tokenizer_object=converter(slow).converted(),
         **flags).save_pretrained(out)
    with open(os.path.join(out, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        config = json.load(f)
    return spec, config, out


@pytest.mark.parametrize("lower, keep", [(True, False), (False, True)])
@pytest.mark.parametrize("charsmap", [None, CHARSMAP], ids=["plain", "charsmap"])
def test_the_albert_fixture_is_the_converters_file(tmp_path, lower, keep, charsmap):
    """`albert_tokenizer_json` equals what `AlbertConverter` and
    `AlbertTokenizerFast.save_pretrained` write (a piece ending in a digit
    and a comma scored 100 lower), and `albert_tokenizer_config` what it
    writes beside it."""
    written, config, _out = _converted(tmp_path, "Albert", charsmap, do_lower_case=lower,
                                       keep_accents=keep)
    spec = fixtures.albert_tokenizer_json(_pieces(), charsmap, lower, keep)
    assert _float32_scores(written) == _float32_scores(spec)
    assert dict(spec["model"]["vocab"])["▁12,"] < -100
    del config["model_max_length"]
    mine = fixtures.albert_tokenizer_config(spec)
    assert mine.pop("model_max_length") == 512 and config == mine


def test_rembert_normalizers_match_tokenizers(tmp_path):
    """RemBERT's converter puts the Regex Replace third, before NFKD and
    StripAccents; the port reads its tokenizer.json and gives
    RemBertTokenizerFast's ids."""
    spec, _config, out = _converted(tmp_path, "RemBert", CHARSMAP, do_lower_case=False,
                                    keep_accents=False)
    kinds = [n["type"] for n in spec["normalizer"]["normalizers"]]
    assert kinds == ["Replace", "Replace", "Replace", "NFKD", "StripAccents", "Precompiled"]
    ref = transformers.AutoTokenizer.from_pretrained(out)
    tok = Unigram(spec, _config)
    texts = TEXTS + _batch()
    want = ref(texts, padding=True, truncation=True, max_length=512)
    ids, mask = tok(texts, 512)
    assert ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]


def test_the_fixture_layout_is_albert_small():
    """At 29,995 pieces the fixture holds paraphrase-albert-small-v2's
    30,000 entries, `[MASK]` at 4."""
    spec = fixtures.albert_tokenizer_json([(f"p{i}", -1.0) for i in range(29_995)])
    assert len(spec["model"]["vocab"]) == 30_000
    assert [(t["id"], t["content"]) for t in spec["added_tokens"]] == list(
        enumerate(fixtures.ALBERT_HEAD))


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(45)
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


def test_http_hybrid_with_an_albert_embedder_matches_jax(ckpt):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt["groups"]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings("al", settings)["status"] == "succeeded"
            assert c.add_documents("al", _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index("al"), apps[0].scheduler.index("al")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("hello world search", "rust python"):
            for ratio in (1.0, 0.5):
                body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "showRankingScore": True, "limit": 20}
                want, got = (c.post("/indexes/al/search", body=dict(body)) for c in clients)
                assert want.status == got.status == 200, (want.json, got.json)
                _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
