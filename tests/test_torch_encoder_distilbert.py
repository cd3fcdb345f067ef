"""DistilBERT in the text encoder (K8): the port's `distilbert` model type,
weight names and encoder against transformers and the JAX package's
`FlaxTextEncoder`.

Nothing is downloaded. A tiny DistilBERT (2 layers, dim 32, 4 heads,
hidden_dim 64) is built from a `DistilBertConfig`, its weights drawn
with numpy from a seed, and saved beside a WordPiece vocab.txt two ways:
`pytorch_model.bin` alone (the JAX package's encoder cannot load Flax
weights and runs transformers' torch `DistilBertModel`, its AutoModel
branch) and `model.safetensors` alone (transformers converts it for
`FlaxDistilBertModel`: the Flax branch). DistilBERT's positions start at
0, so both branches are right; the port is held against each within
1e-5, both poolings, and through HTTP. `sinusoidal_pos_embds` and the
activations of models/activations.py are held against the JAX package on
checkpoints of their own (fault 3.24: its Flax branch ignores a sinusoidal
file's table)."""

import os
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

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "run", "##ning", "##s", "the", "a", "of", "cafe", "gpu"]
VOCAB = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    + list(string.ascii_lowercase + string.digits + string.punctuation + "中文éü")
    + ["##" + c for c in string.ascii_lowercase + string.digits]
))
TEXTS = ["Hello, World!", "Café naïve — RÉSUMÉ", "中文 search中文", "running [MASK] engines",
         "", "a⹃b x\u0000y", "gpu " * 40]


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.02, tuple(p.shape))
            if "layer_norm.weight" in name.lower():
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`bin`: pytorch_model.bin only; `st`: model.safetensors only; the
    Flax params transformers converts from it."""
    root = tmp_path_factory.mktemp("distilbert")
    config = transformers.DistilBertConfig(
        vocab_size=len(VOCAB), dim=32, n_layers=2, n_heads=4, hidden_dim=64,
        max_position_embeddings=512)
    model = transformers.DistilBertModel(config)
    _draw_weights(model, seed=19)
    out = {"bin": str(root / "bin"), "st": str(root / "st")}
    model.save_pretrained(out["bin"], safe_serialization=False)
    model.save_pretrained(out["st"])
    for path in out.values():
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in VOCAB))
        transformers.DistilBertTokenizerFast(
            os.path.join(path, "vocab.txt"), do_lower_case=True).save_pretrained(path)
    out["flax_params"] = transformers.FlaxDistilBertModel.from_pretrained(
        out["st"], from_pt=True).params
    return out


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS[:10], size=int(k))) for k in rng.integers(0, 30, n)]


def test_the_config_reads_as_bert_widths(ckpt):
    c = checkpoint.load_checkpoint(ckpt["bin"])
    assert c.config["model_type"] == "distilbert"
    model = checkpoint.build_model(c)
    assert model.config["hidden_size"] == 32 and model.config["num_hidden_layers"] == 2
    assert model.config["num_attention_heads"] == 4 and model.config["intermediate_size"] == 64
    assert model.embeddings.token_type_embeddings is None
    assert model.embeddings.LayerNorm.eps == 1e-12
    assert isinstance(checkpoint.build_tokenizer(c), WordPiece)


def test_three_weight_routes_give_identical_tensors(ckpt):
    st = checkpoint.read_weights(ckpt["st"])
    pt = checkpoint.read_weights(ckpt["bin"])

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    fx = checkpoint.flax_to_state_dict(to_numpy(ckpt["flax_params"]))
    names = set(bert.BertModel(checkpoint.load_checkpoint(ckpt["bin"]).config).state_dict())
    assert set(st) == set(pt) == set(fx) == names
    for name in names:
        assert torch.equal(st[name], pt[name]), name
        assert torch.equal(st[name], fx[name]), name


def test_prefixed_names_and_heads(ckpt):
    """A masked-LM checkpoint's `distilbert.` prefix is dropped and its
    `vocab_*` head left out; write_checkpoint writes DistilBERT's names."""
    state = checkpoint.read_weights(ckpt["bin"])
    named = {f"distilbert.{k}": v for k, v in state.items()}
    named["vocab_transform.weight"] = torch.zeros(3, 3)
    named["vocab_projector.bias"] = torch.zeros(3)
    assert set(checkpoint.hf_to_state_dict(named)) == set(state)
    raw = torch.load(os.path.join(ckpt["bin"], "pytorch_model.bin"), weights_only=True)
    theirs = {checkpoint._to_distilbert(k) for k in state}
    assert theirs == {k for k in raw if not k.endswith("position_ids")}


@pytest.mark.parametrize("change, match", [
    ({"activation": "gelu_10"}, "activation"),
    ({"dim": 30}, "n_heads"),
    ({"n_heads": 5}, "n_heads"),
])
def test_unread_distilbert_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["bin"]).config, **change}
    with pytest.raises(ValueError, match=match):
        bert.BertModel(config)


def test_distilbert_forward_matches_transformers_torch(ckpt):
    ref = transformers.DistilBertModel.from_pretrained(ckpt["bin"],
                                                       attn_implementation="eager").eval()
    c = checkpoint.load_checkpoint(ckpt["bin"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(5, seed=9) + TEXTS, 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """`sin_bin` / `sin_st`: `sinusoidal_pos_embds` and `relu`, the table
    transformers fills (the sinusoid) saved as pytorch_model.bin and as
    model.safetensors; `sin_moved` (`sin_moved_st`): its table reversed
    in the file;
    `{act}`: each of ACTIVATIONS, pytorch_model.bin."""
    root = tmp_path_factory.mktemp("distilbert_variants")
    out = {}

    def save(name, model, safe):
        out[name] = str(root / name)
        model.save_pretrained(out[name], safe_serialization=safe)
        with open(os.path.join(out[name], "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in VOCAB))
        transformers.DistilBertTokenizerFast(
            os.path.join(out[name], "vocab.txt"), do_lower_case=True).save_pretrained(out[name])

    widths = dict(vocab_size=len(VOCAB), dim=32, n_layers=2, n_heads=4, hidden_dim=64,
                  max_position_embeddings=512)
    model = transformers.DistilBertModel(transformers.DistilBertConfig(
        **widths, sinusoidal_pos_embds=True, activation="relu"))
    table = model.embeddings.position_embeddings.weight.detach().clone()
    _draw_weights(model, seed=23)
    with torch.no_grad():  # the sinusoid, which transformers never trains
        model.embeddings.position_embeddings.weight.copy_(table)
    save("sin_bin", model, False)
    save("sin_st", model, True)
    with torch.no_grad():
        model.embeddings.position_embeddings.weight.copy_(table.flip(0))
    save("sin_moved", model, False)
    save("sin_moved_st", model, True)
    for i, act in enumerate(ACTIVATIONS):
        model = transformers.DistilBertModel(transformers.DistilBertConfig(**widths,
                                                                           activation=act))
        _draw_weights(model, seed=29 + i)
        save(act, model, False)
    return out


ACTIVATIONS = ("relu", "gelu_new", "silu")


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["sin_bin", "sin_st"])
def test_sinusoidal_positions_match_jax(variants, kind, pooling):
    """`sinusoidal_pos_embds`: the JAX package's torch branch
    (pytorch_model.bin) reads the file's table, its Flax branch
    (model.safetensors, converted) computes the sinusoid; the file holds
    the sinusoid transformers wrote, so both agree with the port, which
    reads the file."""
    texts = _texts(8, seed=5) + TEXTS
    jax_enc = FlaxTextEncoder(variants[kind], pooling)
    want = jax_enc.encode(texts)
    assert (jax_enc._torch if kind == "sin_bin" else jax_enc._flax) is not None
    got = hf_encoder.TextEncoder(variants[kind], pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations_match_jax(variants, act):
    """`activation` through models/activations.py, against the JAX
    package's torch branch (DistilBERT's `get_activation`)."""
    texts = _texts(8, seed=6) + TEXTS
    want = FlaxTextEncoder(variants[act], "useModel").encode(texts)
    model = checkpoint.build_model(checkpoint.load_checkpoint(variants[act]))
    assert model.config["hidden_act"] == act
    got = hf_encoder.TextEncoder(variants[act], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


def test_the_files_table_wins_as_in_the_torch_model(variants):
    """A table that is not the sinusoid: transformers' torch
    `DistilBertModel` loads the file's (4.57.6), and so does the port; the
    forward equals AutoModel's on every row."""
    ref = transformers.AutoModel.from_pretrained(variants["sin_moved"],
                                                 attn_implementation="eager").eval()
    c = checkpoint.load_checkpoint(variants["sin_moved"])
    table = c.state_dict["embeddings.position_embeddings.weight"]
    assert torch.equal(ref.embeddings.position_embeddings.weight, table)
    ids, mask = checkpoint.build_tokenizer(c)(_texts(5, seed=9) + TEXTS, 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


def test_fault_324_the_jax_flax_branch_ignores_a_moved_table(variants):
    """With `sinusoidal_pos_embds`, Flax DistilBERT has no position table:
    it computes the sinusoid, so the JAX package's Flax branch (here from
    model.safetensors) ignores the file's table, which its torch branch
    (pytorch_model.bin) reads. The port reads the file from either, as the
    torch branch does."""
    texts = _texts(8, seed=7) + TEXTS
    torch_branch = FlaxTextEncoder(variants["sin_moved"], "useModel")
    flax_branch = FlaxTextEncoder(variants["sin_moved_st"], "useModel")
    want, flax = torch_branch.encode(texts), flax_branch.encode(texts)
    assert torch_branch._torch is not None and flax_branch._flax is not None
    assert float(np.abs(flax - want).max()) > 1e-2
    for kind in ("sin_moved", "sin_moved_st"):
        got = hf_encoder.TextEncoder(variants[kind], "useModel", device=None).encode(texts)
        assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["bin", "st"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """`bin`: the JAX package's torch branch; `st`: its Flax branch."""
    texts = _texts(8, seed=3) + TEXTS
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert (jax_enc._torch if kind == "bin" else jax_enc._flax) is not None
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


# -- through HTTP ----------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(37)
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


def test_http_hybrid_with_a_distilbert_embedder_matches_jax(ckpt):
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
            assert c.update_settings("db", settings)["status"] == "succeeded"
            assert c.add_documents("db", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("db"), apps[0].scheduler.index("db")
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
