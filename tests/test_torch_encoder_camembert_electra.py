"""CamemBERT and ELECTRA in the text encoder (K8): the port's `camembert`
(XLM-R's model under another name, positions from the padding id) and
`electra` (BERT's encoder behind an `embedding_size`-wide embedding and
its projection) model types, their weight names, CamemBERT's Unigram
tokenizer.json layout, and the encoder against transformers and the JAX
package's `FlaxTextEncoder`.

Nothing is downloaded. A tiny CamemBERT (2 layers, hidden 32, 4 heads,
pad id 1, 514 positions, one token type, eps 1e-5) sits beside a seeded
Unigram tokenizer.json in `CamembertConverter`'s layout
(`models/fixtures.py::camembert_tokenizer_json`, held here against the
converter itself on a sentencepiece `ModelProto` built with transformers'
own protobuf module); tiny ELECTRAs (2 layers, hidden 32, 4 heads,
intermediate 64, two token types, eps 1e-12; `embedding_size` 16, so
`embeddings_project` runs, and 32) beside a WordPiece vocab.txt. Weights
are drawn with numpy from a seed (Q and K with a standard deviation of
0.15, so attention is peaked). transformers has no Flax CamemBERT, so the
JAX package's encoder runs the torch `CamembertModel`; for ELECTRA its
torch branch needs a `pytorch_model.bin`-only directory: from a
`model.safetensors` it takes its Flax branch and raises (fault 3.16,
pinned here). The port is held against the torch branch within 1e-5 on
padded batches, every pooling and through HTTP; the tokenizers against
`AutoTokenizer`."""

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
    bert,
    checkpoint,
    fixtures,
    hf_encoder,
)
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402
from meilisearch_tpu_torch.models.wordpiece import WordPiece  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "élève", "français", "recherche", "moteur",
         "données", "apprentissage"]
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-éèêàçïüôœ"
TEXTS = [
    "Bonjour, le monde !", "Café naïve — déjà vu, élève", "recherche   des  données",
    "<mask> and <s> inside </s> <pad> <unk>", "hello <mask> world", "x<mask>y  <mask>  z",
    "<s>NOTUSED </s>NOTUSED <unk>NOTUSED", "runs    of   spaces and ✈ unknown", "",
    "  leading and trailing  ", "Ａｂｃ ﬁne", "straße über alles " * 5,
]
# ELECTRA's WordPiece vocabulary (uncased), bert-base-uncased's specials first
EL_WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
            "machine", "learning", "un", "##able", "##s", "##ing", "the", "a", "of", "gpu"]
EL_VOCAB = list(dict.fromkeys(
    ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + EL_WORDS + list(CHARS)
    + ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]))
EL_TEXTS = ["Hello, World!", "unable searching [MASK] engine", "gpu [SEP] rust", "",
            "Café naïve RÉSUMÉ", "the cloud of machine learning " * 4]


def _pieces() -> list:
    rng = np.random.default_rng(5)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:]]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


CHARSMAP = fixtures.build_charsmap({"é": "é", "Ａ": "A", "ｂ": "b", "ｃ": "c", "ﬁ": "fi"})
SPEC = fixtures.camembert_tokenizer_json(_pieces(), CHARSMAP)
VOCAB_SIZE = len(SPEC["model"]["vocab"])


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("query.weight", "key.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_camembert_tokenizer(path, spec=SPEC):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.camembert_tokenizer_config(spec), f)


def _write_electra_tokenizer(path):
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in EL_VOCAB))
    transformers.ElectraTokenizerFast(os.path.join(path, "vocab.txt"),
                                      do_lower_case=True).save_pretrained(path)


def _camembert_config():
    return transformers.CamembertConfig(
        vocab_size=VOCAB_SIZE, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=514, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=5, eos_token_id=6)


def _electra_config(embedding_size):
    return transformers.ElectraConfig(
        vocab_size=len(EL_VOCAB), embedding_size=embedding_size, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`cam`: pytorch_model.bin, `cam_st`: model.safetensors (the same
    CamemBERT); `el`: ELECTRA with embedding_size 16 (the projection),
    `el_same`: embedding_size 32 (none), both pytorch_model.bin only;
    `el_st`: `el` as model.safetensors; `cam_port`, `el_port`: the port's
    write_checkpoint of `cam` and `el`. Each with its tokenizer files."""
    root = tmp_path_factory.mktemp("cam_el")
    out = {k: str(root / k) for k in ("cam", "cam_st", "el", "el_same", "el_st", "cam_port",
                                      "el_port")}
    model = transformers.CamembertModel(_camembert_config())
    _draw_weights(model, seed=21)
    for kind, safe in (("cam", False), ("cam_st", True)):
        model.save_pretrained(out[kind], safe_serialization=safe)
        _write_camembert_tokenizer(out[kind])
    for kind, width, seed in (("el", 16, 22), ("el_same", 32, 23)):
        model = transformers.ElectraModel(_electra_config(width))
        _draw_weights(model, seed)
        model.save_pretrained(out[kind], safe_serialization=False)
        _write_electra_tokenizer(out[kind])
        if kind == "el":
            model.save_pretrained(out["el_st"], safe_serialization=True)
            _write_electra_tokenizer(out["el_st"])
    c = checkpoint.load_checkpoint(out["cam"])
    checkpoint.write_checkpoint(out["cam_port"], c.config, c.state_dict, tokenizer_json=SPEC)
    c = checkpoint.load_checkpoint(out["el"])
    checkpoint.write_checkpoint(out["el_port"], c.config, c.state_dict, EL_VOCAB,
                                do_lower_case=True)
    return out


def _texts(n, seed, words=WORDS, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(k))) for k in rng.integers(0, hi, n)]


def _batch(kind):
    """Padded texts of the family: its specials, and a row over 64 tokens."""
    if kind.startswith("cam"):
        return _texts(5, seed=9) + TEXTS + [" ".join(WORDS * 4)]
    return _texts(5, seed=9, words=EL_WORDS) + EL_TEXTS


# -- configs, modules and weight names --------------------------------------------


def test_camembert_reads_as_the_roberta_family(ckpt):
    c = checkpoint.load_checkpoint(ckpt["cam"])
    assert c.config["model_type"] == "camembert"
    model = checkpoint.build_model(c)
    assert isinstance(model, bert.BertModel) and model.embeddings.padding_idx == 1
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, Unigram)
    assert (tok.before, tok.after, tok.pad, tok.unk_id) == ([5], [6], 1, 3)


@pytest.mark.parametrize("kind, width", [("el", 16), ("el_same", 32)])
def test_electra_reads_its_embedding_width(ckpt, kind, width):
    c = checkpoint.load_checkpoint(ckpt[kind])
    model = checkpoint.build_model(c)
    assert model.embeddings.word_embeddings.weight.shape[1] == width
    assert model.embeddings.LayerNorm.weight.shape == (width,)
    assert (model.embeddings_project is not None) == (width != 32)
    assert model.embeddings.padding_idx is None  # positions 0..L-1
    assert isinstance(checkpoint.build_tokenizer(c), WordPiece)


def test_the_published_electra_small_widths_give_the_projection():
    """google/electra-small-discriminator's config.json: 128-wide
    embeddings projected to 256."""
    config = {"model_type": "electra", "vocab_size": 30522, "embedding_size": 128,
              "hidden_size": 256, "num_hidden_layers": 12, "num_attention_heads": 4,
              "intermediate_size": 1024, "max_position_embeddings": 512, "type_vocab_size": 2,
              "layer_norm_eps": 1e-12, "hidden_act": "gelu", "pad_token_id": 0}
    ours = bert.BertModel(config).state_dict()
    theirs = transformers.ElectraModel(transformers.ElectraConfig(**config)).state_dict()
    assert set(ours) == set(theirs) - {"embeddings.position_ids", "embeddings.token_type_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["embeddings_project.weight"].shape == (256, 128)


@pytest.mark.parametrize("change, match", [
    ({"hidden_act": "gelu_10"}, "hidden_act"),
    ({"position_embedding_type": "rotary"}, "position_embedding_type"),
])
@pytest.mark.parametrize("kind", ["cam", "el"])
def test_unread_configs_are_refused(ckpt, kind, change, match):
    """An activation outside models/activations.py's list and a position
    type transformers does not know (`gelu_new` and the relative keys run:
    tests/test_torch_encoder_bert_variants.py)."""
    config = {**checkpoint.load_checkpoint(ckpt[kind]).config, **change}
    with pytest.raises(ValueError, match=match):
        bert.BertModel(config)


@pytest.mark.parametrize("kind, cls", [
    ("cam", "CamembertForMaskedLM"), ("el", "ElectraForPreTraining"),
    ("el", "ElectraForMaskedLM"),
])
def test_head_checkpoints_load_under_the_base_names(ckpt, kind, cls):
    """The `roberta.` and `electra.` prefixes are dropped, and so are the
    masked-LM, discriminator and generator heads; the torch state_dict's
    numpy arrays (what the JAX package holds for these families) map onto
    the same tensors."""
    state = checkpoint.read_weights(ckpt[kind])
    named = getattr(transformers, cls).from_pretrained(ckpt[kind]).state_dict()
    heads = ("lm_head.", "discriminator_predictions.", "generator_predictions.",
             "generator_lm_head.")
    assert any(k.startswith(heads) for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ----------------------------------------------------


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ in ("CamembertModel", "ElectraModel")
    return ref


@pytest.mark.parametrize("kind", ["cam", "el", "el_same"])
def test_forward_matches_transformers_torch(ckpt, kind):
    """Padded batches, every special, on every row (padded rows too)."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(kind), 512)
    assert int((mask == 0).sum()) > 0
    with torch.no_grad():
        want = _reference(ckpt[kind])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("kind", ["cam_port", "el_port"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind):
    """write_checkpoint's pytorch_model.bin loads into transformers' model
    of the family with nothing left over and nothing missing but
    CamembertModel's pooler, which the encoder never reads."""
    ref, info = transformers.AutoModel.from_pretrained(ckpt[kind], output_loading_info=True)
    assert type(ref).__name__ == ("CamembertModel" if kind == "cam_port" else "ElectraModel")
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias"}
    assert not info["unexpected_keys"]
    assert os.listdir(ckpt[kind]).count("pytorch_model.bin") == 1


def test_electra_token_types_are_zero(ckpt):
    """ELECTRA's tokenizer returns token types, zeros for a single text,
    which is what the port adds (`token_type_embeddings.weight[0]`) when
    it passes none."""
    texts = _batch("el")
    tok = transformers.AutoTokenizer.from_pretrained(ckpt["el"])(
        texts, padding=True, truncation=True, max_length=512, return_tensors="pt")
    assert int(tok["token_type_ids"].abs().sum()) == 0
    ref = _reference(ckpt["el"])
    with torch.no_grad():
        with_types = ref(**tok).last_hidden_state
        without = ref(input_ids=tok["input_ids"], attention_mask=tok["attention_mask"])
        got = checkpoint.build_model(checkpoint.load_checkpoint(ckpt["el"]))(
            tok["input_ids"], tok["attention_mask"])
    assert torch.equal(with_types, without.last_hidden_state)
    assert float((got - with_types).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["cam", "cam_st", "el", "el_same", "cam_port", "el_port"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch, pooled and normalized; the port's
    own writing of each checkpoint embeds as the original."""
    texts = _batch(kind)
    source = {"cam_port": "cam", "el_port": "el"}.get(kind, kind)
    jax_enc = FlaxTextEncoder(ckpt[source], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and jax_enc._torch is not None
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_fault_316_the_jax_flax_branch_raises_on_electra_safetensors(ckpt):
    """From a model.safetensors FlaxAutoModel loads ELECTRA, and the JAX
    package's `module.apply(params, input_ids, attention_mask)` lacks
    FlaxElectraModule's token_type_ids and position_ids: it raises. The
    port embeds that directory as the JAX package's torch branch embeds
    the pytorch_model.bin one."""
    jax_enc = FlaxTextEncoder(ckpt["el_st"], "useModel")
    with pytest.raises(TypeError, match="token_type_ids"):
        jax_enc.encode(["hello world"])
    assert jax_enc._flax is not None
    texts = _batch("el")
    want = FlaxTextEncoder(ckpt["el"], "useModel").encode(texts)
    got = hf_encoder.TextEncoder(ckpt["el_st"], "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


# -- the tokenizers ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cam", "cam_port", "el", "el_port"])
def test_tokenizer_matches_autotokenizer(ckpt, kind):
    """Ids and masks text by text and as padded batches cut at 512 and at
    8 tokens: CamemBERT's `<s>`/`</s>` at 5 and 6, `<mask>` with lstrip,
    the NOTUSED specials, runs of spaces, the charsmap; ELECTRA's
    WordPiece with its specials."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ in ("CamembertTokenizerFast", "ElectraTokenizerFast")
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    texts = TEXTS if kind.startswith("cam") else EL_TEXTS
    for text in texts:
        assert tok([text], 512)[0].tolist() == ref([text], truncation=True,
                                                   max_length=512)["input_ids"], text
    texts = texts + _batch(kind) + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def _spm_model(path, pieces, unk_id, charsmap):
    """A sentencepiece Unigram ModelProto of (piece, score, type) written
    with transformers' protobuf module (no sentencepiece needed)."""
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
    """`spec` with its pieces' scores as float32, as the sentencepiece
    model holds them (`tokenizers` writes them back with 15 digits)."""
    model = dict(spec["model"], vocab=[[p, np.float32(s)] for p, s in spec["model"]["vocab"]])
    return dict(spec, model=model)


@pytest.mark.parametrize("charsmap", [None, CHARSMAP])
def test_the_camembert_fixture_is_the_converters_file(tmp_path, charsmap):
    """`camembert_tokenizer_json` equals what `CamembertConverter` and
    `CamembertTokenizerFast.save_pretrained` write for a sentencepiece
    model of `<unk> <s> </s>` and the same pieces (ids by fairseq's offset
    of 4), and `camembert_tokenizer_config` what it writes beside it."""
    from transformers.convert_slow_tokenizer import CamembertConverter

    vocab = _pieces()
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(p, s, 1) for p, s in vocab]
    _spm_model(str(tmp_path / "sentencepiece.bpe.model"), pieces, 0, charsmap)
    index = {p: i for i, (p, _s, _t) in enumerate(pieces)}
    slow = types.SimpleNamespace(vocab_file=str(tmp_path / "sentencepiece.bpe.model"),
                                 convert_tokens_to_ids=lambda t: 4 + index[t])
    out = str(tmp_path / "out")
    transformers.CamembertTokenizerFast(
        tokenizer_object=CamembertConverter(slow).converted()).save_pretrained(out)
    with open(os.path.join(out, "tokenizer.json"), encoding="utf-8") as f:
        written = json.load(f)
    spec = fixtures.camembert_tokenizer_json(vocab, charsmap)
    assert _float32_scores(written) == _float32_scores(spec)
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        config = json.load(f)
    del config["model_max_length"]
    mine = fixtures.camembert_tokenizer_config(spec)
    assert mine.pop("model_max_length") == 512 and config == mine


def test_the_camembert_fixture_layout_is_camembert_base():
    """At 31,997 pieces the fixture holds camembert-base's 32,005 entries,
    `<mask>` at 32,004."""
    spec = fixtures.camembert_tokenizer_json([(f"p{i}", -1.0) for i in range(31_997)])
    vocab = spec["model"]["vocab"]
    assert len(vocab) == 32_005 and vocab[32_004][0] == "<mask>"
    assert [t["id"] for t in spec["added_tokens"]] == [0, 1, 2, 3, 4, 5, 6, 32_004]


def test_a_sentencepiece_only_directory_is_refused(ckpt, tmp_path):
    """microsoft/deberta-v3-base and camembert-base publish their
    tokenizer as a sentencepiece model file; the port reads a
    tokenizer.json and refuses a directory that holds only the former."""
    path = tmp_path / "spm"
    path.mkdir()
    for name in ("config.json", "pytorch_model.bin"):
        os.link(os.path.join(ckpt["cam"], name), path / name)
    (path / "sentencepiece.bpe.model").write_bytes(b"\0")
    with pytest.raises(ValueError, match="sentencepiece.bpe.model"):
        checkpoint.load_checkpoint(str(path))


# -- through HTTP ------------------------------------------------------------------


def _docs(words):
    rng = np.random.default_rng(44)
    return [
        {"id": i, "title": " ".join(rng.choice(words[:10], size=int(rng.integers(2, 20)))),
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


@pytest.mark.parametrize("kind", ["cam", "el"])
def test_http_hybrid_matches_jax(ckpt, kind):
    # fault 3.10: the JAX package caches query vectors by embedder name and
    # text across models
    jax_embedders._search_cache.clear()
    words = WORDS if kind == "cam" else EL_WORDS
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt[kind]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings(kind, settings)["status"] == "succeeded"
            assert c.add_documents(kind, _docs(words))["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index(kind), apps[0].scheduler.index(kind)
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in (" ".join(words[:3]), " ".join(words[4:6])):
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
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
