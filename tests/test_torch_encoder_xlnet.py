"""XLNet in the text encoder (K8): the port's `xlnet` model type
(models/xlnet.py: the content stream's relative attention, `rel_shift_bnij`,
the segment term, the mask that lets a pad query see itself), its weight
names, XLNetTokenizerFast's Unigram layout (`$A:0 <sep>:0 <cls>:2`, left
padding with pad type 3) and the token types carried from the tokenizer
to the model, against transformers and the JAX package's
`FlaxTextEncoder`.

Nothing is downloaded. Tiny XLNets (2 layers, d_model 32, 4 heads, d_inner
48) are built from an `XLNetConfig`, their weights drawn with numpy from a
seed (LayerNorm scales near 1, every bias and `seg_embed` off zero, Q and
K with a standard deviation of 0.15):
- `base`: xlnet-base-cased's flags (`gelu`, `untie_r`, `attn_type` `bi`,
  `clamp_len` -1);
- `clamp`: `clamp_len` 6 (shorter than the long texts), `relu`, and
  `same_length` and `mem_len`, which change nothing without memory.
Each sits beside a seeded Unigram tokenizer.json in `XLNetConverter`'s
layout (`models/fixtures.py::xlnet_tokenizer_json`, held against the
converter on a sentencepiece `ModelProto` built with transformers' protobuf
module) and is saved as pytorch_model.bin (the JAX package's torch branch:
transformers has no Flax XLNet); `base` also as model.safetensors and as
the port's `write_checkpoint` writes it. The JAX package passes the
tokenizer's `token_type_ids` to the model (`**tok`): `<cls>` is type 2
and the left padding type 3, so the segment term is not constant."""

import json
import os
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from transformers.models.xlnet import modeling_xlnet as hf_xlnet  # noqa: E402

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, fixtures, hf_encoder, xlnet  # noqa: E402
from meilisearch_tpu_torch.models.unigram import Unigram  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "Café", "naïve", "Hello", "World", "GPU", "12,"]
CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,!?'\"-"
TEXTS = [
    "Hello, World!", "Café naïve — déjà vu, ÉLÈVE", "``quoted'' and ''again``",
    "runs    of   spaces", "<mask> and <cls> inside <sep> <pad> <unk>", "hello <mask> world",
    "", "  leading and trailing  ", "Ａｂｃ ﬁne", "résumé 12, 3,4", "✈ unknown ☃",
]
CONFIGS = {
    "base": dict(),
    "clamp": dict(clamp_len=6, ff_activation="relu", same_length=True, mem_len=8, reuse_len=4),
}
PUBLISHED = {  # xlnet-base-cased's config.json
    "model_type": "xlnet", "vocab_size": 32000, "d_model": 768, "n_layer": 12, "n_head": 12,
    "d_inner": 3072, "ff_activation": "gelu", "untie_r": True, "attn_type": "bi",
    "bi_data": False, "clamp_len": -1, "same_length": False, "layer_norm_eps": 1e-12,
    "mem_len": None, "reuse_len": None, "pad_token_id": 5, "bos_token_id": 1,
    "eos_token_id": 2,
}


def _pieces() -> list:
    rng = np.random.default_rng(6)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:], w.lower()]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


CHARSMAP = fixtures.build_charsmap({"Ａ": "A", "ｂ": "b", "ｃ": "c", "ﬁ": "fi"})
SPEC = fixtures.xlnet_tokenizer_json(_pieces(), CHARSMAP)
VOCAB_SIZE = len(SPEC["model"]["vocab"])


def _config(kind):
    return transformers.XLNetConfig(vocab_size=VOCAB_SIZE, d_model=32, n_layer=2, n_head=4,
                                    d_inner=48, **CONFIGS[kind])


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else (the relative biases and `seg_embed`
    too) normal(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            std = 0.15 if name.endswith(("rel_attn.q", "rel_attn.k")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if name.endswith("layer_norm.weight"):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, spec=SPEC):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.xlnet_tokenizer_config(spec), f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """For each of CONFIGS a pytorch_model.bin directory; `base_st` as
    model.safetensors; `base_port` the port's write_checkpoint."""
    root = tmp_path_factory.mktemp("xlnet")
    out = {}
    for seed, kind in enumerate(CONFIGS, start=51):
        model = transformers.XLNetModel(_config(kind))
        _draw_weights(model, seed)
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=False)
        _write_tokenizer(out[kind])
        if kind == "base":
            out["base_st"] = str(root / "base_st")
            model.save_pretrained(out["base_st"], safe_serialization=True)
            _write_tokenizer(out["base_st"])
    c = checkpoint.load_checkpoint(out["base"])
    out["base_port"] = str(root / "base_port")
    checkpoint.write_checkpoint(out["base_port"], c.config, c.state_dict, tokenizer_json=SPEC)
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _texts(n, seed, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, hi, n)]


def _batch():
    """Left-padded texts: the specials, accents, quotes and a row of 64
    tokens or more."""
    return _texts(5, seed=9) + TEXTS + [" ".join(WORDS * 3)]


# -- configs, modules, weight names and the position terms ----------------------------


def test_the_published_widths_give_xlnet_base_cased():
    """xlnet-base-cased's config.json: the module's parameters are
    XLNetModel's by name and shape (built on the meta device), and its
    widths read as BERT's names for the encoder."""
    config = xlnet.check_config(PUBLISHED)
    assert (config["hidden_size"], config["num_attention_heads"], config["d_head"],
            config["intermediate_size"]) == (768, 12, 64, 3072)
    with torch.device("meta"):
        ours = xlnet.XLNetModel(PUBLISHED).state_dict()
        theirs = transformers.XLNetModel(transformers.XLNetConfig(**PUBLISHED)).state_dict()
    assert set(ours) == set(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert ours["layer.0.rel_attn.seg_embed"].shape == (2, 12, 64)


@pytest.mark.parametrize("d_model, clamp", [(32, -1), (32, 6), (768, -1), (1024, 40)])
def test_the_position_table_is_transformers(d_model, clamp):
    """Every length to 130, bit for bit, against XLNetModel's
    `relative_positional_encoding` (klen = qlen, `bi`)."""
    ref = transformers.XLNetModel(transformers.XLNetConfig(
        vocab_size=8, d_model=d_model, n_layer=1, n_head=4, d_inner=8, clamp_len=clamp))
    for n in range(1, 131):
        want = ref.relative_positional_encoding(n, n, bsz=None)[:, 0]
        got = xlnet.positional_encoding(n, d_model, clamp)
        assert got.shape == (2 * n, d_model) and torch.equal(got, want), n


@pytest.mark.parametrize("shape", [(2, 3, 5, 10), (1, 4, 17, 34)])
def test_rel_shift_is_transformers(shape):
    """`rel_shift_bnij` bit for bit, and its meaning: query i reads
    column klen - i + j of the (2 klen) position scores for key j."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(3))
    klen = shape[2]
    got = xlnet.rel_shift_bnij(x, klen)
    assert torch.equal(got, hf_xlnet.XLNetRelativeAttention.rel_shift_bnij(x, klen))
    i, j = 1, 3
    assert torch.equal(got[..., i, j], x[..., i, klen - i + j])


def test_a_pad_query_sees_the_text_and_itself():
    """The non-target mask: padded keys masked, but every query sees its
    own position, a pad's included (hazard 3.18's row is not empty here)."""
    mask = torch.tensor([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]])
    masked = xlnet.masked_keys(mask)
    assert torch.equal(masked[0, 0], torch.tensor([0.0, 1, 0, 0, 0]))
    assert torch.equal(masked[0, 3], torch.tensor([1.0, 1, 0, 0, 0]))
    assert not bool(masked[1].any())


@pytest.mark.parametrize("change, match", [
    ({"bi_data": True}, "bi_data"),
    ({"attn_type": "uni"}, "attn_type"),
    ({"attn_type": "tri"}, "attn_type"),
    ({"d_head": 16}, "d_head"),
    ({"ff_activation": "gelu_10"}, "ff_activation"),
])
def test_unread_xlnet_configs_are_refused(ckpt, change, match):
    """Each raises in transformers too (or, for `bi_data`, gives a vector
    that depends on its place in the batch, raises on an odd batch and
    returns no row for one text; for `uni`, raises on a batch of two)."""
    config = {**checkpoint.load_checkpoint(ckpt["base"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


def test_transformers_raises_on_uni_batches_and_bi_data_singles(ckpt):
    """What the refusals above stand on."""
    ids = torch.tensor([[10, 11, 12], [10, 11, 12]])
    mask = torch.tensor([[0, 1, 1], [1, 1, 1]])
    uni = transformers.XLNetModel(transformers.XLNetConfig(
        vocab_size=20, d_model=8, n_layer=1, n_head=2, d_inner=8, attn_type="uni"))
    with pytest.raises(RuntimeError):
        uni(input_ids=ids, attention_mask=mask)
    bi_data = transformers.XLNetModel(transformers.XLNetConfig(
        vocab_size=20, d_model=8, n_layer=1, n_head=2, d_inner=8, bi_data=True)).eval()
    with torch.no_grad():
        assert bi_data(input_ids=ids[:1], attention_mask=mask[:1]).last_hidden_state.shape[0] == 0
        with pytest.raises(RuntimeError):
            bi_data(input_ids=ids[[0, 1, 1]], attention_mask=mask[[1, 1, 1]])


@pytest.mark.parametrize("cls", ["XLNetLMHeadModel", "XLNetForSequenceClassification"])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls):
    """The `transformer.` prefix (kept on DistilBERT's `transformer.layer`
    only), `lm_loss.`, `sequence_summary.` and `logits_proj.` are dropped,
    from torch tensors and numpy arrays."""
    state = checkpoint.read_weights(ckpt["base"])
    assert "layer.0.rel_attn.q" in state and "mask_emb" in state
    named = getattr(transformers, cls).from_pretrained(ckpt["base"]).state_dict()
    assert any(k.startswith("transformer.layer.") for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors)
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("typed", [True, False])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_forward_matches_automodel(ckpt, kind, typed):
    """AutoModel's last hidden state on every row of a left-padded batch,
    pad rows included, with the tokenizer's token types and without."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask, tt = checkpoint.build_tokenizer(c).encode_types(_batch(), 512)
    assert int((mask == 0).sum()) > 0 and int(mask[:, 0].min()) == 0
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    assert type(ref).__name__ == "XLNetModel"
    extra = {"token_type_ids": tt} if typed else {}
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask, **extra).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask, tt if typed else None)
    assert float((got - want).abs().max()) <= ATOL


def test_the_cls_type_moves_the_vector(ckpt):
    """`<cls>` typed 0 instead of 2 (or the pad 0 instead of 3) changes the
    segment term, and the output beyond the tolerance."""
    c = checkpoint.load_checkpoint(ckpt["base"])
    ids, mask, tt = checkpoint.build_tokenizer(c).encode_types(_batch(), 512)
    model = checkpoint.build_model(c)
    with torch.no_grad():
        want = model(ids, mask, tt)
        assert float((model(ids, mask, torch.where(tt == 2, 0, tt)) - want).abs().max()) > 1e-3
        assert float((model(ids, mask, torch.where(tt == 3, 0, tt)) - want).abs().max()) > 1e-3


def test_the_encoder_passes_the_token_types(ckpt):
    enc = hf_encoder.TextEncoder(ckpt["base"], "useModel", device=None)
    enc._load()
    assert enc._types
    ids, mask, tt = enc.tokenize(["hello world search engine", "rust"])
    pads = int((mask[1] == 0).sum())
    assert pads > 0 and ids[1, :pads].tolist() == [5] * pads
    assert tt[1].tolist() == [3] * pads + [0] * (ids.shape[1] - pads - 1) + [2]
    assert tt[0].tolist() == [0] * (ids.shape[1] - 1) + [2]


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["base", "base_st", "base_port", "clamp"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the pytorch_model.bin directory,
    pooled and normalized. Under `forceCls` position 0 is a pad for every
    text shorter than the longest, and its state reads the text at a
    distance set by the padding: chunks of 3 are cut from the call's one
    padded batch, as the JAX package pads it."""
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


def test_forcecls_pools_a_pad_row_as_the_reference(ckpt):
    """Under left padding `forceCls` takes row 0, a pad of every text
    shorter than its batch's longest, in the reference (`hidden[:, 0]`)
    as in the port; a text alone has no pad, so its vector differs."""
    texts = ["rust", " ".join(WORDS)]
    enc = hf_encoder.TextEncoder(ckpt["base"], "forceCls", device=None)
    ids, mask, tt = (enc._load(), enc.tokenize(texts))[1]
    assert int(mask[0, 0]) == 0 and int(mask[1, 0]) == 1
    jax_enc = FlaxTextEncoder(ckpt["base"], "forceCls")
    together = enc.encode(texts)
    np.testing.assert_allclose(together, jax_enc.encode(texts), atol=ATOL)
    alone = enc.encode(texts[:1])
    np.testing.assert_allclose(alone, jax_enc.encode(texts[:1]), atol=ATOL)
    assert float(np.abs(alone[0] - together[0]).max()) > 1e-3


# -- the tokenizer ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["base", "base_port"])
def test_tokenizer_matches_tokenizers_left_padded(ckpt, kind):
    """Ids, masks and type ids, text by text and as left-padded batches
    cut at 512 and at 8 tokens, against AutoTokenizer (XLNetTokenizerFast)
    and `tokenizers`' own Tokenizer on the same file with XLNet's padding
    (left, pad id 5, pad type 3)."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == "XLNetTokenizerFast" and ref.padding_side == "left"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    assert isinstance(tok, Unigram)
    assert (tok.before, tok.after, tok.types, tok.pad, tok.pad_type, tok.padding_side) == (
        [], [4, 3], ([], 0, [0, 2]), 5, 3, "left")
    raw = tokenizers.Tokenizer.from_file(os.path.join(ckpt[kind], "tokenizer.json"))
    for text in TEXTS:
        enc = raw.encode(text)
        assert tok([text], 512)[0][0].tolist() == enc.ids, text
        assert tok.encode_types([text], 512)[2][0].tolist() == enc.type_ids, text
    texts = TEXTS + _batch() + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask, tt = tok.encode_types(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]
        assert tt.tolist() == want["token_type_ids"]
        raw.enable_padding(direction="left", pad_id=5, pad_type_id=3, pad_token="<pad>")
        raw.enable_truncation(max_length=max_len)
        batch = raw.encode_batch(texts)
        assert ids.tolist() == [e.ids for e in batch]
        assert tt.tolist() == [e.type_ids for e in batch]
        raw.no_padding()
        raw.no_truncation()


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


@pytest.mark.parametrize("lower, keep", [(False, False), (True, True)])
@pytest.mark.parametrize("charsmap", [None, CHARSMAP], ids=["plain", "charsmap"])
def test_the_xlnet_fixture_is_the_converters_file(tmp_path, lower, keep, charsmap):
    """`xlnet_tokenizer_json` equals what `XLNetConverter` and
    `XLNetTokenizerFast.save_pretrained` write (a piece ending in a digit
    and a comma scored 100 lower; `<eod>` and `<eop>` user-defined), and
    `xlnet_tokenizer_config` what it writes beside it."""
    from transformers.convert_slow_tokenizer import XLNetConverter

    kinds = {"<unk>": 2, **{t: 4 for t in fixtures.XLNET_USER}}
    pieces = [(p, 0.0, kinds.get(p, 3)) for p in fixtures.XLNET_HEAD]
    pieces += [(p, s, 1) for p, s in _pieces()]
    model_file = str(tmp_path / "spiece.model")
    _spm_model(model_file, pieces, 0, charsmap)
    index = {p: i for i, (p, _s, _t) in enumerate(pieces)}
    slow = types.SimpleNamespace(vocab_file=model_file, remove_space=True, do_lower_case=lower,
                                 keep_accents=keep, convert_tokens_to_ids=index.__getitem__)
    out = str(tmp_path / "out")
    transformers.XLNetTokenizerFast(tokenizer_object=XLNetConverter(slow).converted(),
                                    do_lower_case=lower, keep_accents=keep).save_pretrained(out)
    with open(os.path.join(out, "tokenizer.json"), encoding="utf-8") as f:
        written = json.load(f)
    with open(os.path.join(out, "tokenizer_config.json")) as f:
        config = json.load(f)
    spec = fixtures.xlnet_tokenizer_json(_pieces(), charsmap, lower, keep)
    assert _float32_scores(written) == _float32_scores(spec)
    del config["model_max_length"]
    assert config == fixtures.xlnet_tokenizer_config(spec)


def test_the_fixture_layout_is_xlnet_base_cased():
    """At 31,991 pieces the fixture holds xlnet-base-cased's 32,000
    entries, `<pad>` at 5, `<sep>` 4 and `<cls>` 3."""
    spec = fixtures.xlnet_tokenizer_json([(f"p{i}", -1.0) for i in range(31_991)])
    assert len(spec["model"]["vocab"]) == 32_000
    tok = Unigram(spec, fixtures.xlnet_tokenizer_config(spec))
    assert (tok.pad, tok.after, tok.padding_side) == (5, [4, 3], "left")


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(53)
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


def test_http_hybrid_with_an_xlnet_embedder_matches_jax(ckpt):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt["base"]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings("xl", settings)["status"] == "succeeded"
            assert c.add_documents("xl", _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index("xl"), apps[0].scheduler.index("xl")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("hello world search", "rust python"):
            for ratio in (1.0, 0.5):
                body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "showRankingScore": True, "limit": 20}
                want, got = (c.post("/indexes/xl/search", body=dict(body)) for c in clients)
                assert want.status == got.status == 200, (want.json, got.json)
                _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
