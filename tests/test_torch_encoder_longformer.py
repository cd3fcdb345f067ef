"""Longformer in the text encoder (K8): the port's `longformer` model type
(models/longformer.py: RoBERTa's embeddings, BERT's post-norm layers
around a local self-attention, run at the batch's own length), its weight
names, LongformerTokenizerFast's files, and the encoder against
transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny Longformers (2 layers, hidden 32, 4 heads,
intermediate 64, pad id 1, 514 positions, one token type, eps 1e-5) with
windows 8 (an int: a one-sided reach of 4) and [8, 16] sit beside a
seeded byte-level BPE tokenizer.json (`models/fixtures.py::
roberta_tokenizer_json`) and LongformerTokenizerFast's
tokenizer_config.json (`longformer_tokenizer_config`, held here against
what the class writes). Weights are drawn with numpy from a seed (Q and K
with a standard deviation of 0.15, so attention is peaked). transformers
has no Flax Longformer, so the JAX package's encoder runs the torch
`LongformerModel`, which pads every batch to a multiple of the largest
window and cuts those rows from its output. The port runs the batch at
its own length; the batches here are and are not multiples of the
window, and their texts run past the one-sided window. The port is held
against transformers on every row (the padded ones too, whose attention
transformers zeroes) and against the JAX package's vectors within 1e-5
under both poolings."""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    bpe,
    checkpoint,
    fixtures,
    hf_encoder,
    longformer,
)

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "long", "document", "window", "attention"]
TEXTS = ["<mask> and <s> inside </s> <pad> <unk>", "hello <mask> world", "x<mask>y  <mask>  z",
         "it's we'll DON'T café naïve", "", "  leading and trailing  "]
# the published allenai/longformer-base-4096 config.json
LONGFORMER_BASE = {
    "model_type": "longformer", "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "hidden_act": "gelu",
    "max_position_embeddings": 4098, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "attention_window": [512] * 12, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
    "sep_token_id": 2, "initializer_range": 0.02}


def _texts(n, seed, lo=0, hi=25):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(lo, hi, n)]


SPEC = fixtures.roberta_tokenizer_json(_texts(200, seed=1) + TEXTS, 700, seed=2)
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


def _write_tokenizer(path, spec=SPEC):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.longformer_tokenizer_config(spec), f)


def _config(window):
    return transformers.LongformerConfig(
        vocab_size=VOCAB_SIZE, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=514, type_vocab_size=1,
        layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2,
        attention_window=window)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """`int`: windows 8 (an int in config.json); `list`: [8, 16]; both as
    transformers saves them (model.safetensors); `port`: the port's
    write_checkpoint of `list` (pytorch_model.bin); `global`: `list` with
    every `*_global` projection drawn anew. Each with its tokenizer
    files."""
    root = tmp_path_factory.mktemp("longformer")
    out = {k: str(root / k) for k in ("int", "list", "port", "global")}
    for kind, window, seed in (("int", 8, 31), ("list", [8, 16], 32)):
        model = transformers.LongformerModel(_config(window))
        _draw_weights(model, seed)
        model.save_pretrained(out[kind])
        _write_tokenizer(out[kind])
    # LongformerModel turns the config's int into a list; the file keeps the int
    with open(os.path.join(out["int"], "config.json")) as f:
        config = json.load(f)
    with open(os.path.join(out["int"], "config.json"), "w") as f:
        json.dump({**config, "attention_window": 8}, f)
    c = checkpoint.load_checkpoint(out["list"])
    checkpoint.write_checkpoint(out["port"], c.config, c.state_dict, tokenizer_json=SPEC)
    rng = np.random.default_rng(33)
    state = {k: (torch.from_numpy(rng.normal(0.0, 0.5, tuple(v.shape)).astype(np.float32))
                 if "_global." in k else v) for k, v in c.state_dict.items()}
    checkpoint.write_checkpoint(out["global"], c.config, state, tokenizer_json=SPEC)
    return out


def _batch(seed=9, long=True):
    """Padded texts with every special, and (`long`) rows far past the
    one-sided windows of 4 and 8 tokens."""
    texts = _texts(5, seed) + TEXTS
    if long:
        texts += [" ".join(WORDS * 3), " ".join(WORDS[::-1] * 5)]
    return texts


# -- configs, modules and weight names --------------------------------------------


def test_the_config_reads_as_longformer(ckpt):
    for kind, windows in (("int", [8, 8]), ("list", [8, 16]), ("port", [8, 16])):
        c = checkpoint.load_checkpoint(ckpt[kind])
        model = checkpoint.build_model(c)
        assert isinstance(model, longformer.LongformerModel)
        assert model.config["attention_window"] == windows
        assert model.embeddings.padding_idx == 1  # RoBERTa's positions
        tok = checkpoint.build_tokenizer(c)
        assert isinstance(tok, bpe.BPE) and (tok.before, tok.after, tok.pad) == ([0], [2], 1)


def test_the_published_widths_give_longformer_base():
    """allenai/longformer-base-4096's config.json: the module's names and
    shapes are transformers' LongformerModel's, the `*_global` projections
    among them, the pooler left out."""
    ours = longformer.LongformerModel(LONGFORMER_BASE).state_dict()
    theirs = transformers.LongformerModel(transformers.LongformerConfig(**LONGFORMER_BASE))
    theirs = {k: v for k, v in theirs.state_dict().items() if not k.startswith("pooler.")}
    assert set(ours) == set(theirs)
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    assert "encoder.layer.11.attention.self.value_global.weight" in ours


@pytest.mark.parametrize("window, match", [
    (7, "attention_window 7 of layer 0 is odd"),
    ([8, 15], "attention_window 15 of layer 1 is odd"),
    (0, "attention_window 0 of layer 0 is not positive"),
    ([8, -2], "attention_window -2 of layer 1 is not positive"),
    ([8], "attention_window has 1 entries, not one for each of the 2 layers"),
    ([8, 8, 8], "attention_window has 3 entries"),
])
def test_unread_windows_are_refused_as_transformers_asserts(window, match):
    """An odd window, a window of 0 or less and a list of the wrong length:
    the port refuses each by name, and transformers asserts on each."""
    config = {**_config(8).to_dict(), "attention_window": window}
    with pytest.raises(ValueError, match=match):
        longformer.LongformerModel(config)
    with pytest.raises(AssertionError):
        transformers.LongformerModel(_config(window))


def test_a_global_attention_mask_is_refused(ckpt):
    c = checkpoint.load_checkpoint(ckpt["list"])
    ids, mask = checkpoint.build_tokenizer(c)(["hello world"], 512)
    model = checkpoint.build_model(c)
    with pytest.raises(ValueError, match="global_attention_mask"):
        model(ids, mask, global_attention_mask=torch.zeros_like(mask))


@pytest.mark.parametrize("cls", ["LongformerForMaskedLM", "LongformerModel"])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls):
    """The `longformer.` prefix, the masked-LM head and the pooler are
    dropped; the torch state_dict's numpy arrays (what the JAX package
    holds) map onto the same tensors."""
    state = checkpoint.read_weights(ckpt["list"], "longformer")
    named = getattr(transformers, cls).from_pretrained(ckpt["list"]).state_dict()
    assert any(k.startswith(("lm_head.", "pooler.")) for k in named)
    for tensors in (named, {k: v.numpy() for k, v in named.items()}):
        got = checkpoint.hf_to_state_dict(tensors, "longformer")
        assert set(got) == set(state)
        for name in state:
            assert torch.equal(got[name], state[name]), name


def test_the_port_writes_checkpoints_transformers_reads(ckpt):
    """write_checkpoint's pytorch_model.bin loads into LongformerModel with
    nothing left over and nothing missing but the pooler."""
    ref, info = transformers.AutoModel.from_pretrained(ckpt["port"], output_loading_info=True)
    assert type(ref).__name__ == "LongformerModel"
    assert set(info["missing_keys"]) <= {"pooler.dense.weight", "pooler.dense.bias"}
    assert not info["unexpected_keys"]
    assert os.listdir(ckpt["port"]).count("pytorch_model.bin") == 1


# -- the forward and the encoder ----------------------------------------------------


def _reference(path):
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert type(ref).__name__ == "LongformerModel"
    return ref


def _ids(kind, texts, ckpt):
    c = checkpoint.load_checkpoint(ckpt[kind])
    ids, mask = checkpoint.build_tokenizer(c)(texts, 512)
    return c, ids, mask


@pytest.mark.parametrize("kind", ["int", "list"])
@pytest.mark.parametrize("multiple", [False, True])
def test_forward_matches_transformers_on_every_row(ckpt, kind, multiple):
    """Padded batches whose length is and is not a multiple of the largest
    window (transformers pads the latter itself), rows past the one-sided
    window: every row, the padded ones too (transformers zeroes a padded
    query's attention)."""
    c, ids, mask = _ids(kind, _batch(), ckpt)
    window = max(checkpoint.check_config(c.config)["attention_window"])
    # cut the batch (ids and mask) to a multiple of the window, or 3 short of one
    cut = ids.shape[1] // window * window - (0 if multiple else 3)
    ids, mask = ids[:, :cut].contiguous(), mask[:, :cut].contiguous()
    assert (ids.shape[1] % window == 0) == multiple
    assert int(mask.sum(1).max()) > 2 * window and int((mask == 0).sum()) > 0
    with torch.no_grad():
        want = _reference(ckpt[kind])(input_ids=ids, attention_mask=mask).last_hidden_state
        got = checkpoint.build_model(c)(ids, mask)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= ATOL


def test_a_padded_query_that_sees_no_key_is_zeroed_not_nan(ckpt):
    """A short text beside a long one: its last pads' bands hold only pads.
    Their attention output is 0 (transformers' fill), so the rows stay
    finite and equal to the reference's, and so do the real rows."""
    c, ids, mask = _ids("int", ["hello", " ".join(WORDS * 3)], ckpt)
    assert int(mask[0].sum()) + 4 < ids.shape[1]
    model = checkpoint.build_model(c)
    with torch.no_grad():
        got = model(ids, mask)
        want = _reference(ckpt["int"])(input_ids=ids, attention_mask=mask).last_hidden_state
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["int", "list", "port"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """The JAX package's torch branch, pooled and normalized; the port's
    own writing of the checkpoint embeds as the original."""
    texts = _batch(seed=10)
    source = {"port": "list"}.get(kind, kind)
    jax_enc = FlaxTextEncoder(ckpt[source], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "LongformerModel"
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_the_global_projections_move_no_vector(ckpt, pooling):
    """No token is global, so `query_global`, `key_global` and
    `value_global` are never read: drawn anew, they leave both packages'
    vectors as they were."""
    texts = _batch(seed=11)
    for package in (lambda p: FlaxTextEncoder(p, pooling),
                    lambda p: hf_encoder.TextEncoder(p, pooling, device=None)):
        before, after = (package(ckpt[k]).encode(texts) for k in ("port", "global"))
        assert np.array_equal(before, after)
    a = checkpoint.load_checkpoint(ckpt["port"]).state_dict
    b = checkpoint.load_checkpoint(ckpt["global"]).state_dict
    moved = [k for k in a if not torch.equal(a[k], b[k])]
    assert moved and all("_global." in k for k in moved)


def test_chunk_texts_counts_the_band_masks(ckpt, monkeypatch):
    """On a CUDA device a 512-token chunk must fit a quarter of the free
    memory with one (L, L) bool band mask a text for each distinct window
    counted (the arithmetic, with the device's free memory faked)."""
    enc = hf_encoder.TextEncoder(ckpt["list"], "useModel", device=None)
    enc._load()
    c = enc._model.config
    L, heads = enc.max_len, c["num_attention_heads"]
    per_text = 4 * (3 * heads * L * L + L * (6 * c["hidden_size"] + 2 * c["intermediate_size"]))
    per_text += 2 * L * L
    free = 40 * per_text * 4 + 3
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 2 * free))
    enc.device = torch.device("cuda", 0)
    assert enc.chunk_texts() == 40


# -- the tokenizer -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["list", "port"])
def test_tokenizer_matches_autotokenizer(ckpt, kind):
    """Ids and masks text by text and as padded batches cut at 512 and at
    8 tokens: LongformerTokenizerFast's `<s> $A </s>`, `<mask>` with
    lstrip, the ByteLevel words."""
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert type(ref).__name__ == "LongformerTokenizerFast"
    tok = checkpoint.build_tokenizer(checkpoint.load_checkpoint(ckpt[kind]))
    for text in TEXTS:
        assert tok([text], 512)[0].tolist() == ref([text], truncation=True,
                                                   max_length=512)["input_ids"], text
    texts = TEXTS + _batch() + [" ".join(["engine"] * 700)]
    for max_len in (512, 8):
        want = ref(texts, padding=True, truncation=True, max_length=max_len)
        ids, mask = tok(texts, max_len)
        assert ids.tolist() == want["input_ids"]
        assert mask.tolist() == want["attention_mask"]


def test_the_fixture_config_is_what_the_class_writes(tmp_path):
    """`longformer_tokenizer_config` equals what
    `LongformerTokenizerFast.save_pretrained` writes beside the file (but
    model_max_length, longformer-base-4096's 4096), and the file comes
    back as it went in."""
    from tokenizers import Tokenizer

    transformers.LongformerTokenizerFast(
        tokenizer_object=Tokenizer.from_str(json.dumps(SPEC))).save_pretrained(str(tmp_path))
    with open(tmp_path / "tokenizer_config.json") as f:
        config = json.load(f)
    with open(tmp_path / "tokenizer.json", encoding="utf-8") as f:
        assert json.load(f) == SPEC
    del config["model_max_length"]
    mine = fixtures.longformer_tokenizer_config(SPEC)
    assert mine.pop("model_max_length") == 4096 and config == mine


def test_a_longformer_class_over_another_tokenizer_is_refused(ckpt, tmp_path):
    """LongformerTokenizer(Fast) reads a byte-level BPE; over a Unigram
    tokenizer.json the port refuses it by name."""
    path = tmp_path / "unigram"
    path.mkdir()
    for name in ("config.json", "model.safetensors"):
        os.link(os.path.join(ckpt["list"], name), path / name)
    spec = fixtures.xlmr_tokenizer_json([("▁hello", -1.0), ("▁world", -2.0)])
    (path / "tokenizer.json").write_text(json.dumps(spec))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "LongformerTokenizerFast"}))
    with pytest.raises(ValueError, match="LongformerTokenizerFast` over a Unigram tokenizer"):
        checkpoint.load_checkpoint(str(path))
