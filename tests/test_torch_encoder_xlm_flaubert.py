"""XLM and FlauBERT with their own tokenizers in the text encoder (K8):
transformers' slow `XLMTokenizer` and `FlaubertTokenizer` (Moses, then a
`</w>` BPE over vocab.json + merges.txt; models/moses.py and
models/xlm_bpe.py), the `flaubert` model type (models/xlm.py: XLM's
forward, with `pre_norm`), the tokenizer class chosen as `AutoTokenizer`
chooses it, against transformers and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. Tiny models (2 layers, width 32, 4 heads) are built
from transformers' configs, their weights drawn with numpy from a seed
(LayerNorm scales near 1, every bias off zero, Q and K with a standard
deviation of 0.15), beside a seeded BPE in XLM's layout
(`fixtures.moses_bpe_files`: the specials at ids 0-13, merges trained on
the texts' Moses tokens, merges.txt with counts) and the
tokenizer_config.json the class's own `save_pretrained` writes:
- `xlm_en`: xlm-mlm-en-2048's flags, `do_lowercase_and_remove_accent`
  (lowercased before and after Moses);
- `xlm_100`: XLM-100's `do_lowercase_and_remove_accent: false`, two
  languages;
- `flaubert_cased`: flaubert_base_cased's (`pre_norm` false, `do_lowercase`
  false);
- `flaubert_pre`: `pre_norm`, `layerdrop` 0.2, two languages, sinusoidal
  positions;
- `flaubert_uncased`: flaubert_base_uncased's `do_lowercase`;
- `xlm_en_legacy`, `flaubert_legacy`: no tokenizer_config.json (the class
  is the model type's); `flaubert_as_xlm`: none either, config.json naming
  `XLMTokenizer` (AutoTokenizer reads it before the model type's);
- `xlm_en_st`: model.safetensors; `flaubert_port`: the port's
  `write_checkpoint`.
Each is saved as pytorch_model.bin (but `_st` and `_port`): the JAX
package's torch branch, since transformers has no Flax XLM or FlauBERT.
Both tokenizer classes give `token_type_ids` (zeros), which the models
look up in their word table."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("sacremoses")

from meilisearch_tpu.api.app import App as JaxApp  # noqa: E402
from meilisearch_tpu.api.app import TestClient as JaxClient  # noqa: E402
from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu.vector import embedders as jax_embedders  # noqa: E402
from meilisearch_tpu_torch.api.app import App, TestClient  # noqa: E402
from meilisearch_tpu_torch.models import (  # noqa: E402
    checkpoint,
    fixtures,
    hf_encoder,
    moses,
    xlm,
    xlm_bpe,
)

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "Café", "naïve", "Hello", "World", "GPU", "l'homme",
         "aujourd'hui", "élève", "déjà", "No.", "5", "1,000.5", "Mr.", "Smith"]
TEXTS = [
    "Hello, World. Café naïve", "hello\nworld\tagain", "« bonjour » l'homme aujourd'hui",
    "No. 5 costs 1,000.5 ... Mr. Smith", "Say <special1> and </s> <S> <SPECIAL1>",
    "``quoted'' and ''again''", "Café ÉLÈVE ΣΑΣ", "", "  ", "x" * 40,
    "中文 search，ｆｕｌｌ（ｗｉｄｔｈ）", "it's don't we'll", "✈ unknown ☃ \U0001F680",
]
KINDS = {  # kind -> (config class kwargs, tokenizer class, tokenizer flags)
    "xlm_en": ("xlm", {}, {}),
    "xlm_100": ("xlm", dict(n_langs=2), {"do_lowercase_and_remove_accent": False}),
    "flaubert_cased": ("flaubert", {}, {}),
    "flaubert_pre": ("flaubert", dict(pre_norm=True, layerdrop=0.2, n_langs=2,
                                      sinusoidal_embeddings=True), {}),
    "flaubert_uncased": ("flaubert", {}, {"do_lowercase": True}),
}
FLAUBERT_BASE_CASED = {  # flaubert/flaubert_base_cased's widths and flags
    "model_type": "flaubert", "vocab_size": 68729, "emb_dim": 768, "n_layers": 12,
    "n_heads": 12, "gelu_activation": True, "sinusoidal_embeddings": False, "causal": False,
    "n_langs": 1, "use_lang_emb": True, "max_position_embeddings": 512,
    "layer_norm_eps": 1e-12, "pad_index": 2, "pad_token_id": 2, "is_encoder": True,
    "pre_norm": False, "layerdrop": 0.0,
}


def _class(family: str) -> str:
    return "FlaubertTokenizer" if family == "flaubert" else "XLMTokenizer"


def _corpus(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, 30, n)]


def _draw_weights(model, seed):
    """Every parameter drawn with numpy: LayerNorm scales near 1, Q and K
    normal(0, 0.15), everything else (biases too) normal(0, 0.05); but a
    sinusoidal position table, which transformers fills and never trains."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "position_embeddings.weight" and model.config.sinusoidal_embeddings:
                continue
            std = 0.15 if name.endswith(("q_lin.weight", "k_lin.weight")) else 0.05
            draw = rng.normal(0.0, std, tuple(p.shape))
            if name.endswith("weight") and ("layer_norm" in name):
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


def _write_tokenizer(path, family, flags, seed):
    """A seeded BPE in XLM's layout, saved by the class itself (its
    tokenizer_config.json), then merges.txt again with counts."""
    lower = family == "xlm" and flags.get("do_lowercase_and_remove_accent", True)
    lower = lower or flags.get("do_lowercase", False)
    vocab, merges = fixtures.moses_bpe_files(
        _corpus(300, seed) + TEXTS, 1500, seed, lang="fr" if family == "flaubert" else "en",
        lowercase=lower, n_trained=600, counts=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write(merges)
    tok = getattr(transformers, _class(family))(os.path.join(path, "vocab.json"),
                                                os.path.join(path, "merges.txt"), **flags)
    tok.save_pretrained(path)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write(merges)
    return vocab, merges


def _strip_tokenizer_config(src, dst, config_changes=None):
    shutil.copytree(src, dst)
    os.remove(os.path.join(dst, "tokenizer_config.json"))
    os.remove(os.path.join(dst, "special_tokens_map.json"))
    if config_changes:
        with open(os.path.join(dst, "config.json")) as f:
            config = json.load(f)
        with open(os.path.join(dst, "config.json"), "w") as f:
            json.dump({**config, **config_changes}, f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("xlm_flaubert")
    out, files = {}, {}
    for seed, (kind, (family, config, flags)) in enumerate(KINDS.items(), start=71):
        path = str(root / kind)
        os.makedirs(path)
        files[kind] = _write_tokenizer(path, family, flags, seed)
        cls = transformers.XLMConfig if family == "xlm" else transformers.FlaubertConfig
        model = transformers.AutoModel.from_config(cls(
            vocab_size=len(files[kind][0]), emb_dim=32, n_layers=2, n_heads=4,
            max_position_embeddings=600, **config))
        _draw_weights(model, seed)
        model.save_pretrained(path, safe_serialization=False)
        out[kind] = path
        if kind == "xlm_en":
            out["xlm_en_st"] = str(root / "xlm_en_st")
            shutil.copytree(path, out["xlm_en_st"])
            os.remove(os.path.join(out["xlm_en_st"], "pytorch_model.bin"))
            model.save_pretrained(out["xlm_en_st"], safe_serialization=True)
    out["xlm_en_legacy"] = str(root / "xlm_en_legacy")
    _strip_tokenizer_config(out["xlm_en"], out["xlm_en_legacy"])
    out["flaubert_legacy"] = str(root / "flaubert_legacy")
    _strip_tokenizer_config(out["flaubert_cased"], out["flaubert_legacy"])
    out["flaubert_as_xlm"] = str(root / "flaubert_as_xlm")
    _strip_tokenizer_config(out["flaubert_cased"], out["flaubert_as_xlm"],
                            {"tokenizer_class": "XLMTokenizer"})
    c = checkpoint.load_checkpoint(out["flaubert_pre"])
    out["flaubert_port"] = str(root / "flaubert_port")
    checkpoint.write_checkpoint(out["flaubert_port"], c.config, c.state_dict,
                                moses=files["flaubert_pre"])
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    """A padded batch: TEXTS, seeded texts, and one that truncation cuts."""
    return TEXTS + _corpus(6, seed=9) + [" ".join(WORDS * 30)]


# -- configs, modules and weight names ----------------------------------------------


def test_the_published_widths_give_flaubert_base_cased():
    """FlauBERT's names and shapes are XLMModel's; FlaubertConfig's defaults
    are XLMConfig's and `pre_norm` false, `layerdrop` 0."""
    config = xlm.check_config(FLAUBERT_BASE_CASED)
    assert (config["vocab_size"], config["hidden_size"], config["intermediate_size"],
            config["pre_norm"]) == (68729, 768, 3072, False)
    with torch.device("meta"):
        ours = xlm.XLMModel(FLAUBERT_BASE_CASED).state_dict()
        theirs = transformers.FlaubertModel(
            transformers.FlaubertConfig(**FLAUBERT_BASE_CASED)).state_dict()
    assert set(ours) == set(theirs) - {"position_ids"}
    assert all(ours[k].shape == theirs[k].shape for k in ours)
    defaults = transformers.FlaubertConfig()
    checked = xlm.check_config({"model_type": "flaubert"})
    for name in (*xlm.DEFAULTS, "pre_norm", "layerdrop"):
        assert checked[name] == getattr(defaults, name), name


def test_an_xlm_config_reads_no_pre_norm():
    """XLMModel never reads `pre_norm`: an `xlm` config that carries it
    runs post-norm, as transformers does."""
    assert xlm.check_config({"model_type": "xlm", "pre_norm": True})["pre_norm"] is False
    assert xlm.check_config({"model_type": "flaubert", "pre_norm": True})["pre_norm"] is True


@pytest.mark.parametrize("change, match", [({"is_encoder": False}, "is_encoder"),
                                           ({"n_heads": 5}, "n_heads")])
def test_unread_flaubert_configs_are_refused(ckpt, change, match):
    config = {**checkpoint.load_checkpoint(ckpt["flaubert_cased"]).config, **change}
    with pytest.raises(ValueError, match=match):
        checkpoint.check_config(config)


@pytest.mark.parametrize("cls", ["FlaubertWithLMHeadModel", "FlaubertForSequenceClassification"])
def test_head_checkpoints_load_under_the_base_names(ckpt, cls):
    """The `transformer.` prefix and the heads (`pred_layer.`,
    `sequence_summary.`) are dropped."""
    state = checkpoint.read_weights(ckpt["flaubert_cased"])
    named = getattr(transformers, cls).from_pretrained(ckpt["flaubert_cased"]).state_dict()
    assert any(k.startswith("transformer.") for k in named)
    got = checkpoint.hf_to_state_dict(named)
    assert set(got) == set(state)
    for name in state:
        assert torch.equal(got[name], state[name]), name


# -- the tokenizers ----------------------------------------------------------------


@pytest.mark.parametrize("kind", [*KINDS, "xlm_en_legacy", "flaubert_legacy",
                                  "flaubert_as_xlm", "flaubert_port"])
def test_the_class_is_autotokenizers(ckpt, kind, monkeypatch):
    """tokenizer_config.json's class, else config.json's, else the model
    type's; vocab.json + merges.txt are never read as RoBERTa's byte-level
    BPE."""
    monkeypatch.setattr(checkpoint, "legacy_spec", None)  # calling it raises
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    c = checkpoint.load_checkpoint(ckpt[kind])
    assert c.moses is not None and c.moses[2] == type(ref).__name__
    assert type(checkpoint.build_tokenizer(c)) is xlm_bpe.MosesBPE
    assert checkpoint.gives_token_types(c) and "token_type_ids" in ref("x")


@pytest.mark.parametrize("kind", [*KINDS, "xlm_en_legacy", "flaubert_legacy",
                                  "flaubert_as_xlm", "flaubert_port"])
def test_tokenizer_matches_transformers(ckpt, kind):
    """Ids, mask and token types bit for bit on a padded batch, one text
    truncated at 512 with `</s>` kept."""
    texts = _batch()
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    want = ref(texts, padding=True, truncation=True, max_length=512, return_tensors="pt")
    enc = hf_encoder.TextEncoder(ckpt[kind], "useModel", device=None)
    enc._load()
    ids, mask, types = enc.tokenize(texts)
    assert ids.shape[1] == 512 and int(mask.sum(1).min()) == 2
    assert torch.equal(ids, want["input_ids"])
    assert torch.equal(mask, want["attention_mask"])
    assert torch.equal(types, want["token_type_ids"])


def _ids(path, text):
    enc = hf_encoder.TextEncoder(path, "useModel", device=None)
    enc._load()
    return enc._tokenizer, enc._tokenizer.ids(text)


def _run(seq, part):
    return any(seq[i:i + len(part)] == part for i in range(len(seq) - len(part) + 1))


@pytest.mark.parametrize("kind, text, pinned", [
    # remove_non_printing_char drops `\n`: two words become one
    ("xlm_en", "hello\nworld", lambda tok: tok.ids("helloworld")),
    ("flaubert_cased", "hello\tworld", lambda tok: tok.ids("helloworld")),
    # XLM lowercases before Moses: "world." and "mr." keep their periods
    # (a lowercase word follows), and before a digit lowercase "mr" is no
    # English prefix
    ("xlm_en", "Hello, World. Café",
     lambda tok: tok._word_ids("hello") + tok._word_ids(",") + tok._word_ids("world.")
     + tok._word_ids("cafe")),
    ("xlm_en", "Mr. Smith", lambda tok: tok._word_ids("mr.") + tok._word_ids("smith")),
    ("xlm_en", "Mr. 5", lambda tok: tok._word_ids("mr") + tok._word_ids(".")
     + tok._word_ids("5")),
    ("xlm_100", "Mr. 5", lambda tok: tok._word_ids("Mr.") + tok._word_ids("5")),
    # ...and after Moses, accents go
    ("xlm_en", "ÉLÈVE déjà", lambda tok: tok._word_ids("eleve") + tok._word_ids("deja")),
    # a literal special token is one id, and the first lowercasing makes
    # `<S>` and `<SPECIAL1>` specials
    ("xlm_en", "Say <special1> and </s>", lambda tok: tok._word_ids("say") + [5]
     + tok._word_ids("and") + [1]),
    ("xlm_en", "<S><SPECIAL1>", lambda tok: [0, 5]),
    ("flaubert_cased", "<S><special1>", lambda tok: tok._word_ids("<") + tok._word_ids("S")
     + tok._word_ids(">") + [5]),
    # without the flag (XLM-100), neither lowercasing happens
    ("xlm_100", "Café ÉLÈVE", lambda tok: tok._word_ids("Café") + tok._word_ids("ÉLÈVE")),
    # FlauBERT's preprocess_text: quotes, NFC, lowercase only with
    # do_lowercase, accents kept
    ("flaubert_cased", "``oui'' non", lambda tok: tok.ids('"oui" non')),
    ("flaubert_cased", "Café", lambda tok: tok._word_ids("Café")),
    ("flaubert_uncased", "ÉLÈVE Déjà", lambda tok: tok._word_ids("élève")
     + tok._word_ids("déjà")),
    # French elision and the French `No.`
    ("flaubert_cased", "l'homme", lambda tok: tok._word_ids("l'") + tok._word_ids("homme")),
    ("flaubert_cased", "No. 5", lambda tok: tok._word_ids("No") + tok._word_ids(".")
     + tok._word_ids("5")),
    # English's numeric-only `No` keeps its period before a number, but not
    # lowercased
    ("xlm_100", "No. 5", lambda tok: tok._word_ids("No.") + tok._word_ids("5")),
    ("xlm_en", "No. 5", lambda tok: tok._word_ids("no") + tok._word_ids(".")
     + tok._word_ids("5")),
])
def test_each_quirk(ckpt, kind, text, pinned):
    """Each quirk the reference shows, against transformers and against the
    ids it implies."""
    tok, got = _ids(ckpt[kind], text)
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert got == ref(text)["input_ids"][1:-1]
    assert got == pinned(tok)


def _small_tokenizer(path, merges, config=None):
    vocab = {t: i for i, t in enumerate(fixtures.MOSES_HEAD)}
    for piece in ["h", "e", "l", "o", "w", "r", "d", "he", "ll", "hell", "hello</w>", "o</w>",
                  "d</w>", "l</w>", "wo", "wor", "worl", "world</w>"]:
        vocab.setdefault(piece, len(vocab))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write(merges)
    ref = transformers.XLMTokenizer(os.path.join(path, "vocab.json"),
                                    os.path.join(path, "merges.txt"), **(config or {}))
    return ref, xlm_bpe.MosesBPE(vocab, merges, config or {})


@pytest.mark.parametrize("merges", [
    "h e 9\nl l 8\nhe ll\nhell o</w>\nw o\nwo r\nwor l\nworl d</w>\n",  # counts
    "h e\nl l\nhe ll\nhell o</w>\nw o\nwo r\nwor l\nworl d</w>",  # no final newline
    "#version: 0.2\nl l\nh e\nhe ll\nhell o</w>\nw o\nl l\n\n",  # a repeat, a blank line
    "w o\nwo r\nwor l\nworl d</w>\nh e\n",
])
def test_the_merges_file_as_the_class_reads_it(tmp_path, merges):
    """Every line but the file's last (so a file without a final newline
    loses its last merge), split on whitespace, the first two fields a
    pair, a repeated pair at its last rank."""
    ref, ours = _small_tokenizer(str(tmp_path), merges)
    for text in ("hello world", "Hello, World. hello", "dwell owl", ""):
        assert ours.ids(text) == ref(text)["input_ids"][1:-1], text
    assert ours.ranks == ref.bpe_ranks


def test_added_tokens_the_port_does_not_read_are_refused(tmp_path):
    merges = "h e\n"
    config = {"added_tokens_decoder": {"14": {"content": "<x>", "single_word": True,
                                              "lstrip": False, "rstrip": False,
                                              "normalized": False, "special": True}}}
    _ref, _ours = _small_tokenizer(str(tmp_path), merges)
    vocab = json.load(open(tmp_path / "vocab.json"))
    with pytest.raises(ValueError, match="single_word"):
        xlm_bpe.MosesBPE(vocab, merges, config)
    del vocab["<special3>"]
    with pytest.raises(ValueError, match="<special3>"):
        xlm_bpe.MosesBPE(vocab, merges, {})
    with pytest.raises(ValueError, match="XLMTokenizer or FlaubertTokenizer"):
        xlm_bpe.MosesBPE(vocab, merges, {}, "BertTokenizer")


def test_the_fixture_config_is_what_save_pretrained_writes(tmp_path):
    for cls, flags in (("XLMTokenizer", {}), ("FlaubertTokenizer", {"do_lowercase": True})):
        path = str(tmp_path / cls)
        _small_tokenizer(path, "h e\n")
        getattr(transformers, cls)(os.path.join(path, "vocab.json"),
                                   os.path.join(path, "merges.txt"), **flags).save_pretrained(path)
        with open(os.path.join(path, "tokenizer_config.json")) as f:
            saved = json.load(f)
        ours = fixtures.moses_tokenizer_config(cls, **flags)
        assert {k: saved[k] for k in ours} == ours


# -- the forward and the encoder ----------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_forward_matches_automodel(ckpt, kind):
    """AutoModel's last hidden state on every row of a padded batch, given
    all the tokenizer gives (its zero token types included)."""
    c = checkpoint.load_checkpoint(ckpt[kind])
    tok = transformers.AutoTokenizer.from_pretrained(ckpt[kind])(
        _batch(), padding=True, truncation=True, max_length=512, return_tensors="pt")
    ref = transformers.AutoModel.from_pretrained(ckpt[kind]).eval()
    assert getattr(ref.config, "pre_norm", False) is c.config.get("pre_norm", False)
    with torch.no_grad():
        want = ref(**tok).last_hidden_state
        got = checkpoint.build_model(c)(tok["input_ids"], tok["attention_mask"],
                                        tok["token_type_ids"])
    assert float((got - want).abs().max()) <= ATOL


def test_pre_norm_moves_the_vector_and_layerdrop_does_not(ckpt):
    """`pre_norm` changes the forward; `layerdrop` and the language table
    are held and never read."""
    c = checkpoint.load_checkpoint(ckpt["flaubert_pre"])
    ids, mask = checkpoint.build_tokenizer(c)(_batch(), 512)
    model = checkpoint.build_model(c)
    assert model.lang_embeddings.weight.shape == (2, 32)
    with torch.no_grad():
        want = model(ids, mask)
        post = checkpoint.build_model(checkpoint.Checkpoint(
            {**c.config, "pre_norm": False}, c.state_dict, []))
        assert float((post(ids, mask) - want).abs().max()) > 1e-2
        still = checkpoint.build_model(checkpoint.Checkpoint(
            {**c.config, "layerdrop": 0.9}, c.state_dict, []))
        assert torch.equal(still(ids, mask), want)
        model.lang_embeddings.weight = torch.nn.Parameter(model.lang_embeddings.weight + 1.0)
        assert torch.equal(model(ids, mask), want)


@pytest.mark.parametrize("chunk", [3, 256])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", [*KINDS, "xlm_en_legacy", "xlm_en_st", "flaubert_legacy",
                                  "flaubert_as_xlm", "flaubert_port"])
def test_encoder_matches_jax(ckpt, kind, pooling, chunk, monkeypatch):
    """The JAX package's torch branch on the same directory (its tokenizer's
    outputs all passed), pooled and normalized; chunks of 3 put the texts
    in several passes, each padded to its own longest."""
    texts = _batch()
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    before = hf_encoder.FORWARDS.value
    got = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None).encode(texts)
    assert hf_encoder.FORWARDS.value - before == -(-len(texts) // chunk)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("kind", ["xlm_en", "flaubert_pre"])
def test_the_port_writes_checkpoints_transformers_reads(ckpt, kind, tmp_path):
    c = checkpoint.load_checkpoint(ckpt[kind])
    path = str(tmp_path / "port")
    checkpoint.write_checkpoint(path, c.config, c.state_dict, moses=c.moses[:2])
    ref, info = transformers.AutoModel.from_pretrained(path, output_loading_info=True)
    assert type(ref).__name__ == ("XLMModel" if kind.startswith("xlm") else "FlaubertModel")
    assert not info["missing_keys"] and not info["unexpected_keys"]
    tok = transformers.AutoTokenizer.from_pretrained(path)
    assert type(tok).__name__ == c.moses[2]
    texts = _batch()
    ids, mask = checkpoint.build_tokenizer(checkpoint.load_checkpoint(path))(texts, 512)
    assert torch.equal(ids, tok(texts, padding=True, truncation=True, max_length=512,
                                return_tensors="pt")["input_ids"])


def test_the_moses_steps_are_the_tokenizers(ckpt):
    """The tokenizer's Moses is models/moses.py's, lang en for XLM and fr
    for FlauBERT."""
    for kind, lang in (("xlm_100", "en"), ("flaubert_cased", "fr")):
        tok, got = _ids(ckpt[kind], "l'homme No. 5")
        assert tok.lang == lang
        want = [i for w in moses.moses_tokenize("l'homme No. 5", lang) for i in tok._word_ids(w)]
        assert got == want


# -- through HTTP ------------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(59)
    return [{"id": i, "title": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 20)))),
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


@pytest.mark.parametrize("kind", ["xlm_en", "flaubert_cased"])
def test_http_hybrid_matches_jax(ckpt, kind):
    jax_embedders._search_cache.clear()  # fault 3.10
    settings = {"filterableAttributes": ["points"],
                "embedders": {"default": {"source": "huggingFace", "model": ckpt[kind]}}}
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        for c in clients:
            assert c.update_settings("mx", settings)["status"] == "succeeded"
            assert c.add_documents("mx", _docs())["status"] == "succeeded"
        store, jstore = apps[1].scheduler.index("mx"), apps[0].scheduler.index("mx")
        assert set(store.vectors["default"]) == set(jstore.vectors["default"])
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("Hello world. Café", "l'homme aujourd'hui"):
            for ratio in (1.0, 0.5):
                body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "showRankingScore": True, "limit": 20}
                want, got = (c.post("/indexes/mx/search", body=dict(body)) for c in clients)
                assert want.status == got.status == 200, (want.json, got.json)
                _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
