"""The sentencepiece BPE with byte fallback in the text encoder (K8): the
port's tokenizer (models/bpe.py) on the `tokenizer.json` files that
transformers' Llama converter writes for Llama-2, Mistral and e5-mistral
(the legacy layout, `Prepend("▁")` and `Replace(" ", "▁")`, and the
Metaspace one) and its Gemma converter writes for Gemma and EmbeddingGemma
(`Replace(" ", "▁")`, `Split(" ", MergedWithPrevious)`), under
`LlamaTokenizerFast` and `GemmaTokenizerFast`, against `AutoTokenizer`;
and the `llama` and `mistral` encoders from such directories against the
JAX package's `FlaxTextEncoder`.

Nothing is downloaded and no sentencepiece model is needed: the files are
models/fixtures.py's seeded ones (`llama_tokenizer_json`,
`gemma_tokenizer_json`, the 256 `<0xNN>` pieces, merges trained on a small
corpus, then seeded ones), which `tokenizers` reads as it reads the
published files. Characters the vocabularies lack (emoji, CJK, most
scripts) fall back to their UTF-8 bytes; with some byte pieces taken out,
or byte fallback off, runs of them reach `fuse_unk`. Ids and masks are
held against `AutoTokenizer` text by text, on every code point, and as
padded batches, with each class's padding side, specials and
`update_post_processor` template under `add_bos_token`/`add_eos_token` on
and off. Tiny Llama and Mistral decoders are saved as pytorch_model.bin
only (the JAX package's Flax Llama and Mistral raise on a
model.safetensors, fault 3.17), and held within 1e-5 on normalized
vectors."""

import copy
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import bpe, checkpoint, fixtures, hf_encoder  # noqa: E402

ATOL = 1e-5  # max abs error of normalized vectors
VOCAB = 1500
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "über", "it's", "we'll", "HELLO", "2024",
         "3.14", "tab\there", "new\nline"]
ODD = ["", " ", "  ", "   lead", "trail   ", "\t", "\n\n", "é", "é", "ü", "中文", "検索", "😀",
       "👍🏽", "🚀🚀🚀", "Ǆ", "ǅ", "\U00010781", "\x00", "▁", "▁▁x", "<0x41>", "<0xZZ>",
       "<s>", "</s>", "<unk>", "<pad>", "<bos>", "<eos>", "<mask>", "<start_of_turn>",
       "<end_of_turn>", "x<table>y", " <h1> ", "a<s>b", "<bos>x<eos>"]
LAYOUTS = ("llama-legacy", "llama-metaspace", "gemma")
# (add_bos_token, add_eos_token, padding_side) of each tokenizer_config.json
FLAGS = {"default": (True, False, None), "eos": (False, True, "right"),
         "both": (True, True, None), "none": (False, False, "left")}


def _fuzz(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    pool = WORDS + ODD
    out = []
    for k in rng.integers(0, 20, n):
        picks = [pool[i] for i in rng.integers(0, len(pool), int(k))]
        out.append(("" if rng.random() < 0.3 else " ").join(picks))
    return out + ODD


CORPUS = [" ".join(np.random.default_rng(i).choice(WORDS, size=1 + i % 11)) for i in range(300)]
TEXTS = _fuzz(150, seed=31)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(layout: str) -> dict:
    if layout == "gemma":
        return fixtures.gemma_tokenizer_json(CORPUS, VOCAB, seed=41)
    return fixtures.llama_tokenizer_json(CORPUS, VOCAB, seed=42,
                                         legacy=layout == "llama-legacy")


def _config(layout: str, spec: dict, flags: str = "default") -> dict:
    bos, eos, side = FLAGS[flags]
    if layout == "gemma":
        return fixtures.gemma_tokenizer_config(spec, bos, eos, side)
    return fixtures.llama_tokenizer_config(spec, add_bos_token=bos, add_eos_token=eos,
                                           padding_side=side)


def _model_type(layout: str) -> str:
    return "gemma3_text" if layout == "gemma" else "llama"


def _write(path, spec: dict, config: dict, model_type: str) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": model_type}, f)
    return str(path)


@pytest.fixture(scope="module")
def specs():
    return {layout: _spec(layout) for layout in LAYOUTS}


@pytest.fixture(scope="module")
def dirs(specs, tmp_path_factory):
    """(layout, flags) -> a tokenizer directory."""
    root = tmp_path_factory.mktemp("byte_fallback")
    return {(layout, flags): _write(root / f"{layout}-{flags}", specs[layout],
                                    _config(layout, specs[layout], flags), _model_type(layout))
            for layout in LAYOUTS for flags in FLAGS}


def _port(path: str) -> bpe.BPE:
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(path, "tokenizer_config.json")) as f:
        config = json.load(f)
    with open(os.path.join(path, "config.json")) as f:
        model_type = json.load(f)["model_type"]
    return bpe.BPE(spec, config, model_type)


def _ref(path: str):
    return transformers.AutoTokenizer.from_pretrained(path)


def _agrees(port, ref, texts, max_len) -> bool:
    want = ref(texts, padding=True, truncation=True, max_length=max_len)
    ids, mask = port(texts, max_len)
    return ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]


def _first_difference(port, ref, texts):
    for text in texts:
        got, want = port.ids(text), ref(text, add_special_tokens=False)["input_ids"]
        if got != want:
            return text, ref.convert_ids_to_tokens(got), ref.convert_ids_to_tokens(want)
    return None


# -- the tokenizer against AutoTokenizer ------------------------------------------


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_byte_fallback_files_match_autotokenizer(dirs, layout, flags):
    """Ids, masks, padding side and template, text by text and as padded
    batches cut at 512 and at 9 tokens."""
    path = dirs[layout, flags]
    ref, port = _ref(path), _port(path)
    want_class = "GemmaTokenizerFast" if layout == "gemma" else "LlamaTokenizerFast"
    assert type(ref).__name__ == want_class
    assert port.padding_side == ref.padding_side == (FLAGS[flags][2] or "left")
    assert not port.byte_level and port.byte_fallback and port.fuse_unk
    assert _first_difference(port, ref, TEXTS) is None
    for max_len in (512, 9):
        assert _agrees(port, ref, TEXTS, max_len), max_len
    bos, eos, _side = FLAGS[flags]
    assert port.before == ([ref.bos_token_id] if bos else [])
    assert port.after == ([ref.eos_token_id] if eos else [])


def test_the_fixtures_merge_and_fall_back(dirs):
    """The seeded vocabularies merge known words into longer pieces and
    send unknown characters to their byte pieces."""
    for layout in LAYOUTS:
        port = _port(dirs[layout, "default"])
        ids = port.ids("hello world 😀 中")
        pieces = {v: k for k, v in port.vocab.items()}
        got = [pieces[i] for i in ids]
        assert any(len(p) > 2 and not p.startswith("<0x") for p in got), (layout, got)
        assert "<0xF0>" in got and "<0xE4>" in got, (layout, got)


CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CHUNK = 512


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_code_point_matches_autotokenizer(dirs, layout):
    """Every code point, in chunks joined by spaces, gives AutoTokenizer's
    ids (byte pieces for the characters the vocabulary lacks)."""
    path = dirs[layout, "default"]
    ref, port = _ref(path), _port(path)
    texts = [" ".join(chr(c) for c in CODE_POINTS[i:i + CHUNK])
             for i in range(0, len(CODE_POINTS), CHUNK)]
    want = ref(texts, add_special_tokens=False)["input_ids"]
    for text, ids in zip(texts, want):
        got = port.ids(text)
        if got != ids:
            i = next((i for i, (g, w) in enumerate(zip(got, ids)) if g != w), min(len(got), len(ids)))
            raise AssertionError(f"at {i}: port {ref.convert_ids_to_tokens(got[i:i + 4])},"
                                 f" tokenizers {ref.convert_ids_to_tokens(ids[i:i + 4])}")


UNKNOWN = ["😀", "😀😀", "a😀😀b", "ñ😀😀ña", "😀ñ😀a", "a😀ñ", "中文😀", "x🚀é🚀y", "👍🏽 ok"]


def _mutated(spec, change):
    spec = copy.deepcopy(spec)
    change(spec["model"])
    return spec


MUTATIONS = {
    # no byte fallback: unknown characters become <unk>, a run of them one
    "no_fallback": lambda m: m.update(byte_fallback=False),
    # a lead byte missing: emoji cannot fall back, and byte pieces met
    # while their <unk> run is open go before it
    "no_F0": lambda m: m["vocab"].pop("<0xF0>"),
    "no_F0_no_fuse": lambda m: (m["vocab"].pop("<0xF0>"), m.update(fuse_unk=False)),
    # no unk_token: what cannot fall back is dropped
    "no_unk": lambda m: (m.update(byte_fallback=False), m.update(unk_token=None)),
}


@pytest.mark.parametrize("mutation", MUTATIONS)
@pytest.mark.parametrize("layout", ["llama-legacy", "gemma"])
def test_fuse_unk_and_byte_fallback_edges_match_tokenizers(specs, tmp_path, layout, mutation):
    spec = _mutated(specs[layout], MUTATIONS[mutation])
    path = _write(tmp_path / mutation, spec, _config(layout, spec), _model_type(layout))
    ref, port = _ref(path), _port(path)
    assert _first_difference(port, ref, UNKNOWN + TEXTS) is None
    assert _agrees(port, ref, UNKNOWN + TEXTS, 512)
    unk = port.vocab["<unk>"]
    ids = port.ids("a😀😀b")
    if mutation in ("no_fallback", "no_F0"):
        assert ids.count(unk) == 1  # one fused <unk> for the run
    if mutation == "no_F0":
        tokens = ref.convert_ids_to_tokens(port.ids("😀ñ😀a"))
        assert tokens.index("<unk>") > tokens.index("<0xC3>")  # the byte pieces go first
    if mutation == "no_unk":
        assert unk not in ids


def test_merges_follow_rank_on_adversarial_words():
    """The heap of candidate pairs against `tokenizers`' own BPE on words of
    a three-letter alphabet whose merges overlap (aaa, abab, ...) and
    reach the same piece by different pairs."""
    rng = np.random.default_rng(7)
    alphabet = ["a", "b", "c"]
    vocab = {"<unk>": 0, **{ch: i + 1 for i, ch in enumerate(alphabet)}}
    merges = []
    pieces = list(alphabet)
    while len(merges) < 60:
        a, b = pieces[rng.integers(len(pieces))], pieces[rng.integers(len(pieces))]
        if len(a + b) <= 6 and (a, b) not in merges:
            merges.append((a, b))
            if a + b not in vocab:
                vocab[a + b] = len(vocab)
                pieces.append(a + b)
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": [list(m) for m in merges],
                      "unk_token": "<unk>", "fuse_unk": True, "byte_fallback": True},
            "normalizer": None, "pre_tokenizer": None, "added_tokens": [],
            "post_processor": None}
    ref = tokenizers.Tokenizer(tokenizers.models.BPE(vocab, merges, unk_token="<unk>",
                                                     fuse_unk=True, byte_fallback=True))
    port = bpe.BPE(spec, {"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<unk>",
                          "eos_token": "<unk>", "pad_token": "<unk>"})
    words = ["".join(rng.choice(alphabet, size=int(n))) for n in rng.integers(1, 40, 400)]
    words += ["a" * 17, "ab" * 9, "abc" * 7, "aabbcc" * 3]
    for word in words:
        assert port.ids(word) == ref.encode(word).ids, word


def test_the_class_template_replaces_the_files(specs, tmp_path):
    """update_post_processor: `<s> $A </s>` from the flags whatever the
    file's post-processor (here `$A </s>` only) says."""
    spec = copy.deepcopy(specs["llama-legacy"])
    spec["post_processor"] = fixtures._single_template(["$A", "</s>"], spec["model"]["vocab"])
    for flags in ("default", "both", "none"):
        path = _write(tmp_path / flags, spec, _config("llama-legacy", spec, flags), "llama")
        ref, port = _ref(path), _port(path)
        assert _agrees(port, ref, TEXTS, 512), flags


@pytest.mark.parametrize("layout", LAYOUTS)
def test_class_defaults_come_from_the_model_type(specs, tmp_path, layout):
    """No tokenizer_class and none of the class's specials in the config:
    `llama` gives LlamaTokenizerFast's (`<s>`, `</s>`, `<unk>`), and
    `gemma3_text` GemmaTokenizerFast's (`<bos>`, `<eos>`, `<unk>`,
    `<pad>`), padding on the left."""
    spec = specs[layout]
    config = _config(layout, spec)
    for key in ("tokenizer_class", "bos_token", "eos_token", "unk_token", "padding_side",
                "add_bos_token", "add_eos_token", "additional_special_tokens"):
        config.pop(key, None)
    if layout == "gemma":
        config.pop("pad_token")
    path = _write(tmp_path / layout, spec, config, _model_type(layout))
    ref, port = _ref(path), _port(path)
    assert type(ref).__name__ == ("GemmaTokenizerFast" if layout == "gemma"
                                  else "LlamaTokenizerFast")
    assert port.padding_side == ref.padding_side == "left"
    assert _agrees(port, ref, TEXTS, 512)


def test_llama3s_byte_level_file_under_the_llama_class(tmp_path):
    """`LlamaTokenizerFast` over Llama-3's byte-level file with the
    class's unk named: the class's left padding and its template
    (`<|begin_of_text|> $A`, and eos too when asked), as transformers
    gives them."""
    spec = fixtures.llama3_tokenizer_json(CORPUS, VOCAB, seed=43)
    for eos in (False, True):
        config = {**fixtures.llama3_tokenizer_config(spec), "tokenizer_class": "LlamaTokenizerFast",
                  "unk_token": "<|reserved_special_token_0|>", "add_eos_token": eos}
        path = _write(tmp_path / f"eos-{eos}", spec, config, "llama")
        ref, port = _ref(path), _port(path)
        assert port.byte_level and port.padding_side == ref.padding_side == "left"
        assert _agrees(port, ref, TEXTS, 512), eos


# -- refusals ------------------------------------------------------------------


def _refused(layout, spec_change=None, config_change=None):
    spec = copy.deepcopy(_spec(layout))
    if spec_change is not None:
        spec_change(spec)
    config = {**_config(layout, spec), **(config_change or {})}
    return spec, config


REFUSED = {
    "no_pad": ("llama-legacy", None, {"pad_token": None}, "pad token"),
    "add_prefix_space": ("llama-metaspace", None, {"add_prefix_space": True}, "add_prefix_space"),
    "bos_none": ("gemma", None, {"bos_token": None}, "add_bos_token"),
    "dropout": ("gemma", lambda s: s["model"].update(dropout=0.1), None, "dropout"),
    "metaspace_split": ("llama-metaspace", lambda s: s["pre_tokenizer"].update(split=True), None,
                        "Metaspace with split"),
    "split_pattern": ("gemma", lambda s: s["pre_tokenizer"].update(pattern={"String": "\n"}),
                      None, "Split on"),
    "split_behavior": ("gemma", lambda s: s["pre_tokenizer"].update(behavior="Isolated"), None,
                       "Split on"),
    "replace_regex": ("gemma", lambda s: s["normalizer"].update(pattern={"Regex": " +"}), None,
                      "Replace of a Regex"),
    "unk_missing": ("llama-legacy", lambda s: s["model"].update(unk_token="<nope>"), None,
                    "unk_token"),
    "whitespace": ("gemma", lambda s: s.update(pre_tokenizer={"type": "WhitespaceSplit"}), None,
                   "pre-tokenizer `WhitespaceSplit`"),
}


@pytest.mark.parametrize("case", REFUSED)
def test_unread_byte_fallback_files_are_refused_by_name(case):
    layout, spec_change, config_change, match = REFUSED[case]
    spec, config = _refused(layout, spec_change, config_change)
    with pytest.raises(ValueError, match=match):
        bpe.BPE(spec, config, _model_type(layout))


def test_no_pad_token_is_refused_as_transformers_refuses_it(dirs, tmp_path):
    """Llama-2 publishes no pad token: AutoTokenizer(padding=True) raises,
    and so does the port, when the tokenizer is built."""
    spec, config = _refused("llama-legacy", None, {"pad_token": None})
    path = _write(tmp_path / "nopad", spec, config, "llama")
    with pytest.raises(ValueError, match="pad"):
        _ref(path)(["a", "a b c"], padding=True)
    with pytest.raises(ValueError, match="pad token"):
        _port(path)


def test_a_unigram_with_byte_fallback_stays_refused():
    spec = fixtures.xlmr_tokenizer_json([("▁a", -1.0), ("b", -2.0)])
    spec["model"]["byte_fallback"] = True
    from meilisearch_tpu_torch.models.unigram import Unigram

    with pytest.raises(ValueError, match="byte_fallback"):
        Unigram(spec)


# -- llama and mistral from byte-fallback directories, against the JAX package ----


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            sd = 0.15 if ("q_proj" in name or "k_proj" in name) else 0.05
            draw = rng.normal(0.0, sd, tuple(p.shape))
            if "norm" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


@pytest.fixture(scope="module")
def decoders(specs, tmp_path_factory):
    """`llama` over the legacy layout and `mistral` over the Metaspace one,
    2 layers, hidden 64, 4 heads over 2 KV heads, saved by transformers
    as pytorch_model.bin beside their tokenizer files (left padding, the
    class default)."""
    root = tmp_path_factory.mktemp("byte_fallback_decoders")
    out = {}
    for i, (kind, layout) in enumerate((("llama", "llama-legacy"),
                                        ("mistral", "llama-metaspace"))):
        spec = specs[layout]
        common = dict(vocab_size=len(spec["model"]["vocab"]), hidden_size=64,
                      intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=2048)
        config = (transformers.LlamaConfig(rope_theta=1e4, **common) if kind == "llama"
                  else transformers.MistralConfig(sliding_window=4096, **common))
        model = transformers.AutoModel.from_config(config)
        _draw_weights(model, 60 + i)
        path = out[kind] = str(root / kind)
        model.save_pretrained(path, safe_serialization=False)
        _write(path, spec, _config(layout, spec), kind)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config.to_dict(), f)
    return out


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["llama", "mistral"])
def test_llama_and_mistral_from_byte_fallback_files_match_jax(decoders, kind, pooling):
    """The JAX package's torch branch (pytorch_model.bin only, fault 3.17)
    with LlamaTokenizerFast's left padding: under forceCls the short texts
    pool a pad query that sees no key, in both."""
    path = decoders[kind]
    texts = TEXTS[:30] + ["rust", " ".join(WORDS * 4), "😀 中文 café"]
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._tokenizer).__name__ == "LlamaTokenizerFast"
    assert jax_enc._tokenizer.padding_side == "left"
    enc = hf_encoder.TextEncoder(path, pooling, device=None)
    got = enc.encode(texts)
    assert isinstance(enc._tokenizer, bpe.BPE) and enc._tokenizer.byte_fallback
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL
