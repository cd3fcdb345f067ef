"""RoBERTa's byte-level BPE in the text encoder (K8): the port's tokenizer
(models/bpe.py), checkpoint reading and RoBERTa forward against
transformers' `AutoTokenizer` and the JAX package's `FlaxTextEncoder`.

Nothing is downloaded. The tokenizer files come three ways, each saved
as a RoBERTa tokenizer directory: a `tokenizer.json` that `tokenizers`
trains here (BpeTrainer over ByteLevel words), the port's own seeded
fixture (`fixtures.roberta_tokenizer_json`), and the older layout,
`vocab.json` and `merges.txt` with no tokenizer.json (transformers
converts it through `RobertaConverter`). Each is read with and without
`add_prefix_space` in tokenizer_config.json; ids and masks must equal
`AutoTokenizer`'s. A merge applied out of rank must break that equality.

A tiny RoBERTa (2 layers, width 32, 4 heads, pad id 1, `layer_norm_eps`
1e-5, one token type) with numpy-seeded weights is saved as
`pytorch_model.bin` alone, so the JAX package's encoder takes its torch
branch (its Flax branch misplaces RoBERTa's positions, fault 3.9); the
port is held against it within 1e-5, both poolings, and through HTTP."""

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
from meilisearch_tpu_torch.models import bpe, checkpoint, hf_encoder  # noqa: E402
from meilisearch_tpu_torch.models.fixtures import roberta_tokenizer_json  # noqa: E402

ATOL = 1e-5
WORDS = [
    "hello", "world", "search", "engine", "rust", "python", "database", "cloud",
    "machine", "learning", "café", "naïve", "привет", "мир", "中文", "検索", "über",
    "it's", "we'll", "don't", "I'm", "they've", "you'd", "HELLO", "2024", "3.14",
]
ODD = ["  ", "   ", "\n", "\t", "\r\n", " \n ", "⹃", "Ᲊ", "㋿", "ǅ", "🚀", "👍🏽", "é", "é",
       "<mask>", "<s>", "</s>", "<pad>", "<unk>", "x<mask>", " <mask> ", "$", "—", "'s", "'"]


def _fuzz(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    pool = WORDS + ODD
    texts = []
    for k in rng.integers(0, 24, n):
        picks = [pool[i] for i in rng.integers(0, len(pool), int(k))]
        texts.append(("" if rng.random() < 0.25 else " ").join(picks))
    return texts + ["", " ", "<mask>", "hello <mask> world", "it's  we'll\n\n x",
                    "tab\there " * 3, " leading space", "trailing space ", "a⹃b ᲉᲉ ㋿"]


TEXTS = _fuzz(120, seed=11)
CORPUS = _fuzz(300, seed=12)


def _save_roberta_tokenizer(spec: dict, path: str, add_prefix_space: bool) -> None:
    """`spec` saved as transformers saves a RoBERTa tokenizer, with
    config.json naming the family."""
    tok = transformers.RobertaTokenizerFast(
        tokenizer_object=tokenizers.Tokenizer.from_str(json.dumps(spec)),
        add_prefix_space=add_prefix_space)
    tok.save_pretrained(path)
    os.remove(os.path.join(path, "vocab.json"))
    os.remove(os.path.join(path, "merges.txt"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "roberta"}, f)


def _trained_spec() -> dict:
    """A byte-level BPE trained by `tokenizers` over CORPUS, RoBERTa's
    specials first, `<s> $A </s>`."""
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=700, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(CORPUS, trainer)
    tok.post_processor = tokenizers.processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    return json.loads(tok.to_str())


def _write_legacy(spec: dict, path: str, add_prefix_space: bool) -> None:
    """vocab.json, merges.txt (with its version line) and
    tokenizer_config.json, no tokenizer.json."""
    os.makedirs(path, exist_ok=True)
    model = spec["model"]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(model["vocab"], f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in model["merges"]))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "RobertaTokenizer", "add_prefix_space": add_prefix_space}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "roberta"}, f)


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    """(kind, add_prefix_space) -> a tokenizer directory."""
    root = tmp_path_factory.mktemp("bpe")
    specs = {"trained": _trained_spec(),
             "fixture": roberta_tokenizer_json(CORPUS, vocab_size=2000, seed=5)}
    out = {}
    for aps in (False, True):
        for kind, spec in specs.items():
            out[kind, aps] = str(root / f"{kind}-{aps}")
            _save_roberta_tokenizer(spec, out[kind, aps], aps)
        out["legacy", aps] = str(root / f"legacy-{aps}")
        _write_legacy(specs["fixture"], out["legacy", aps], aps)
    return out


def _port(path: str) -> bpe.BPE:
    """The port's tokenizer for a directory, read as load_checkpoint reads it."""
    with open(os.path.join(path, "tokenizer_config.json")) as f:
        config = json.load(f)
    json_path = os.path.join(path, "tokenizer.json")
    if os.path.exists(json_path):
        with open(json_path, encoding="utf-8") as f:
            return bpe.BPE(json.load(f), config)
    return bpe.BPE(bpe.legacy_spec(path, config), config)


def _agrees(port, ref, texts, max_len) -> bool:
    want = ref(texts, padding=True, truncation=True, max_length=max_len)
    ids, mask = port(texts, max_len)
    return ids.tolist() == want["input_ids"] and mask.tolist() == want["attention_mask"]


# -- the tokenizer ---------------------------------------------------------------


@pytest.mark.parametrize("add_prefix_space", [False, True])
@pytest.mark.parametrize("kind", ["trained", "fixture", "legacy"])
def test_bpe_matches_autotokenizer(tok_dirs, kind, add_prefix_space):
    path = tok_dirs[kind, add_prefix_space]
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert isinstance(ref, transformers.RobertaTokenizerFast)
    port = _port(path)
    assert port.add_prefix_space == add_prefix_space
    for max_len in (512, 9):
        assert _agrees(port, ref, TEXTS, max_len), max_len


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_byte_level_without_the_regex_matches_tokenizers(add_prefix_space):
    """`use_regex: false`: each piece between added tokens is one word."""
    ref = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space,
                                              use_regex=False)
    for text in TEXTS:
        want = [w for w, _ in ref.pre_tokenize_str(text)]
        assert bpe.byte_level_words(text, add_prefix_space, use_regex=False) == want, text


def test_merges_out_of_rank_fail_the_parity(tok_dirs, monkeypatch):
    """Mutation guard: merging the leftmost mergeable pair, whatever its
    rank, must break the equality the parity test checks."""
    path = tok_dirs["trained", False]
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert _agrees(_port(path), ref, TEXTS, 512)

    def leftmost(self, word):
        symbols = list(word)
        while True:
            at = next((i for i in range(len(symbols) - 1)
                       if (symbols[i], symbols[i + 1]) in self.ranks), None)
            if at is None:
                return symbols
            symbols[at:at + 2] = [symbols[at] + symbols[at + 1]]

    monkeypatch.setattr(bpe.BPE, "_merge", leftmost)
    assert not _agrees(_port(path), ref, TEXTS, 512)


def test_byte_symbols_are_gpt2s():
    table = bpe.bytes_to_unicode()
    assert len(table) == 256 and len(set(table.values())) == 256
    assert table[ord(" ")] == "Ġ" and table[ord("\n")] == "Ċ" and table[ord("a")] == "a"
    want = tokenizers.pre_tokenizers.ByteLevel.alphabet()
    assert set(table.values()) == set(want)


@pytest.mark.parametrize("change, match", [
    ({"dropout": 0.1}, "dropout"),
    ({"continuing_subword_prefix": "##"}, "continuing_subword_prefix"),
    ({"end_of_word_suffix": "</w>"}, "end_of_word_suffix"),
    ({"fuse_unk": True}, "fuse_unk"),
    ({"vocab": {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}, "merges": []},
     "byte symbols"),
    ({"normalizer": {"type": "NFKC"}}, "normalizer `NFKC`"),
    ({"pre_tokenizer": {"type": "Whitespace"}}, "pre-tokenizer `Whitespace`"),
])
def test_unread_bpe_files_are_refused_by_name(change, match):
    spec = roberta_tokenizer_json(CORPUS[:20], vocab_size=400, seed=1)
    for key, value in change.items():
        (spec["model"] if key in spec["model"] else spec)[key] = value
    with pytest.raises(ValueError, match=match):
        bpe.BPE(spec)


# -- Qwen2's and Llama-3's Split pre-tokenizers, and their fixture files --------

SPLITS = {"qwen2": bpe.QWEN2_SPLIT, "llama3": bpe.LLAMA3_SPLIT}
CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CHUNK = 1 << 15


def _split_ref(name):
    return tokenizers.pre_tokenizers.Split(tokenizers.Regex(SPLITS[name]), behavior="isolated",
                                           invert=False)


def _code_point_texts():
    """Every code point alone (joined by newlines) and between two letters
    (the contexts of tests/test_torch_unicode_tables.py); every cased one
    (a superset of those that fold to the contractions' letters) after an
    apostrophe inside a word, where `(?i:'s|...)` decides."""
    for i in range(0, len(CODE_POINTS), CHUNK):
        chars = [chr(c) for c in CODE_POINTS[i:i + CHUNK]]
        yield "\n".join(chars)
        yield "".join(f"a{c}b" for c in chars)
    cased = [chr(c) for c in CODE_POINTS
             if chr(c).lower() != chr(c) or chr(c).upper() != chr(c)
             or chr(c).casefold() != chr(c)]
    yield "".join(f"x'{c}y " for c in cased)


@pytest.mark.parametrize("name", SPLITS)
def test_split_patterns_on_every_code_point(name):
    """The port's Python regex for the published pattern cuts every code
    point where `tokenizers`' Split (Oniguruma, its \\p{L}, \\p{N}, \\s and
    case folding) cuts it."""
    ref, port = _split_ref(name), bpe.split_pattern(SPLITS[name])
    for text in _code_point_texts():
        got, want = port.findall(text), [w for w, _ in ref.pre_tokenize_str(text)]
        if got != want:
            i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
            raise AssertionError(f"piece {i}: port {got[i:i + 3]!r}, tokenizers {want[i:i + 3]!r}")


PINS = [
    ("x'ſy x'Sy x'Ty x'RE x'vEz 'LL'D it's", None),
    ("a\r\n\r\n  b  \n c\r\r\n \n\n", None),
    ("1 12 123 1234 12345 123456 1234567 x1234567y ①②③ ٣٤٥٦", None),
    ("hello!!\n\n world... ?\r\n", None),
]


@pytest.mark.parametrize("name", SPLITS)
def test_split_pins(name):
    """`'ſ` and `'S` under `(?i:...)`, runs of \\r\\n, and digit runs of 1 to 7
    (Qwen2's one digit a piece, Llama-3's up to three)."""
    ref, port = _split_ref(name), bpe.split_pattern(SPLITS[name])
    for text, _ in PINS:
        assert port.findall(text) == [w for w, _ in ref.pre_tokenize_str(text)], text
    assert port.findall("x'ſy x'Sy") == ["x", "'ſ", "y", " x", "'S", "y"]
    assert port.findall("a\r\n\r\n  b") == ["a", "\r\n\r\n", " ", " b"]
    digits = port.findall("1234567")
    assert digits == (list("1234567") if name == "qwen2" else ["123", "456", "7"])


def _decoder_dir(path, spec, config):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return path


DECODER_TEXTS = TEXTS + [
    "x'ſy it'S we'LL", "a\r\n\r\n  b  \n c", "1 12 123 1234567 x1234567y",
    "<|endoftext|>x<|im_start|> <think>y</think>", "<|begin_of_text|> <|eot_id|>z",
    "café café", " ".join(WORDS * 30),
]


@pytest.fixture(scope="module")
def decoder_dirs(tmp_path_factory):
    """Qwen2's layout (right and left padding, and Qwen3-Embedding's
    `$A <|endoftext|>` with left padding and left truncation) and
    Llama-3's (right and left padding), as models/fixtures.py writes
    them."""
    from meilisearch_tpu_torch.models import fixtures

    root = tmp_path_factory.mktemp("decoder_tokenizers")
    qwen = fixtures.qwen2_tokenizer_json(CORPUS, 1500, seed=21)
    qwen_eos = fixtures.qwen2_tokenizer_json(CORPUS, 1500, seed=21, eos_template=True)
    llama = fixtures.llama3_tokenizer_json(CORPUS, 1500, seed=22)
    return {
        "qwen2-right": _decoder_dir(root / "q-r", qwen, fixtures.qwen2_tokenizer_config(qwen)),
        "qwen2-left": _decoder_dir(root / "q-l", qwen,
                                   fixtures.qwen2_tokenizer_config(qwen, "left")),
        "qwen3emb-left": _decoder_dir(root / "q3-l", qwen_eos, {
            **fixtures.qwen2_tokenizer_config(qwen_eos, "left"), "truncation_side": "left"}),
        "llama3-right": _decoder_dir(root / "l-r", llama, fixtures.llama3_tokenizer_config(llama)),
        "llama3-left": _decoder_dir(root / "l-l", llama,
                                    fixtures.llama3_tokenizer_config(llama, padding_side="left")),
    }


@pytest.mark.parametrize("layout", ["qwen2-right", "qwen2-left", "qwen3emb-left", "llama3-right",
                                    "llama3-left"])
def test_decoder_fixture_files_match_autotokenizer(decoder_dirs, layout):
    """Ids, masks and padding side, text by text and as padded batches cut
    at 512 and at 8 tokens."""
    path = decoder_dirs[layout]
    ref = transformers.AutoTokenizer.from_pretrained(path)
    assert type(ref).__name__ == ("PreTrainedTokenizerFast" if layout.startswith("llama3")
                                  else "Qwen2TokenizerFast")
    assert ref.padding_side == layout.rsplit("-", 1)[1]
    port = _port(path)
    assert port.padding_side == ref.padding_side and port.split is not None
    for text in DECODER_TEXTS[-12:]:
        assert port([text], 512)[0].tolist() == ref([text], truncation=True,
                                                    max_length=512)["input_ids"], text
    for max_len in (512, 8):
        assert _agrees(port, ref, DECODER_TEXTS, max_len), max_len


@pytest.mark.parametrize("ignore", [True, False])
def test_ignore_merges_takes_a_whole_word(decoder_dirs, tmp_path, ignore):
    """A word the vocabulary holds whole but no merge reaches: with
    `ignore_merges` (Llama-3's) its own id, without it the merged pieces;
    as `tokenizers` does either way."""
    with open(os.path.join(decoder_dirs["llama3-right"], "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(decoder_dirs["llama3-right"], "tokenizer_config.json")) as f:
        config = json.load(f)
    vocab = spec["model"]["vocab"]
    word = "Ġzqxj"  # " zqxj" in byte symbols
    assert word not in vocab
    vocab[word] = max(vocab.values()) + 1
    for tok in spec["added_tokens"]:  # the specials move up one
        tok["id"] += 1
        vocab[tok["content"]] = tok["id"]
    spec["post_processor"]["processors"][1]["special_tokens"]["<|begin_of_text|>"]["ids"] = [
        vocab["<|begin_of_text|>"]]
    config["added_tokens_decoder"] = {str(t["id"]): {k: t[k] for k in (
        "content", "lstrip", "normalized", "rstrip", "single_word", "special")}
        for t in spec["added_tokens"]}
    spec["model"]["ignore_merges"] = ignore
    path = _decoder_dir(tmp_path / "ignore", spec, config)
    ref = transformers.AutoTokenizer.from_pretrained(path)
    port = _port(path)
    ids = port.ids("a zqxj")
    assert ids == ref("a zqxj", add_special_tokens=False)["input_ids"]
    assert (vocab[word] in ids) == ignore
    assert _agrees(port, ref, DECODER_TEXTS, 512)


@pytest.mark.parametrize("layout, change, match", [
    ("llama3-right", {"tokenizer_class": "LlamaTokenizerFast"}, "LlamaTokenizerFast"),
    ("llama3-right", {"tokenizer_class": None}, "LlamaTokenizerFast"),
    ("qwen2-right", {"padding_side": "middle"}, "padding_side"),
    ("qwen2-right", {"pad_token": None}, "pad token"),
])
def test_unread_decoder_tokenizer_configs_are_refused(decoder_dirs, layout, change, match):
    """The Llama class (named, or the `llama` and `mistral` default) over
    Llama-3's byte-level file: LlamaTokenizerFast's default unk `<unk>` is
    not in its vocabulary (with the unk named, the class reads it:
    tests/test_torch_bpe_byte_fallback.py); another padding side; no pad
    token."""
    path = decoder_dirs[layout]
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    with open(os.path.join(path, "tokenizer_config.json")) as f:
        config = {**json.load(f), **change}
    config = {k: v for k, v in config.items() if not (k == "tokenizer_class" and v is None)}
    with pytest.raises(ValueError, match=match):
        bpe.BPE(spec, config, "llama" if layout.startswith("llama3") else "qwen2")


@pytest.mark.parametrize("change, match", [
    (lambda pre: pre["pretokenizers"][0]["pattern"].update(
        Regex=bpe.QWEN2_SPLIT.replace("\\p{N}", "\\p{N}+", 1)), "Split pattern"),
    (lambda pre: pre["pretokenizers"][0].update(behavior="Removed"), "Split behavior"),
    (lambda pre: pre["pretokenizers"][1].update(use_regex=True), "use_regex"),
    (lambda pre: pre["pretokenizers"].reverse(), "pre-tokenizer `Sequence`"),
], ids=["pattern", "behavior", "use_regex", "order"])
def test_unread_split_pre_tokenizers_are_refused(decoder_dirs, change, match):
    with open(os.path.join(decoder_dirs["qwen2-right"], "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    change(spec["pre_tokenizer"])
    with pytest.raises(ValueError, match=match):
        bpe.BPE(spec, {"tokenizer_class": "Qwen2Tokenizer"})


# -- the checkpoint and the encoder --------------------------------------------


def _draw_weights(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = rng.normal(0.0, 0.02, tuple(p.shape))
            if "LayerNorm.weight" in name:
                draw += 1.0
            p.copy_(torch.from_numpy(draw.astype(np.float32)))


@pytest.fixture(scope="module")
def ckpt(tok_dirs, tmp_path_factory):
    """`json`: pytorch_model.bin with the fixture's tokenizer.json;
    `legacy`: the same weights with vocab.json + merges.txt."""
    root = tmp_path_factory.mktemp("roberta")
    spec = roberta_tokenizer_json(CORPUS, vocab_size=2000, seed=5)
    config = transformers.RobertaConfig(
        vocab_size=len(spec["model"]["vocab"]), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=514,
        type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2)
    model = transformers.RobertaModel(config, add_pooling_layer=False)
    _draw_weights(model, seed=21)
    out = {}
    for kind in ("json", "legacy"):
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=False)
        src = tok_dirs["fixture" if kind == "json" else "legacy", False]
        for name in os.listdir(src):
            if name != "config.json":
                shutil.copy(os.path.join(src, name), out[kind])
    return out


@pytest.mark.parametrize("kind", ["json", "legacy"])
def test_the_checkpoint_reads_the_bpe_tokenizer(ckpt, kind):
    c = checkpoint.load_checkpoint(ckpt[kind])
    assert c.config["model_type"] == "roberta" and c.vocab == []
    tok = checkpoint.build_tokenizer(c)
    assert isinstance(tok, bpe.BPE)
    ref = transformers.AutoTokenizer.from_pretrained(ckpt[kind])
    assert _agrees(tok, ref, TEXTS, 512)


def test_roberta_forward_matches_transformers_torch(ckpt):
    ref = transformers.RobertaModel.from_pretrained(ckpt["json"], add_pooling_layer=False).eval()
    c = checkpoint.load_checkpoint(ckpt["json"])
    model = checkpoint.build_model(c)
    ids, mask = checkpoint.build_tokenizer(c)(TEXTS[:12], 512)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = model(ids, mask)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["json", "legacy"])
def test_encoder_matches_jax_torch_branch(ckpt, kind, pooling):
    texts = TEXTS[:40]
    jax_enc = FlaxTextEncoder(ckpt[kind], pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._torch is not None  # pytorch_model.bin only: the AutoModel branch
    enc = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None)
    got = enc.encode(texts)
    assert isinstance(enc._tokenizer, bpe.BPE)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ATOL


# -- through HTTP ----------------------------------------------------------------


def _docs():
    rng = np.random.default_rng(43)
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


def test_http_hybrid_with_a_roberta_embedder_matches_jax(ckpt):
    settings = {
        "filterableAttributes": ["points"],
        "embedders": {"default": {"source": "huggingFace", "model": ckpt["json"]}},
    }
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        before = hf_encoder.FORWARDS.value
        for c in clients:
            assert c.update_settings("rb", settings)["status"] == "succeeded"
            assert c.add_documents("rb", _docs())["status"] == "succeeded"
        assert hf_encoder.FORWARDS.value > before
        store, jstore = apps[1].scheduler.index("rb"), apps[0].scheduler.index("rb")
        for docid, rows in jstore.vectors["default"].items():
            np.testing.assert_allclose(store.vectors["default"][docid], rows, atol=ATOL)
        for q in ("it's a search engine", "café мир", "中文 検索 <mask>"):
            for ratio in (1.0, 0.5):
                for filt in (None, "points > 1000"):
                    body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                            "showRankingScore": True, "limit": 20}
                    if filt:
                        body["filter"] = filt
                    want, got = (c.post("/indexes/rb/search", body=dict(body)) for c in clients)
                    assert want.status == got.status == 200, (want.json, got.json)
                    assert got.json["hits"], body
                    assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount")
                    _same_within_ties(got.json["hits"], want.json["hits"])
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
