"""Tests that need the card (marked `cuda`; they skip without a GPU).

This file imports no jax and nothing of the JAX package, so it runs where
jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py tests/test_torch_device_osa.py -m cuda -q

(`--noconftest`: tests/conftest.py sets up jax for the JAX package's
tests.) K1, K4h and K6 (every mode of each, both of K6's paths) are held against their
plain torch versions bit for bit, a refused launch must raise, a one-rank
NCCL group's scatter-gather must equal the single-device scorer, the
port's search
path on the card, typo pass included, must answer exactly as its host
scorer, the vector legs on the card as its numpy host pass, and the text
encoder (K8), BERT, XLM-R, RoBERTa with its byte-level BPE,
DistilBERT, MPNet, ModernBERT, CamemBERT, ELECTRA, DeBERTa-v2, ERNIE,
BertGeneration, RemBERT, Megatron-BERT, RoFormer, ALBERT, BERT's relative
keys, the decoders (with scaled rotaries, sliding windows, MLP biases and
other activations too), Gemma 3 and Llama from byte-fallback
tokenizers, XLM and FlauBERT from their Moses tokenizers, Gemma 2,
Gemma and Phi-3, Longformer, data2vec-text, XLM-RoBERTa-XL and BigBird,
GPT-Neo, GPT-J and BLOOM from GPT-2's and BLOOM's byte-level BPEs,
GPT-NeoX from GPT-NeoX-20B's, and Mixtral, Qwen2-MoE and Qwen3-MoE from BF16 shards (under chip_smoke.py's
routing rule), on the card as the same checkpoint on the CPU."""

import sys

import numpy as np
import pytest
import torch

from meilisearch_tpu_torch._hooks import block_jax
from meilisearch_tpu_torch.ops import _build
from meilisearch_tpu_torch.ops import chain_keys as ck
from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs
from meilisearch_tpu_torch.search.device_batch import T_LADDER

pytestmark = pytest.mark.cuda
B = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if "jax" not in sys.modules:  # run alone: without jax, as the server runs
        block_jax()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("D", [1024, 1 << 14])
@pytest.mark.parametrize("T", T_LADDER)
def test_kernel_matches_plain(cuda_device, T, D):
    args = kernel_args(scorer_inputs(T, D, B, seed=300 + T), cuda_device)
    before = ck.LAUNCHES.value
    got = ck.chain_keys(*args, T=T)
    torch.cuda.synchronize()
    assert ck.LAUNCHES.value == before + 1
    want = ck.chain_keys_torch(*args, T=T)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_refused_launch_raises(cuda_device):
    args = kernel_args(scorer_inputs(1, 1024, B, seed=4), cuda_device)
    lib = _build.load_library()
    keys = torch.empty((B, 1024), dtype=torch.int32, device=cuda_device)
    candw = torch.empty((B, 32), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    rc = lib.mst_chain_keys(
        *[a.data_ptr() for a in args], keys.data_ptr(), candw.data_ptr(),
        counts.data_ptr(), B, 1, 32, 48, torch.cuda.current_stream().cuda_stream,
    )
    assert rc != 0  # a block of 48 threads does not divide the bitmap
    with pytest.raises(RuntimeError):
        ck.check_launch(rc)


def test_search_path_on_the_card_matches_host(cuda_device):
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.ops import device_osa
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.search.perform import perform_search, perform_search_many

    words = ["quick", "brown", "fox", "lazy", "dog", "rust", "search", "engine"]
    rng = np.random.default_rng(3)
    store = IndexStore("card", primary_key="id")
    # the typo pass on the card whatever the vocabulary size (K3)
    store.device, store.osa_strict = cuda_device, True
    store.settings.apply_json(
        {"filterableAttributes": ["points"], "sortableAttributes": ["points"]}
    )
    store.add_documents([
        {"id": i, "title": " ".join(rng.choice(words, size=5)),
         "points": int(rng.integers(0, 100))}
        for i in range(3000)
    ])
    queries = [
        {"q": "quick brown fox"}, {"q": "serch engne"},
        {"q": "rust", "filter": "points > 50", "sort": ["points:desc"]},
        {"q": "lazy dog", "facets": ["points"], "showRankingScore": True},
        {"q": '"brown fox" rust', "matchingStrategy": "all"},
    ]
    before, osa_before = ck.LAUNCHES.value, device_osa.LAUNCHES.value
    served = serving_stats()["device_served"]
    got = perform_search_many(
        store, [dict(q) for q in queries], device=cuda_device, strict=True
    )
    assert ck.LAUNCHES.value > before
    assert device_osa.LAUNCHES.value > osa_before
    assert serving_stats()["device_served"] - served == len(queries)
    # the host scorer with the host typo pass, from cold derivation caches
    store.device = None
    store._derivation_store_cache = store._derivation_merge_cache = None
    for q, g in zip(queries, got):
        w = perform_search(store, dict(q))
        assert [h["id"] for h in g["hits"]] == [h["id"] for h in w["hits"]], q
        assert [h.get("_rankingScore") for h in g["hits"]] == [
            h.get("_rankingScore") for h in w["hits"]
        ], q
        for key in ("estimatedTotalHits", "facetDistribution"):
            assert g.get(key) == w.get(key), (key, q)


def test_server_entry_serves_on_the_card(cuda_device, tmp_path):
    """`python -m meilisearch_tpu_torch.api.server`: boot, ingest, search
    over a real socket, then a clean SIGTERM."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import time
    import urllib.request
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    proc = subprocess.Popen(
        [sys.executable, "-m", "meilisearch_tpu_torch.api.server",
         "--port", str(port), "--db-path", str(tmp_path / "db")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )

    def req(method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json.loads(resp.read() or b"null")

    try:
        deadline = time.time() + 120
        while True:
            try:
                req("GET", "/health")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.5)
        words = ["quick", "brown", "fox", "lazy", "dog"]
        docs = [{"id": i, "title": " ".join(words[(i + j) % 5] for j in range(3))}
                for i in range(500)]
        uid = req("POST", "/indexes/hn/documents", docs)["taskUid"]
        while req("GET", f"/tasks/{uid}")["status"] not in ("succeeded", "failed"):
            time.sleep(0.2)
        assert req("GET", f"/tasks/{uid}")["status"] == "succeeded"
        res = req("POST", "/indexes/hn/search", {"q": "quick brwn", "limit": 5})
        assert len(res["hits"]) == 5 and res["estimatedTotalHits"] > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


HAM_WIDTHS = [1, 3, 4, 12, 24, 48]  # 32, 96, 100, 384, 768 and 1536 dimensions
HAM_ROWS = [1, 4099, 1 << 18, (1 << 18) + 3]  # rows not a multiple of a tile too


def _sign_words(n, W, device):
    """A flat (n * W + 1,) int32 tensor of seeded words (bit 31 set on
    about half) on the card: `flat[:n * W]` is a 16-byte-aligned (n, W)
    matrix, `flat[1:]` the same shape one word in."""
    gen = torch.Generator().manual_seed(n * 64 + W)
    words = torch.randint(-(1 << 31), 1 << 31, (n * W + 1,), generator=gen, dtype=torch.int64)
    return words.to(torch.int32).to(device)


@pytest.mark.parametrize("W", HAM_WIDTHS)
@pytest.mark.parametrize("n", HAM_ROWS)
def test_hamming_kernel_matches_plain(cuda_device, n, W):
    """K4h's ham mode against hamming_rows_torch: rows not a multiple of
    the tile, words with bit 31 set, the compile-time widths (W = 4, 12,
    24, 48), the word-by-word widths and the rows left past the last
    16-byte copy (W = 1, 3); and an unaligned matrix, which takes the
    plain path."""
    from meilisearch_tpu_torch.ops import hamming

    flat = _sign_words(n, W, cuda_device)
    q = flat[:W].clone()
    for mat in (flat[: n * W].view(n, W), flat[1:].view(n, W)):  # aligned, unaligned
        before = hamming.LAUNCHES.value
        got = hamming.hamming_rows(mat, q)
        torch.cuda.synchronize()
        assert hamming.LAUNCHES.value == before + 1
        assert torch.equal(got, hamming.hamming_rows_torch(mat, q))


@pytest.mark.parametrize("W", HAM_WIDTHS)
@pytest.mark.parametrize("n", HAM_ROWS)
def test_hamming_keyed_kernel_matches_plain(cuda_device, n, W):
    """K4h's keyed mode against hamming_keyed_torch, cos and key bit for
    bit, for n_live 1, n - 5 and n, aligned and one word in."""
    from meilisearch_tpu_torch.ops import hamming

    flat = _sign_words(n, W, cuda_device)
    q = flat[-W:].clone()
    for mat in (flat[: n * W].view(n, W), flat[1:].view(n, W)):
        for n_live in sorted({1, max(n - 5, 0), n}):
            before = hamming.LAUNCHES.value
            cos, key = hamming.hamming_keyed(mat, q, 32 * W, n_live)
            torch.cuda.synchronize()
            assert hamming.LAUNCHES.value == before + 1
            want_cos, want_key = hamming.hamming_keyed_torch(mat, q, 32 * W, n_live)
            assert torch.equal(cos.view(torch.int32), want_cos.view(torch.int32))
            assert torch.equal(key, want_key)


def test_hamming_refused_launch_raises(cuda_device):
    from meilisearch_tpu_torch.ops import hamming

    lib = _build.load_library()
    w = hamming.MAX_WORDS + 1
    mat = torch.zeros((4, w), dtype=torch.int32, device=cuda_device)
    out = torch.empty(4, dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.mst_hamming(mat.data_ptr(), mat.data_ptr(), 4, w, hamming.MODE_HAM, 0, 4,
                         out.data_ptr(), None, None, stream)
    assert rc != 0  # q would not fit the kernel's shared memory
    with pytest.raises(RuntimeError):
        hamming.check_launch(rc)
    rc = lib.mst_hamming(mat.data_ptr(), mat.data_ptr(), 4, 4, hamming.MODE_KEYED, 128, 5,
                         None, out.data_ptr(), out.data_ptr(), stream)
    assert rc != 0  # n_live above n
    with pytest.raises(RuntimeError):
        hamming.check_launch(rc)


@pytest.mark.parametrize("quantized", [False, True])
def test_vector_legs_on_the_card_match_host(cuda_device, quantized):
    """The vector legs on the card against the numpy host pass of the same
    store: top-k (unfiltered) and the full column (filtered). Binary
    results exact; float docids in order and scores within 1e-5 (cuBLAS
    sums in another order than numpy)."""
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.ops import hamming
    from meilisearch_tpu_torch.vector.store import VectorSearcher

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(8)
    conf = {"source": "userProvided", "dimensions": 768}
    if quantized:
        conf["binaryQuantized"] = True
    store = IndexStore("vec", primary_key="id")
    store.settings.apply_json({"embedders": {"e": conf}})
    store.add_documents([
        {"id": i, "_vectors": {"e": rng.standard_normal((2 if i % 7 == 0 else 1, 768)).tolist()}}
        for i in range(5000)
    ])
    universe = {int(d) for d in rng.choice(5000, 700, replace=False)}
    # two random queries and two near stored vectors (high similarities)
    queries = [rng.standard_normal(768).astype(np.float32) for _ in range(2)]
    queries += [(store.vectors["e"][d][0] + 0.05 * rng.standard_normal(768)).astype(np.float32)
                for d in (3, 4000)]
    store.device = cuda_device
    before = hamming.LAUNCHES.value
    got = [VectorSearcher(store, "e").search(q, k, u)
           for q in queries for k in (1, 20) for u in (None, universe)]
    assert (hamming.LAUNCHES.value - before) == (len(got) if quantized else 0)
    store.device = None
    want = [VectorSearcher(store, "e").search(q, k, u)
            for q in queries for k in (1, 20) for u in (None, universe)]
    for g, w in zip(got, want):
        assert [d for d, _ in g] == [d for d, _ in w]
        if quantized:
            assert [s for _, s in g] == [s for _, s in w]
        else:
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-5)


@pytest.mark.parametrize("dim", [32, 100, 768, 1536])
def test_hamming_cosine_on_the_card_rounds_as_the_host(cuda_device, dim):
    """Every cosine a hamming distance can give, bit for bit as the host
    divides: `ham_cos` on the card, and K4h's keyed mode on rows whose
    distance to a zero query is 0..dim."""
    from meilisearch_tpu_torch.ops import hamming

    ham = np.arange(dim + 1, dtype=np.int32)
    want = (dim - 2.0 * ham.astype(np.float32)) / dim
    got = hamming.ham_cos(torch.from_numpy(ham).to(cuda_device), dim).cpu().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    W = (dim + 31) // 32
    bits = np.arange(W * 32)[None, :] < ham[:, None]  # row h: its first h bits set
    mat = np.packbits(bits, axis=1, bitorder="little").view(np.int32).reshape(dim + 1, W)
    cos, _key = hamming.hamming_keyed(torch.from_numpy(mat).to(cuda_device),
                                      torch.zeros(W, dtype=torch.int32, device=cuda_device),
                                      dim, dim + 1)
    assert np.array_equal(cos.cpu().numpy().view(np.int32), want.view(np.int32))


ENC_WORDS = ["rust", "search", "engine", "cloud", "database", "machine", "learning", "gpu"]


def _tiny_checkpoint(path, seed=0):
    """A 2-layer, width-32 BERT checkpoint written by the port itself (no
    transformers where the card is): seeded torch weights, a small vocab."""
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *ENC_WORDS, *letters,
             *("##" + c for c in letters), *".,:/-!?"]
    config = {"vocab_size": len(vocab), "hidden_size": 32, "num_hidden_layers": 2,
              "num_attention_heads": 4, "intermediate_size": 64,
              "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, BertModel(config).state_dict(), vocab)
    return str(path)


def _enc_texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(ENC_WORDS, size=int(k))) + f" #{i}!"
            for i, k in enumerate(rng.integers(0, 40, n))]


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_encoder_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling):
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _tiny_checkpoint(tmp_path, seed=1)
    texts = _enc_texts(20, seed=2)
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= 1e-5


def _xlmr_checkpoint(path, seed=0):
    """An XLM-R checkpoint at xlm-roberta-base's width (hidden 768, 12
    heads, intermediate 3,072, 514 positions, pad id 1) cut to 2 layers,
    with a seeded Unigram tokenizer.json, written by the port itself."""
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import build_charsmap, xlmr_tokenizer_json

    rng = np.random.default_rng(seed)
    chars = "abcdefghijklmnopqrstuvwxyz0123456789.,:/-!?éüпривет中文検索مرحبا"
    pieces = ["▁", *chars, *("▁" + c for c in chars), *("▁" + w for w in ENC_WORDS)]
    vocab = [(p, float(-rng.uniform(1.0, 12.0))) for p in dict.fromkeys(pieces)]
    spec = xlmr_tokenizer_json(vocab, build_charsmap({"é": "é", "Ａ": "A"}))
    config = {"model_type": "xlm-roberta", "vocab_size": len(spec["model"]["vocab"]),
              "hidden_size": 768, "num_hidden_layers": 2, "num_attention_heads": 12,
              "intermediate_size": 3072, "max_position_embeddings": 514, "type_vocab_size": 1,
              "layer_norm_eps": 1e-5, "pad_token_id": 1}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, BertModel(config).state_dict(), tokenizer_json=spec)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_xlmr_encoder_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling):
    """XLM-R's positions and the Unigram tokenizer on the card: padded
    multilingual batches against the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _xlmr_checkpoint(tmp_path, seed=5)
    texts = _enc_texts(17, seed=6) + ["привет мир", "中文 検索 ✈", "مرحبا", "", "a  b   é"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.embeddings.padding_idx == 1
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= 1e-5


def _roberta_checkpoint(path, seed=0):
    """A RoBERTa checkpoint at all-distilroberta-v1's width (hidden 768, 12
    heads, intermediate 3,072, 514 positions, pad id 1) cut to 2 layers,
    with a seeded byte-level BPE tokenizer.json, written by the port."""
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import roberta_tokenizer_json

    spec = roberta_tokenizer_json(_enc_texts(200, seed), vocab_size=3000, seed=seed)
    config = {"model_type": "roberta", "vocab_size": 3000, "hidden_size": 768,
              "num_hidden_layers": 2, "num_attention_heads": 12, "intermediate_size": 3072,
              "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
              "pad_token_id": 1}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, BertModel(config).state_dict(), tokenizer_json=spec)
    return str(path)


def _distilbert_checkpoint(path, seed=0):
    """A DistilBERT checkpoint at multi-qa-distilbert-cos-v1's width (dim
    768, 12 heads, hidden_dim 3,072, 512 positions) cut to 2 layers, with
    a small WordPiece vocabulary, written by the port (DistilBERT's names)."""
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *ENC_WORDS, *letters,
             *("##" + c for c in letters), *".,:/-!?#"]
    config = {"model_type": "distilbert", "vocab_size": len(vocab), "dim": 768, "n_layers": 2,
              "n_heads": 12, "hidden_dim": 3072, "max_position_embeddings": 512,
              "activation": "gelu", "sinusoidal_pos_embds": False}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, BertModel(config).state_dict(), vocab)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("family", ["roberta", "distilbert"])
def test_bpe_and_distilbert_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, family,
                                                                pooling):
    """RoBERTa with its byte-level BPE tokenizer, and DistilBERT, on the
    card: padded batches (contractions, runs of spaces, <mask>, fault
    3.11's characters) against the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.models.bpe import BPE

    torch.backends.cuda.matmul.allow_tf32 = False
    make = _roberta_checkpoint if family == "roberta" else _distilbert_checkpoint
    path = make(tmp_path, seed=7)
    texts = _enc_texts(17, seed=8) + ["it's we'll", "a   b\n\nc", "x <mask> y", "a\u2e43b",
                                      "\u32ff \u1c89", ""]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert isinstance(card._tokenizer, BPE) == (family == "roberta")
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= 1e-5


def _mpnet_checkpoint(path, seed=0):
    """An MPNet checkpoint at all-mpnet-base-v2's width (hidden 768, 12
    heads, intermediate 3,072, 514 positions, 32 relative buckets) cut to
    2 layers, with MPNet's vocabulary layout around a small WordPiece one,
    written by the port (MPNet's names)."""
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import mpnet_vocab

    letters = "abcdefghijklmnopqrstuvwxyz0123456789"
    vocab = mpnet_vocab(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *ENC_WORDS, *letters,
                         *("##" + c for c in letters), *".,:/-!?#<>"])
    config = {"model_type": "mpnet", "vocab_size": len(vocab), "hidden_size": 768,
              "num_hidden_layers": 2, "num_attention_heads": 12, "intermediate_size": 3072,
              "max_position_embeddings": 514, "relative_attention_num_buckets": 32,
              "layer_norm_eps": 1e-5, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, BertModel(config).state_dict(), vocab)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
def test_mpnet_encoder_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling):
    """MPNet's relative position bias and positions on the card: padded
    batches reaching the exact and the logarithmic buckets (over 128
    tokens), <mask> and specials matched on the normalized text, against
    the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _mpnet_checkpoint(tmp_path, seed=9)
    texts = _enc_texts(17, seed=10) + [" ".join(ENC_WORDS * 25), "HELLO <MASK>world",
                                       "x </S> y", "a<s>b", ""]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.encoder.relative_attention_bias is not None
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= 1e-5


def _modernbert_checkpoint(path, seed=0):
    """A ModernBERT checkpoint at ModernBERT-base's width (hidden 768, 12
    heads, intermediate 1,152, window 128, rotary thetas 160,000 and
    10,000) cut to 4 layers (global, local, local, global), with a seeded
    byte-level BPE tokenizer.json in ModernBERT's layout, written by the
    port as model.safetensors."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import modernbert_tokenizer_json
    from meilisearch_tpu_torch.models.modernbert import ModernBertModel

    spec = modernbert_tokenizer_json(_enc_texts(200, seed), vocab_size=3000, seed=seed)
    vocab = spec["model"]["vocab"]
    config = {"model_type": "modernbert", "vocab_size": 3000, "hidden_size": 768,
              "intermediate_size": 1152, "num_hidden_layers": 4, "num_attention_heads": 12,
              "norm_eps": 1e-5, "global_attn_every_n_layers": 3, "local_attention": 128,
              "global_rope_theta": 160000.0, "local_rope_theta": 10000.0,
              "pad_token_id": vocab["[PAD]"], "cls_token_id": vocab["[CLS]"],
              "sep_token_id": vocab["[SEP]"], "hidden_activation": "gelu"}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, ModernBertModel(config).state_dict(),
                     tokenizer_json=spec)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceMean", "forceCls"])
def test_modernbert_encoder_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling):
    """ModernBERT's rotary positions, sliding window and GeGLU on the card:
    a padded batch mixing short texts with ones over 65 tokens (past the
    window's half) and one truncated at 512, [MASK], runs of spaces and
    text NFC composes, against the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.models.modernbert import ModernBertModel

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _modernbert_checkpoint(tmp_path, seed=11)
    texts = _enc_texts(17, seed=12) + [" ".join(ENC_WORDS * 12), " ".join(ENC_WORDS * 80),
                                       "x [MASK] y", "a   b    c", "cafe\u0301", ""]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert isinstance(card._model, ModernBertModel)
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 64
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


def test_modernbert_refuses_tf32(cuda_device, tmp_path):
    """With TF32 on, ModernBERT's forward on the card refuses to launch."""
    from meilisearch_tpu_torch.models import hf_encoder

    path = _modernbert_checkpoint(tmp_path, seed=13)
    card = hf_encoder.TextEncoder(path, "useModel", device=cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            card.encode(["rust search engine"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _spm_pieces(seed, words=ENC_WORDS):
    rng = np.random.default_rng(seed)
    chars = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,:/-!?#'()éü"
    pieces = ["▁", *chars, *("▁" + c for c in chars), *("▁" + w for w in words)]
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in dict.fromkeys(pieces)]


def _family_checkpoint(path, family, seed=0):
    """A checkpoint written by the port at the published width of its
    family, cut to 2 layers: CamemBERT (camembert-base: hidden 768, 12
    heads, 514 positions, pad id 1) with a seeded Unigram tokenizer.json in
    CamembertConverter's layout; ELECTRA (electra-small-discriminator:
    128-wide embeddings projected to 256, 4 heads) with a small WordPiece
    vocabulary; DeBERTa-v2 (deberta-v3-base: hidden 768, 12 heads, 256
    buckets over 512 positions, p2c|c2p, shared keys) with a seeded Unigram
    tokenizer.json in DebertaV2Converter's layout."""
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import (
        build_charsmap,
        camembert_tokenizer_json,
        deberta_v3_tokenizer_json,
    )

    charsmap = build_charsmap({"é": "é", "Ａ": "A"})
    spec, vocab = None, None
    if family == "camembert":
        spec = camembert_tokenizer_json(_spm_pieces(seed), charsmap)
        config = {"model_type": "camembert", "vocab_size": len(spec["model"]["vocab"]),
                  "hidden_size": 768, "num_hidden_layers": 2, "num_attention_heads": 12,
                  "intermediate_size": 3072, "max_position_embeddings": 514,
                  "type_vocab_size": 1, "layer_norm_eps": 1e-5, "pad_token_id": 1}
    elif family == "electra":
        letters = "abcdefghijklmnopqrstuvwxyz0123456789"
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *ENC_WORDS, *letters,
                 *("##" + c for c in letters), *".,:/-!?#"]
        config = {"model_type": "electra", "vocab_size": len(vocab), "embedding_size": 128,
                  "hidden_size": 256, "num_hidden_layers": 2, "num_attention_heads": 4,
                  "intermediate_size": 1024, "max_position_embeddings": 512,
                  "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0}
    else:
        spec = deberta_v3_tokenizer_json(_spm_pieces(seed), charsmap)
        config = {"model_type": "deberta-v2", "vocab_size": len(spec["model"]["vocab"]) + 100,
                  "hidden_size": 768, "num_hidden_layers": 2, "num_attention_heads": 12,
                  "intermediate_size": 3072, "max_position_embeddings": 512,
                  "relative_attention": True, "position_buckets": 256,
                  "max_relative_positions": -1, "pos_att_type": "p2c|c2p",
                  "norm_rel_ebd": "layer_norm", "share_att_key": True,
                  "position_biased_input": False, "type_vocab_size": 0, "layer_norm_eps": 1e-7}
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, new_model(config).state_dict(), vocab,
                     tokenizer_json=spec)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("family", ["camembert", "electra", "deberta-v2"])
def test_family_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, family, pooling):
    """CamemBERT's positions from the pad id, ELECTRA's embedding
    projection and DeBERTa-v2's disentangled attention on the card: a
    padded batch of short texts beside ones of 200 to 512 tokens (relative
    distances past 128 reach DeBERTa's log buckets), the specials, against
    the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _family_checkpoint(tmp_path, family, seed=14)
    specials = {"camembert": ["x <mask> y", "<s>NOTUSED a"], "electra": ["x [MASK] y"],
                "deberta-v2": ["x [MASK] y", "Hello, World!"]}[family]
    texts = _enc_texts(15, seed=15) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80),
                                       "", *specials]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.config["model_type"] == family
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


# each decoder family at a published checkpoint's widths, cut to 2 layers:
# Qwen3-Embedding-0.6B, gte-Qwen2-1.5B-instruct, Llama-3.2-1B and
# e5-mistral-7b-instruct
DECODER_WIDTHS = {
    "qwen3": {"hidden_size": 1024, "num_attention_heads": 16, "num_key_value_heads": 8,
              "head_dim": 128, "intermediate_size": 3072, "rope_theta": 1e6},
    "qwen2": {"hidden_size": 1536, "num_attention_heads": 12, "num_key_value_heads": 2,
              "intermediate_size": 8960, "rope_theta": 1e6},
    "llama": {"hidden_size": 2048, "num_attention_heads": 32, "num_key_value_heads": 8,
              "head_dim": 64, "intermediate_size": 8192, "rope_theta": 5e5},
    "mistral": {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "rope_theta": 1e4, "sliding_window": 4096},
}


def _decoder_checkpoint(path, kind, seed=0, extra=None):
    """A decoder checkpoint at DECODER_WIDTHS[kind] with 2 layers (and the
    config keys of `extra`), written by the port as model.safetensors with
    a seeded byte-level BPE in Qwen2's layout (qwen3, qwen2) or Llama-3's
    (llama, mistral) and tokenizer_config.json's padding_side `left`, as
    Qwen3-Embedding publishes; RMSNorm weights and the biases drawn off
    their defaults."""
    from meilisearch_tpu_torch.models import fixtures
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.decoder import DecoderModel

    texts = _enc_texts(200, seed)
    if kind.startswith("qwen"):
        spec = fixtures.qwen2_tokenizer_json(texts, 1500, seed=seed, eos_template=True)
        tok_config = fixtures.qwen2_tokenizer_config(spec, padding_side="left")
    else:
        spec = fixtures.llama3_tokenizer_json(texts, 1500, seed=seed)
        tok_config = fixtures.llama3_tokenizer_config(spec, padding_side="left")
    config = {"model_type": kind, "vocab_size": len(spec["model"]["vocab"]),
              "num_hidden_layers": 2, "rms_norm_eps": 1e-6, "hidden_act": "silu",
              **DECODER_WIDTHS[kind], **(extra or {})}
    torch.manual_seed(seed)
    model = DecoderModel(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(torch.randn(p.shape) * 0.1)
    write_checkpoint(str(path), config, model.state_dict(), tokenizer_json=spec,
                     tokenizer_config=tok_config)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["qwen3", "qwen2", "llama", "mistral"])
def test_decoder_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, kind, pooling):
    """The decoders' causal GQA, rotary positions and gated MLP on the
    card: a left-padded batch of short texts beside ones of 200 to 512
    tokens (under forceCls the short ones pool a pad query that sees no
    key), against the CPU within ENC_TOL (1e-4)."""
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.models.decoder import DecoderModel

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _decoder_checkpoint(tmp_path, kind, seed=16)
    texts = _enc_texts(15, seed=17) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "x'Sy it's 1234567 a\r\n\r\n b"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert isinstance(card._model, DecoderModel) and card._model.config["model_type"] == kind
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    assert int(mask[:, 0].min()) == 0 and int(mask[:, -1].min()) == 1  # left padding
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


def _byte_fallback_checkpoint(path, kind, layout, seed=0, extra=None):
    """A 2-layer decoder at DECODER_WIDTHS[kind] (llama, mistral) or at
    google/embeddinggemma-300m's widths (gemma3_text: bidirectional, or
    causal with `layout` "causal", a 16-token sliding window so the long
    texts reach past it), written by the port as model.safetensors beside
    a seeded sentencepiece BPE with byte fallback: Llama's legacy or
    Metaspace layout (`layout` "legacy"/"metaspace") or Gemma's, each
    with its class's tokenizer_config.json (left padding by default)."""
    from meilisearch_tpu_torch.models import fixtures
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    texts = _enc_texts(200, seed)
    if kind == "gemma3_text":
        spec = fixtures.gemma_tokenizer_json(texts, 1500, seed=seed)
        tok_config = fixtures.gemma_tokenizer_config(spec, add_eos_token=True)
        widths = {"hidden_size": 768, "intermediate_size": 1152, "num_attention_heads": 3,
                  "num_key_value_heads": 1, "head_dim": 256, "query_pre_attn_scalar": 256,
                  "sliding_window": 16, "use_bidirectional_attention": layout != "causal",
                  "layer_types": ["sliding_attention", "full_attention"]}
    else:
        spec = fixtures.llama_tokenizer_json(texts, 1500, seed=seed, legacy=layout == "legacy")
        tok_config = fixtures.llama_tokenizer_config(spec)
        widths = {"hidden_act": "silu", **DECODER_WIDTHS[kind]}
    config = {"model_type": kind, "vocab_size": len(spec["model"]["vocab"]),
              "num_hidden_layers": 2, "rms_norm_eps": 1e-6, **widths, **(extra or {})}
    torch.manual_seed(seed)
    model = new_model(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    write_checkpoint(str(path), config, model.state_dict(), tokenizer_json=spec,
                     tokenizer_config=tok_config)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind, layout", [("gemma3_text", "bidirectional"),
                                          ("gemma3_text", "causal"), ("llama", "legacy"),
                                          ("mistral", "metaspace")])
def test_byte_fallback_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, kind, layout,
                                                          pooling):
    """Gemma 3's text stack (bidirectional, EmbeddingGemma's, and causal;
    its sliding layers' window bites on the long texts) and Llama and
    Mistral from byte-fallback tokenizer files on the card: a left-padded
    batch with byte pieces (emoji, CJK) beside texts of 200 to 512 tokens,
    against the CPU within ENC_TOL (1e-4)."""
    from meilisearch_tpu_torch.models import bpe, hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _byte_fallback_checkpoint(tmp_path, kind, layout, seed=18)
    texts = _enc_texts(15, seed=19) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "emoji \U0001F680 中文 café \U0001F44D\U0001F3FD"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.config["model_type"] == kind
    assert isinstance(card._tokenizer, bpe.BPE) and card._tokenizer.byte_fallback
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    assert int(mask[:, 0].min()) == 0 and int(mask[:, -1].min()) == 1  # left padding
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


# the decoder configurations past the published defaults, 2 layers at
# DECODER_WIDTHS or EmbeddingGemma's widths: (kind, config keys, what the
# module must read from them)
DECODER_VARIANTS = {
    "llama-llama3-mlp-bias": ("llama", {
        "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
        "mlp_bias": True, "hidden_act": "gelu_new"}, ("llama3", None)),
    "qwen3-yarn-window": ("qwen3", {
        "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                         "original_max_position_embeddings": 32_768},
        "max_position_embeddings": 131_072, "use_sliding_window": True, "sliding_window": 16,
        "max_window_layers": 1, "hidden_act": "gelu"}, ("yarn", 16)),
    "mistral-window-linear": ("mistral", {
        "sliding_window": 16, "rope_scaling": {"rope_type": "linear", "factor": 2.0}},
        ("linear", 16)),
    "gemma3-causal-linear": ("gemma3_text", {
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "attn_logit_softcapping": 50.0, "hidden_activation": "gelu"}, ("linear", 16)),
}


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", DECODER_VARIANTS)
def test_decoder_variants_on_the_card_match_the_cpu(cuda_device, tmp_path, name, pooling):
    """A scaled rotary (llama3, yarn's attention factor, linear), sliding
    windows that bite (Qwen3's from layer 1, Mistral's in every layer,
    Gemma 3's causal one beside its unscaled local rotary), Llama's MLP
    biases and other activations on the card: a left-padded batch of
    short texts beside ones of 200 to 512 tokens, against the CPU within
    ENC_TOL (1e-4)."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, extra, (rope_kind, window) = DECODER_VARIANTS[name]
    if kind == "gemma3_text":
        path = _byte_fallback_checkpoint(tmp_path, kind, "causal", seed=20, extra=extra)
    else:
        path = _decoder_checkpoint(tmp_path, kind, seed=20, extra=extra)
    texts = _enc_texts(15, seed=21) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "x'Sy it's 1234567 a\r\n\r\n b"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.rope.kind == rope_kind and card._model.config["window"] == window
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask[:, 0].min()) == 0  # left padding
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


# the BERT-shaped families at a published checkpoint's widths, cut to 2
# layers (ALBERT: 2 passes, or 4 over 2 groups of 2): ernie-3.0-base-zh,
# bert_for_seq_generation_L-24_bbc_encoder, google/rembert,
# megatron-bert-cased-345m, roformer_chinese_base (with and without
# rotary_value), BERT at bge-base's width with each relative key, and
# paraphrase-albert-small-v2
BERT_SHAPED = {
    "ernie": {"model_type": "ernie", "hidden_size": 768, "num_attention_heads": 12,
              "intermediate_size": 3072, "max_position_embeddings": 2048,
              "type_vocab_size": 4, "use_task_id": True, "task_type_vocab_size": 3,
              "layer_norm_eps": 1e-5},
    "bert-generation": {"model_type": "bert-generation", "hidden_size": 1024,
                        "num_attention_heads": 16, "intermediate_size": 4096,
                        "max_position_embeddings": 512, "layer_norm_eps": 1e-12},
    "rembert": {"model_type": "rembert", "hidden_size": 1152, "num_attention_heads": 18,
                "intermediate_size": 4608, "input_embedding_size": 256,
                "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12},
    "megatron-bert": {"model_type": "megatron-bert", "hidden_size": 1024,
                      "num_attention_heads": 16, "intermediate_size": 4096,
                      "max_position_embeddings": 512, "type_vocab_size": 2,
                      "layer_norm_eps": 1e-12},
    "roformer": {"model_type": "roformer", "hidden_size": 768, "num_attention_heads": 12,
                 "intermediate_size": 3072, "max_position_embeddings": 1536,
                 "type_vocab_size": 2, "layer_norm_eps": 1e-12},
    "roformer-rotary-value": {"model_type": "roformer", "hidden_size": 768,
                              "num_attention_heads": 12, "intermediate_size": 3072,
                              "max_position_embeddings": 1536, "type_vocab_size": 2,
                              "layer_norm_eps": 1e-12, "rotary_value": True},
    "bert-relative-key": {"hidden_size": 768, "num_attention_heads": 12,
                          "intermediate_size": 3072, "max_position_embeddings": 512,
                          "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                          "position_embedding_type": "relative_key", "hidden_act": "gelu_new"},
    "bert-relative-key-query": {"hidden_size": 768, "num_attention_heads": 12,
                                "intermediate_size": 3072, "max_position_embeddings": 512,
                                "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                                "position_embedding_type": "relative_key_query"},
    "albert": {"model_type": "albert", "embedding_size": 128, "hidden_size": 768,
               "num_hidden_groups": 1, "inner_group_num": 1, "num_attention_heads": 12,
               "intermediate_size": 3072, "max_position_embeddings": 512,
               "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu_new"},
    "albert-groups": {"model_type": "albert", "embedding_size": 128, "hidden_size": 768,
                      "num_hidden_layers": 4, "num_hidden_groups": 2, "inner_group_num": 2,
                      "num_attention_heads": 12, "intermediate_size": 3072,
                      "max_position_embeddings": 512, "type_vocab_size": 2,
                      "layer_norm_eps": 1e-12, "hidden_act": "gelu_new"},
}


def _bert_shaped_checkpoint(path, name, seed=0):
    """A checkpoint written by the port at BERT_SHAPED[name]'s widths with
    seeded weights: ALBERT with a seeded Unigram tokenizer.json in
    AlbertConverter's layout, the others with a WordPiece vocabulary of
    CJK characters in ERNIE's layout."""
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import (
        albert_tokenizer_json,
        build_charsmap,
        ernie_vocab,
    )

    config = {"model_type": "bert", "num_hidden_layers": 2, **BERT_SHAPED[name], "pad_token_id": 0}
    spec, vocab = None, None
    if config["model_type"] == "albert":
        spec = albert_tokenizer_json(_spm_pieces(seed), build_charsmap({"Ａ": "A"}))
        config["vocab_size"] = len(spec["model"]["vocab"])
    else:
        vocab = ernie_vocab(ENC_WORDS, 8000)
        config["vocab_size"] = len(vocab)
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, new_model(config).state_dict(), vocab,
                     tokenizer_json=spec)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", BERT_SHAPED)
def test_bert_shaped_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, name, pooling):
    """ERNIE's task type, BertGeneration, RemBERT's and ALBERT's
    projections, Megatron-BERT's pre-norms, RoFormer's interleaved
    rotation, the relative keys and ALBERT's shared layers on the card: a
    padded batch of short texts beside ones of 200 to 512 tokens, CJK
    characters, against the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _bert_shaped_checkpoint(tmp_path, name, seed=16)
    texts = _enc_texts(15, seed=17) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80),
                                       "", "一丁七 万丈", "x [MASK] y"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.config["model_type"] == BERT_SHAPED[name].get("model_type", "bert")
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


# the other encoders the JAX package embeds, at a published checkpoint's widths cut to
# 2 layers: google/mobilebert-uncased, xlnet-base-cased (left padding, its
# token types passed), squeezebert-uncased, xlm-mlm-en-2048, deberta-v2-xlarge
# (the ConvLayer), DeBERTa-v2 without relative attention, and DistilBERT with
# sinusoidal positions and ReLU
MORE_FAMILIES = {
    "mobilebert": {"model_type": "mobilebert"},
    "xlnet": {"model_type": "xlnet", "d_model": 768, "n_head": 12, "d_inner": 3072,
              "n_layer": 2},
    "squeezebert": {"model_type": "squeezebert"},
    "xlm": {"model_type": "xlm", "emb_dim": 2048, "n_heads": 16, "n_layers": 2},
    "deberta-v2-conv": {"model_type": "deberta-v2", "hidden_size": 1536,
                        "num_attention_heads": 24, "intermediate_size": 6144,
                        "max_position_embeddings": 512, "relative_attention": True,
                        "position_buckets": 256, "pos_att_type": "p2c|c2p",
                        "norm_rel_ebd": "layer_norm", "share_att_key": True,
                        "position_biased_input": False, "conv_kernel_size": 3,
                        "conv_act": "gelu", "layer_norm_eps": 1e-7},
    "deberta-v2-norel": {"model_type": "deberta-v2", "hidden_size": 768,
                         "num_attention_heads": 12, "intermediate_size": 3072,
                         "max_position_embeddings": 512, "relative_attention": False,
                         "position_biased_input": False, "pos_att_type": "p2c|c2p"},
    "distilbert-sinusoidal": {"model_type": "distilbert", "dim": 768, "n_layers": 2,
                              "n_heads": 12, "hidden_dim": 3072, "activation": "relu",
                              "max_position_embeddings": 512, "sinusoidal_pos_embds": True},
}


def _more_families_checkpoint(path, name, seed=0):
    """A checkpoint written by the port at MORE_FAMILIES[name]'s widths with
    seeded weights: XLNet with a seeded Unigram tokenizer.json in
    XLNetConverter's layout, DeBERTa-v2 in DebertaV2Converter's, the others
    with a small WordPiece vocabulary."""
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import (
        build_charsmap,
        deberta_v3_tokenizer_json,
        xlnet_tokenizer_json,
    )

    config = {"num_hidden_layers": 2, **MORE_FAMILIES[name]}
    spec, vocab = None, None
    if name == "xlnet":
        spec = xlnet_tokenizer_json(_spm_pieces(seed), build_charsmap({"Ａ": "A"}))
    elif name.startswith("deberta"):
        spec = deberta_v3_tokenizer_json(_spm_pieces(seed), build_charsmap({"Ａ": "A"}))
    else:
        letters = "abcdefghijklmnopqrstuvwxyz0123456789"
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *ENC_WORDS, *letters,
                 *("##" + c for c in letters), *".,:/-!?#"]
    # DeBERTa's [MASK] is an added token past the model's pieces
    config["vocab_size"] = len(vocab) if spec is None else len(spec["model"]["vocab"]) + 100
    torch.manual_seed(seed)
    write_checkpoint(str(path), config, new_model(config).state_dict(), vocab,
                     tokenizer_json=spec)
    return str(path)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", MORE_FAMILIES)
def test_more_encoder_families_on_the_card_match_the_cpu(cuda_device, tmp_path, name, pooling):
    """MobileBERT's trigram and bottlenecks, XLNet's relative attention and
    segment term (left padding, `<cls>` type 2), SqueezeBERT's grouped
    convolutions, XLM's type rows, DeBERTa-v2's ConvLayer and DistilBERT's
    sinusoidal table on the card: a padded batch of short texts beside ones
    of 200 to 512 tokens, against the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _more_families_checkpoint(tmp_path, name, seed=18)
    texts = _enc_texts(15, seed=19) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80),
                                       "", "x [MASK] y", "<cls> <sep> x"]
    card = hf_encoder.TextEncoder(path, pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    _ids, mask, types = card.tokenize(texts)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    assert (types is not None) is (name in ("xlnet", "xlm"))
    want = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


# XLM's and FlauBERT's own tokenizers (Moses and a `</w>` BPE over
# vocab.json + merges.txt), 2 layers at published widths, and each class's
# casing flags
MOSES_FAMILIES = {
    "xlm-mlm-en-2048": ({"model_type": "xlm", "emb_dim": 2048, "n_heads": 16, "n_layers": 2},
                        {}),
    "xlm-mlm-100-1280": ({"model_type": "xlm", "emb_dim": 1280, "n_heads": 16, "n_layers": 2,
                          "n_langs": 100}, {"do_lowercase_and_remove_accent": False}),
    "flaubert-large-pre_norm": ({"model_type": "flaubert", "emb_dim": 1024, "n_heads": 16,
                                 "n_layers": 2, "pre_norm": True, "layerdrop": 0.2}, {}),
    "flaubert-base-uncased": ({"model_type": "flaubert", "emb_dim": 768, "n_heads": 12,
                               "n_layers": 2}, {"do_lowercase": True}),
}
MOSES_TEXT = ["Hello, World. Café", "l'homme aujourd'hui\nest là", "No. 5 costs 1,000.5 ...",
              "« bonjour » <special1> <S>", "ÉLÈVE déjà ΣΑΣ"]


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", MOSES_FAMILIES)
def test_moses_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, name, pooling):
    """XLM and FlauBERT (post- and pre-norm) from their own tokenizers on
    the card: a padded batch of short texts beside ones of 200 to 512
    tokens, against the CPU; the token types reach the model."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    config, flags = MOSES_FAMILIES[name]
    flaubert = config["model_type"] == "flaubert"
    lower = flags.get("do_lowercase", not flaubert and
                      flags.get("do_lowercase_and_remove_accent", True))
    vocab, merges = fixtures.moses_bpe_files(_enc_texts(60, seed=20) + MOSES_TEXT, 2000, 21,
                                             lang="fr" if flaubert else "en", lowercase=lower,
                                             n_trained=400)
    config = {**config, "vocab_size": len(vocab)}
    torch.manual_seed(22)
    tok_config = fixtures.moses_tokenizer_config(
        "FlaubertTokenizer" if flaubert else "XLMTokenizer", **flags)
    write_checkpoint(str(tmp_path), config, new_model(config).state_dict(),
                     tokenizer_config=tok_config, moses=(vocab, merges))
    texts = _enc_texts(15, seed=23) + MOSES_TEXT + [" ".join(ENC_WORDS * 30),
                                                     " ".join(ENC_WORDS * 80), ""]
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert type(card._tokenizer).__name__ == "MosesBPE"
    _ids, mask, types = card.tokenize(texts)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16 and types is not None
    want = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


# Gemma 2, Gemma and Phi-3, 2 layers each at published widths over a
# seeded sentencepiece BPE (Gemma's layout, or Llama-2's with Phi-3's chat
# tokens), left padding by class default: (kind, config, what the module
# must read: its rotary's type and width, the window)
P21_FAMILIES = {
    "gemma2-2b-window-softcap": ("gemma2", {
        "hidden_size": 2304, "intermediate_size": 9216, "num_attention_heads": 8,
        "num_key_value_heads": 4, "head_dim": 256, "query_pre_attn_scalar": 256,
        "sliding_window": 16, "attn_logit_softcapping": 0.5}, ("default", 256, 16)),
    "gemma-2b-gelu": ("gemma", {
        "hidden_size": 2048, "intermediate_size": 16_384, "num_attention_heads": 8,
        "num_key_value_heads": 1, "head_dim": 256, "hidden_act": "gelu",
        "hidden_activation": "gelu_pytorch_tanh"}, ("default", 256, None)),
    "phi3-mini-partial-longrope": ("phi3", {
        "hidden_size": 3072, "intermediate_size": 8192, "num_attention_heads": 32,
        "num_key_value_heads": 32, "sliding_window": 16, "partial_rotary_factor": 0.75,
        "max_position_embeddings": 256, "original_max_position_embeddings": 64,
        "rope_scaling": {"type": "longrope", "short_factor": [1.0 + i / 40 for i in range(36)],
                         "long_factor": [1.0 + i for i in range(36)]}},
        ("longrope", 72, 16)),
}


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("name", P21_FAMILIES)
def test_gemma2_gemma_phi3_on_the_card_match_the_cpu(cuda_device, tmp_path, name, pooling):
    """Gemma 2's sliding layers (its softcap ignored), Gemma's single KV head
    and erf GELU, Phi-3's fused projections, partial rotary and longrope
    (past 64 positions, its long factors) on the card: a left-padded batch
    of short texts beside ones of 200 to 512 tokens, against the CPU within
    ENC_TOL (1e-4)."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, widths, (rope_kind, rotated, window) = P21_FAMILIES[name]
    texts = _enc_texts(200, 24)
    if kind == "phi3":
        spec = fixtures.phi3_tokenizer_json(texts, 1500, seed=24)
        tok_config = fixtures.phi3_tokenizer_config(spec)
        vocab = 1564
    else:
        spec = fixtures.gemma_tokenizer_json(texts, 1500, seed=24)
        tok_config = fixtures.gemma_tokenizer_config(spec)
        vocab = len(spec["model"]["vocab"])
    config = {"model_type": kind, "vocab_size": vocab, "num_hidden_layers": 2, **widths}
    torch.manual_seed(25)
    model = new_model(config)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "norm" in pname:
                p.add_(torch.randn(p.shape) * 0.1)
    write_checkpoint(str(tmp_path), config, model.state_dict(), tokenizer_json=spec,
                     tokenizer_config=tok_config)
    texts = _enc_texts(15, seed=26) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "<|user|> hi<|end|> 中文 \U0001F680"]
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert (card._model.rope.kind, card._model.rope.dim, card._model.config["window"]) == (
        rope_kind, rotated, window)
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask[:, 0].min()) == 0  # left padding
    want = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


def test_encoder_chunks_on_the_card(cuda_device, tmp_path, monkeypatch):
    """Chunks of 3 texts on the card, each padded to its own longest,
    against one CPU pass; the chunk size read from the card's memory."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    path = _tiny_checkpoint(tmp_path, seed=3)
    texts = _enc_texts(11, seed=4)
    card = hf_encoder.TextEncoder(path, "useModel", device=cuda_device)
    chunk = hf_encoder.CHUNK_TEXTS
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    before = hf_encoder.FORWARDS.value
    got = card.encode(texts)
    assert hf_encoder.FORWARDS.value - before == 4
    assert card.chunk_texts() == 3
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", chunk)
    assert 1 <= card.chunk_texts() <= chunk
    want = hf_encoder.TextEncoder(path, "useModel", device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= 1e-5


def test_encoder_refused_launch_raises(cuda_device, tmp_path):
    """With TF32 on, the forward on the card refuses to launch: the embedder
    raises VECTOR_EMBEDDING_ERROR, counts a device error and retries
    nothing on the CPU."""
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.types.errors import EngineError, ErrorCode
    from meilisearch_tpu_torch.vector.embedders import Embedder

    path = _tiny_checkpoint(tmp_path, seed=5)
    embedder = Embedder("e", {"source": "huggingFace", "model": path}, cuda_device)
    before, forwards = serving_stats()["device_errors"], hf_encoder.FORWARDS.value
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(EngineError) as err:
            embedder.embed_documents(_enc_texts(4, seed=6))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert err.value.code == ErrorCode.VECTOR_EMBEDDING_ERROR
    assert "allow_tf32" in str(err.value)
    assert serving_stats()["device_errors"] == before + 1
    assert hf_encoder.FORWARDS.value == forwards + 1  # one attempt, on the card


def _dp_inputs(T, N, seed, device, width=None):
    """K6's inputs: `example_inputs` with INF addends where a class is
    absent, every 13th column matched by no term, every 11th invalid and
    docids above 2^23 from column N // 2 on (clipped in key_lo2); plus an
    int32 exactness addend for the cost mode. Laid out `width` columns
    wide (default N; pad columns inert, as the port's callers pad). On
    `device`."""
    from meilisearch_tpu_torch.ops import device_scorer as ds

    cm, pc, fc, pos, em, docids, valid = (x.clone() for x in ds.example_inputs(T=T, N=N, seed=seed))
    gen = torch.Generator().manual_seed(seed)
    absent = ~cm & (torch.rand(cm.shape, generator=gen) < 0.5)
    fc[absent] = ds.INF
    pos[absent] = ds.INF
    cm[:, :, ::13] = False
    valid[::11] = False
    docids[N // 2 :] = (1 << 23) + torch.arange(N - N // 2, dtype=torch.int32)
    exact_cost = torch.randint(0, 3, (T, N), generator=gen, dtype=torch.int32)
    tensors = (cm, pc, fc, pos, em, docids, valid, exact_cost)
    if width is not None and width > N:
        fills = (False, 0, ds.INF, ds.INF, False, 0, False, 0)
        tensors = tuple(
            torch.cat([x, torch.full(x.shape[:-1] + (width - N,), fill, dtype=x.dtype)], dim=-1)
            for x, fill in zip(tensors, fills)
        )
    tensors = tuple(x.contiguous().to(device) for x in tensors)
    return tensors[:7], tensors[7]


def _merge_passes(m: int, k: int) -> int:
    """The merge's launches over m survivors (mst_chain_topk's loop)."""
    passes = 1
    while m > 1024:
        m, passes = -(-m // 1024) * k, passes + 1
    return passes


@pytest.mark.parametrize("N", [257, (1 << 14) + 3])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16])
def test_chain_dp_kernel_matches_plain(cuda_device, T, N):
    """K6 in its three modes against its plain versions, bit for bit, in
    the unpadded layout (the direct path: N is odd) and the callers'
    padded one (the bulk path): the cost matrix, the three keys, and
    `chain_query_topk`'s docids and keys at k = 1, 10 and 32 (the top-k
    mode and the merge of its survivors) and at k from 33 to N (the keys
    mode and the sort of all N)."""
    from meilisearch_tpu_torch.ops import device_scorer as ds

    keys, exact_cost = _dp_inputs(T, N, 500 + T, cuda_device)
    want = [ds.chain_cost_matrix_torch(*keys[:4], exact_cost), *ds.chain_query_keys_torch(*keys)]
    ranked = ds.sort3(*want[1:], keys[5], N)
    tile = ds.tile_width(T)
    ks = sorted({1, 10, 32, 33, tile - 1, tile, tile + 1, N})
    for width in (N, ds.aligned_width(N)):
        args, cost_in = _dp_inputs(T, N, 500 + T, cuda_device, width)
        before, merges = ds.LAUNCHES.value, ds.SELECT_LAUNCHES.value
        got = [ds.chain_cost_matrix(*args[:4], cost_in, n=N)]
        path = ds.LAST_PATH["path"]
        got += ds.chain_query_keys(*args, n=N)
        top = {k: ds.chain_query_topk(*args, k=k, n=N) for k in ks}
        torch.cuda.synchronize()
        assert ds.LAUNCHES.value == before + 2 + len(ks)
        # the merge runs for the top-k mode's k only
        assert ds.SELECT_LAUNCHES.value == merges + sum(
            _merge_passes(-(-N // tile) * k, k) for k in ks if k <= ds.TOPK_MAX_K)
        assert path == ("bulk" if width % ds.ALIGN_COLUMNS == 0 else "direct")
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for k in ks:
            for g, w in zip(top[k], ranked):
                assert torch.equal(g, w[:k])


@pytest.mark.parametrize("T", [1, 4, 9, 16])
def test_chain_dp_topk_survivors_match_tile_select(cuda_device, T):
    """The top-k mode's survivors, slot for slot: each tile's k best
    entries in (hi, lo, lo2, column) order as `tile_select_torch` walks
    them, a short last tile's spare slots the sentinel."""
    from meilisearch_tpu_torch.ops import device_scorer as ds

    tile = ds.tile_width(T)
    N = 3 * tile + 5
    inputs, _cost = _dp_inputs(T, N, 70 + T, cuda_device, ds.aligned_width(N))
    plain = ds.chain_query_keys_torch(*(x[..., :N] for x in inputs))
    for k in (1, 10, ds.TOPK_MAX_K):
        kept = torch.empty((4, 4 * k), dtype=torch.int32, device=cuda_device)
        ds._launch(ds.MODE_TOPK, inputs, kept.unbind(0), T, N, inputs[5].shape[0], k)
        torch.cuda.synchronize()
        real = kept[0] != ds.SENTINEL
        assert int((~real).sum()) == k - min(k, N - 3 * tile)
        for g, w in zip(kept, ds.tile_select_torch(*(x.cpu() for x in plain), tile, k)):
            assert torch.equal(g[real].cpu(), w)


@pytest.mark.parametrize("T,N,k", [(4, 355_439, 10), (4, 1000, 32), (16, 2 * 128 * 1024 + 3, 32),
                                   (8, 70_000, 1), (1, 1, 1)])
def test_chain_query_topk_merges_in_one_call(cuda_device, T, N, k):
    """One call launches the top-k mode once and the merge's passes, and
    returns what the plain merge (`merge_survivors`) returns over the top-k
    mode's own survivors, and what the plain sort of all N returns."""
    from meilisearch_tpu_torch.ops import device_scorer as ds

    args, _cost = _dp_inputs(T, N, 90 + T, cuda_device, ds.aligned_width(N))
    tile = ds.tile_width(T)
    kept = torch.empty((4, -(-N // tile) * k), dtype=torch.int32, device=cuda_device)
    ds._launch(ds.MODE_TOPK, args, kept.unbind(0), T, N, args[5].shape[0], k)
    walked = ds.merge_survivors(kept, k, args[5], keep=min(k, N))
    launches, merges = ds.LAUNCHES.value, ds.SELECT_LAUNCHES.value
    got = ds.chain_query_topk(*args, k=k, n=N)
    torch.cuda.synchronize()
    assert ds.LAUNCHES.value == launches + 1
    assert ds.SELECT_LAUNCHES.value == merges + _merge_passes(kept.shape[1], k)
    for g, w in zip(got, (walked[3], *walked[:3])):
        assert torch.equal(g, w)
    for g, w in zip(got, ds.chain_query_topk_torch(*(x[..., :N] for x in args), k=k)):
        assert torch.equal(g, w)


def test_chain_dp_misaligned_inputs_take_the_direct_path(cuda_device):
    """A contiguous input that starts 4 bytes into its buffer cannot be
    bulk-copied: the same padded layout then runs the direct path, equal."""
    from meilisearch_tpu_torch.ops import device_scorer as ds

    N = 1000
    args, cost_in = _dp_inputs(4, N, 31, cuda_device, ds.aligned_width(N))
    fid = args[2]
    buf = torch.empty(fid.numel() + 1, dtype=fid.dtype, device=cuda_device)
    shifted = buf[1:].view(fid.shape)
    shifted.copy_(fid)
    args = (*args[:2], shifted, *args[3:])
    got = ds.chain_query_keys(*args, n=N)
    assert ds.LAST_PATH["path"] == "direct"
    torch.cuda.synchronize()
    for g, w in zip(got, ds.chain_query_keys_torch(*(x[..., :N] for x in args))):
        assert torch.equal(g, w)


def test_chain_dp_refused_launch_raises(cuda_device):
    from meilisearch_tpu_torch.ops import device_scorer as ds

    keys, exact_cost = _dp_inputs(2, 1024, 9, cuda_device)
    out = torch.empty((6, 1024), dtype=torch.int32, device=cuda_device)
    rc = _build.load_library().mst_chain_dp(
        *[x.data_ptr() for x in keys[:4]], exact_cost.data_ptr(), None, None,
        out.data_ptr(), None, None, None, ds.MAX_TERMS + 1, 1024, 1024, ds.MODE_COST, 0,
        ds.tile_width(ds.MAX_TERMS), 1, torch.cuda.current_stream().cuda_stream,
    )
    assert rc != 0  # more terms than the kernel takes
    with pytest.raises(RuntimeError):
        ds.check_launch(rc)


def test_sharded_query_topk_one_nccl_rank(cuda_device, tmp_path):
    """A one-rank NCCL group: the scatter-gather equals the single-device
    top-k, whether it is given numpy arrays or tensors on the card (it
    measures no collective across cards)."""
    import torch.distributed as dist

    from meilisearch_tpu_torch.ops import device_scorer as ds
    from meilisearch_tpu_torch.parallel import sharded

    assert dist.is_nccl_available()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "rdv"), 1),
                            rank=0, world_size=1)
    try:
        shards = sharded.make_group()
        assert shards.device.type == "cuda" and shards.size == 1
        inputs = tuple(x.numpy() for x in ds.example_inputs(T=3, N=4096, k=10, seed=2))
        want = ds.chain_query_topk(*(torch.from_numpy(x).to(cuda_device) for x in inputs), k=10)
        # the global arrays as numpy, and already on the card
        for given in (inputs, tuple(torch.from_numpy(x).to(cuda_device) for x in inputs)):
            docs, hi = sharded.sharded_query_topk(shards, given, k=10)
            assert torch.equal(docs, want[0]) and torch.equal(hi, want[1])
    finally:
        dist.destroy_process_group()


def test_device_scorer_path_on_the_card_matches_host(cuda_device, monkeypatch):
    """MEILI_TPU_DEVICE=1 on a store bound to the card: the executor's
    chain queries go through K6, and every page equals the host pass."""
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.ops import device_scorer as ds
    from meilisearch_tpu_torch.search.executor import Search

    vocab = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta", "sigma"]
    rng = np.random.default_rng(7)
    store = IndexStore("k6", primary_key="id")
    store.settings.apply_json({"searchableAttributes": ["text"]})
    store.add_documents([
        {"id": i, "text": " ".join(rng.choice(vocab, size=rng.integers(2, 9)).tolist())}
        for i in range(2000)
    ])
    for query in ["alpha beta", "gamma delta epsilon", "alpha omge", "alph", '"alpha beta"']:
        monkeypatch.setenv("MEILI_TPU_DEVICE", "0")
        host = Search(store, query=query, limit=50).execute().documents_ids
        store.device = cuda_device
        monkeypatch.setenv("MEILI_TPU_DEVICE", "1")
        before = ds.LAUNCHES.value
        page = Search(store, query=query, limit=50).execute().documents_ids
        store.device = None
        assert page == host, query
        assert (ds.LAUNCHES.value > before) == (not query.startswith('"')), query


# RoBERTa's relatives at a published checkpoint's widths, cut to 2 layers:
# allenai/longformer-base-4096 with windows [16, 32] (so they bite),
# facebook/data2vec-text-base, facebook/xlm-roberta-xl and
# google/bigbird-roberta-base (block_sparse, run full)
P22_FAMILIES = {
    "longformer": {"model_type": "longformer", "hidden_size": 768, "num_attention_heads": 12,
                   "intermediate_size": 3072, "max_position_embeddings": 4098,
                   "type_vocab_size": 1, "layer_norm_eps": 1e-5, "pad_token_id": 1,
                   "attention_window": [16, 32]},
    "data2vec-text": {"model_type": "data2vec-text", "hidden_size": 768,
                      "num_attention_heads": 12, "intermediate_size": 3072,
                      "max_position_embeddings": 514, "type_vocab_size": 1,
                      "layer_norm_eps": 1e-5, "pad_token_id": 1},
    "xlm-roberta-xl": {"model_type": "xlm-roberta-xl", "hidden_size": 2560,
                       "num_attention_heads": 32, "intermediate_size": 10240,
                       "max_position_embeddings": 514, "type_vocab_size": 1,
                       "layer_norm_eps": 1e-5, "pad_token_id": 1},
    "big_bird": {"model_type": "big_bird", "hidden_size": 768, "num_attention_heads": 12,
                 "intermediate_size": 3072, "max_position_embeddings": 4096,
                 "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0,
                 "hidden_act": "gelu_new", "attention_type": "block_sparse", "block_size": 64,
                 "num_random_blocks": 3, "rescale_embeddings": True},
}


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", list(P22_FAMILIES))
def test_roberta_relatives_on_the_card_match_the_cpu(cuda_device, tmp_path, kind, pooling):
    """Longformer's band (windows 16 and 32 under texts of 200 to 512
    tokens; its padded queries zeroed), data2vec-text's RoBERTa layers,
    XLM-RoBERTa-XL's pre-norms at 2,560 wide and BigBird's full attention
    with scaled word embeddings on the card: a padded batch of short texts
    beside long ones, against the CPU within 1e-5."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    config = dict(P22_FAMILIES[kind], num_hidden_layers=2)
    if kind in ("longformer", "data2vec-text"):
        spec = fixtures.roberta_tokenizer_json(_enc_texts(200, 27), 1500, seed=27)
    elif kind == "xlm-roberta-xl":
        spec = fixtures.xlmr_tokenizer_json(_spm_pieces(27))
    else:
        spec = fixtures.bigbird_tokenizer_json(_spm_pieces(27))
    config["vocab_size"] = len(spec["model"]["vocab"])
    torch.manual_seed(28)
    write_checkpoint(str(tmp_path), config, new_model(config).state_dict(), tokenizer_json=spec)
    texts = _enc_texts(15, seed=29) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "x <mask> y [MASK] z"]
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert card._model.config["model_type"] == kind
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    want = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-5


# google/bigbird-roberta-base's widths at 2 layers, under its model card's
# block_size 16 and num_random_blocks 2: a threshold of 144 tokens
P23_BIGBIRD = {**P22_FAMILIES["big_bird"], "num_hidden_layers": 2, "block_size": 16,
               "num_random_blocks": 2, "rescale_embeddings": False}


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_bigbird_block_sparse_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling,
                                                          monkeypatch):
    """BigBird's block-sparse attention on the card: the forward on a
    right-padded batch of 150 to 512 tokens beside short texts, on every
    row (padded ones zeroed by the sparse path), and a call of more texts
    than a chunk (chunks of 4, the first all under the threshold), cut
    from its one padded batch, against the CPU within 1e-5."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = fixtures.bigbird_tokenizer_json(_spm_pieces(31))
    config = dict(P23_BIGBIRD, vocab_size=len(spec["model"]["vocab"]))
    torch.manual_seed(32)
    write_checkpoint(str(tmp_path), config, new_model(config).state_dict(), tokenizer_json=spec)
    rng = np.random.default_rng(33)
    texts = ["rust", " ".join(rng.choice(ENC_WORDS, size=40)), " ".join(rng.choice(ENC_WORDS, 90)),
             "", " ".join(rng.choice(ENC_WORDS, size=170)), " ".join(ENC_WORDS * 80), "gpu"]
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    host = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None)
    card._load()
    host._load()
    assert card._model.sparse_threshold == 144
    ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    with torch.inference_mode():
        got = card._model(ids.to(cuda_device), mask.to(cuda_device)).cpu()
        want = host._model(ids, mask)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-5
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 4)
    got = card.encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - host.encode(texts)).max()) <= 1e-5


# the SGPT types at published widths, cut to 2 layers: gpt_neo at
# gpt-neo-125M's (a 16-token window, so it bites), gptj at gpt-j-6b's head
# width over a narrower model (rotary_dim 32 of 64: the rest of each head
# passed through), bloom at bloom-560m's (16 heads of 64, ALiBi), each over
# a seeded byte-level BPE in GPT-2's or BLOOM's layout: (config, module)
P24_FAMILIES = {
    "gpt_neo": ({"model_type": "gpt_neo", "hidden_size": 768, "num_layers": 2, "num_heads": 12,
                 "attention_types": [[["global", "local"], 1]], "window_size": 16,
                 "max_position_embeddings": 2048}, "GPTNeoModel"),
    "gptj": ({"model_type": "gptj", "n_embd": 1024, "n_layer": 2, "n_head": 16,
              "rotary_dim": 32, "n_positions": 2048}, "GPTJModel"),
    "bloom": ({"model_type": "bloom", "hidden_size": 1024, "n_layer": 2, "n_head": 16},
              "BloomModel"),
}


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", list(P24_FAMILIES))
def test_gpt_neo_gptj_bloom_on_the_card_match_the_cpu(cuda_device, tmp_path, kind, pooling,
                                                      side, monkeypatch):
    """GPT-Neo's unscaled global and local layers, GPT-J's partial rotary and
    BLOOM's ALiBi on the card: a batch of short texts beside ones of 200 to
    512 tokens, padded right and left, in chunks of 8 cut from the call's
    one batch where left padding shifts the positions, against the CPU
    within 1e-4 (ENC_TOL)."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    config, module = P24_FAMILIES[kind]
    if kind == "bloom":
        spec = fixtures.bloom_tokenizer_json(_enc_texts(200, 34), 1500, seed=34)
        tok_config = fixtures.bloom_tokenizer_config(spec, padding_side=side)
    else:
        spec = fixtures.gpt2_tokenizer_json(_enc_texts(200, 34), 1500, seed=34)
        tok_config = fixtures.gpt2_tokenizer_config(spec, padding_side=side)
    config = {**config, "vocab_size": len(spec["model"]["vocab"])}
    torch.manual_seed(35)
    write_checkpoint(str(tmp_path), config, new_model(config).state_dict(), tokenizer_json=spec,
                     tokenizer_config=tok_config)
    texts = _enc_texts(15, seed=36) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "<|endoftext|> Hello, world! (a|b) 中文 \U0001F680"]
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 8)
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert type(card._model).__name__ == module and card._tokenizer.padding_side == side
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    want = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


# BMRetriever-410M's widths (EleutherAI/pythia-410m's, as recalled: 1,024
# wide, 16 heads of 64 with 16 rotated channels, intermediate 4,096) cut to
# 2 layers, over a seeded byte-level BPE in GPT-NeoX-20B's layout
P26_GPT_NEOX = {"model_type": "gpt_neox", "hidden_size": 1024, "num_hidden_layers": 2,
                "num_attention_heads": 16, "intermediate_size": 4096, "rotary_pct": 0.25,
                "max_position_embeddings": 2048}


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_gpt_neox_on_the_card_matches_the_cpu(cuda_device, tmp_path, pooling, side, parallel,
                                              monkeypatch):
    """GPT-NeoX's per-head fused QKV, partial rotary and parallel (or
    sequential) residual on the card: short texts beside ones of 200 to
    512 tokens, padded right and left, in chunks of 8 (cut from the call's
    one batch under left padding), against the CPU within 1e-4
    (ENC_TOL)."""
    from meilisearch_tpu_torch.models import fixtures, hf_encoder
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = fixtures.gpt_neox_tokenizer_json(_enc_texts(200, 37), 1500, seed=37)
    config = {**P26_GPT_NEOX, "vocab_size": len(spec["model"]["vocab"]),
              "use_parallel_residual": parallel}
    torch.manual_seed(38)
    write_checkpoint(str(tmp_path), config, new_model(config).state_dict(), tokenizer_json=spec,
                     tokenizer_config=fixtures.gpt_neox_tokenizer_config(spec, padding_side=side))
    texts = _enc_texts(15, seed=39) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "<|endoftext|> Hello,   world! 中文 \U0001F680"]
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 8)
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    got = card.encode(texts)
    assert next(card._model.parameters()).is_cuda
    assert type(card._model).__name__ == "GPTNeoXModel" and card._tokenizer.padding_side == side
    _ids, mask = card._tokenizer(texts, card.max_len)
    assert mask.shape[1] == 512 and int(mask.sum(1).min()) < 16
    want = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None).encode(texts)
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


# the MoE types at small widths, 2 layers, written as BF16 shards with
# their index (safetensors for each type, pytorch_model.bin shards beside):
# mixtral (8 experts, top 2, a 64-token window in every layer), qwen2_moe
# (16 experts, top 4 unnormalized, a shared expert, a dense second layer),
# qwen3_moe (32 experts, top 8 renormalized, Q/K norms, the sparse block
# every second layer)
P25_FAMILIES = {
    "mixtral": {"model_type": "mixtral", "hidden_size": 512, "intermediate_size": 768,
                "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
                "num_local_experts": 8, "num_experts_per_tok": 2, "sliding_window": 64},
    "qwen2_moe": {"model_type": "qwen2_moe", "hidden_size": 512, "intermediate_size": 768,
                  "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 8,
                  "num_experts": 16, "num_experts_per_tok": 4, "moe_intermediate_size": 256,
                  "shared_expert_intermediate_size": 512, "mlp_only_layers": [1]},
    "qwen3_moe": {"model_type": "qwen3_moe", "hidden_size": 512, "intermediate_size": 768,
                  "num_hidden_layers": 2, "num_attention_heads": 8, "num_key_value_heads": 2,
                  "head_dim": 64, "num_experts": 32, "num_experts_per_tok": 8,
                  "moe_intermediate_size": 128, "norm_topk_prob": True,
                  "decoder_sparse_step": 2},
}


def _moe_checkpoint(path, kind, side, safetensors=True):
    """`kind`'s checkpoint at P25_FAMILIES' widths, seeded torch weights
    rounded to BF16, written as shards of at most 4 MB with their index,
    beside a seeded BPE of its class (Llama-2's for mixtral, Qwen2's for
    the others) padding on `side`."""
    from meilisearch_tpu_torch.models import fixtures
    from meilisearch_tpu_torch.models.checkpoint import new_model, write_checkpoint

    if kind == "mixtral":
        spec = fixtures.llama_tokenizer_json(_enc_texts(200, 37), 1500, seed=37)
        tok_config = fixtures.llama_tokenizer_config(spec, padding_side=side)
    else:
        spec = fixtures.qwen2_tokenizer_json(_enc_texts(200, 37), 1500, seed=37)
        tok_config = fixtures.qwen2_tokenizer_config(spec, padding_side=side)
    config = {**P25_FAMILIES[kind], "vocab_size": len(spec["model"]["vocab"])}
    torch.manual_seed(38)
    state = {k: v.to(torch.bfloat16) for k, v in new_model(config).state_dict().items()}
    write_checkpoint(str(path), config, state, tokenizer_json=spec, tokenizer_config=tok_config,
                     shard_bytes=1 << 22)
    if not safetensors:  # the same tensors as pytorch_model.bin shards, read instead
        from meilisearch_tpu_torch.models.checkpoint import write_shards

        for f in path.iterdir():
            if f.name.startswith("model"):
                f.unlink()
        write_shards(str(path), state, 1 << 22, safetensors=False)


def _routed(card, host, texts):
    """(card vectors, CPU vectors, texts held): each encoder's vectors of
    `texts` with its gates' logits captured, a text whose experts differ
    at a CPU margin under chip_smoke.ROUTE_MARGIN left out (one at or above
    it raises: chip_smoke.routing_rule)."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke

    with chip_smoke.gate_log(card._model) as on_card:
        got = card.encode(texts)
    with chip_smoke.gate_log(host._model) as on_host:
        want = host.encode(texts)
    assert on_card and all(layers and layers[0].shape[0] == mask.numel()
                           for mask, layers in on_card)  # the sparse blocks ran
    rule = chip_smoke.routing_rule(on_card, on_host, card._model.config["num_experts_per_tok"],
                                   "moe")
    held = [t for t in range(len(texts)) if t not in rule["texts"]]
    return got[held], want[held], held


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", list(P25_FAMILIES))
def test_moe_encoders_on_the_card_match_the_cpu(cuda_device, tmp_path, kind, pooling, side,
                                                monkeypatch):
    """Mixtral's, Qwen2-MoE's and Qwen3-MoE's sparse blocks on the card,
    read from BF16 shards: short texts beside ones of 200 to 512 tokens,
    padded right and left, in chunks of 8 (cut from the call's one batch
    under forceCls with left padding), against the CPU within 1e-4
    (ENC_TOL) on every text the routing rule holds (most of them)."""
    from meilisearch_tpu_torch.models import hf_encoder, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    _moe_checkpoint(tmp_path, kind, side)
    texts = _enc_texts(15, seed=39) + [" ".join(ENC_WORDS * 30), " ".join(ENC_WORDS * 80), "",
                                       "<s> Hello, world! 中文 \U0001F680"]
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 8)
    card = hf_encoder.TextEncoder(str(tmp_path), pooling, device=cuda_device)
    host = hf_encoder.TextEncoder(str(tmp_path), pooling, device=None)
    card._load()
    host._load()
    assert next(card._model.parameters()).is_cuda and card._tokenizer.padding_side == side
    assert any(isinstance(m, moe.SparseMoeBlock) for m in card._model.modules())
    got, want, held = _routed(card, host, texts)
    assert len(held) >= len(texts) - 2
    assert bool(np.isfinite(got).all())
    assert float(np.abs(got - want).max()) <= 1e-4


def test_bin_shards_on_the_card_match_the_cpu(cuda_device, tmp_path):
    """A Mixtral checkpoint as BF16 pytorch_model.bin shards and
    pytorch_model.bin.index.json: the card's module holds the CPU's
    weights bit for bit, and encodes as the CPU does (routing rule)."""
    from meilisearch_tpu_torch.models import hf_encoder

    torch.backends.cuda.matmul.allow_tf32 = False
    _moe_checkpoint(tmp_path, "mixtral", "left", safetensors=False)
    assert (tmp_path / "pytorch_model.bin.index.json").exists()
    assert len(list(tmp_path.glob("pytorch_model-*-of-*.bin"))) > 1
    card = hf_encoder.TextEncoder(str(tmp_path), "useModel", device=cuda_device)
    host = hf_encoder.TextEncoder(str(tmp_path), "useModel", device=None)
    card._load()
    host._load()
    for (name, a), (_name, b) in zip(card._model.state_dict().items(),
                                     host._model.state_dict().items()):
        assert torch.equal(a.cpu(), b), name
    got, want, _held = _routed(card, host, _enc_texts(12, seed=40))
    assert float(np.abs(got - want).max()) <= 1e-4
