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
encoder (K8), BERT and XLM-R, on the card as the same checkpoint on the CPU."""

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
