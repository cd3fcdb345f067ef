"""BigBird's block-sparse attention in the text encoder (K8):
models/big_bird.py through models/bert.py, held against a fresh
transformers `BigBirdModel` in eval and against the JAX package's
`FlaxTextEncoder` (its torch branch, from pytorch_model.bin: fault 3.27),
a fresh instance for each call (fault 3.28: the reference's switch to
full attention persists).

Nothing is downloaded. Tiny models (2 layers, hidden 32, 4 heads,
intermediate 64), weights drawn with numpy from a seed (Q and K with a
standard deviation of 0.15, so attention is peaked), at (block_size,
num_random_blocks) (16, 2), (16, 3), (32, 5) and (64, 1): thresholds
144 (google/bigbird-roberta-base under its model card's settings), 176,
480 and 448, all under the encoder's 512 tokens. Batches are right-padded
and mix short texts with long ones, at a length just over the
threshold, at one that is not a multiple of the block, and at 512. The
last hidden state is compared on its real rows and on its padded ones
(the sparse path zeroes a padded query's attention), pooled vectors
after normalization; ATOL 1e-5 throughout."""

import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import bert, big_bird, checkpoint, fixtures  # noqa: E402
from meilisearch_tpu_torch.models import hf_encoder  # noqa: E402

ATOL = 1e-5
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "naïve", "recherche", "données"]
CHARS = "abcdefghijklmnopqrstuvwxyz0123456789.,!?'-éèàçï"
TINY = {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "intermediate_size": 64}
# (block_size, num_random_blocks, threshold)
SHAPES = [(16, 2, 144), (16, 3, 176), (32, 5, 480), (64, 1, 448)]
SHAPE_IDS = [f"block{b}-r{r}" for b, r, _t in SHAPES]


def _pieces() -> list:
    rng = np.random.default_rng(5)
    pieces = ["▁"] + list(dict.fromkeys(CHARS)) + ["▁" + c for c in dict.fromkeys(CHARS)]
    for w in WORDS:
        pieces += ["▁" + w, w[: len(w) // 2], w[len(w) // 2:]]
    pieces = list(dict.fromkeys(pieces))
    return [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]


SPEC = fixtures.bigbird_tokenizer_json(_pieces())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: intra-op threads
    cost them more than they give, and beside the suite's other workers
    they oversubscribe the cores (about 4x this file's time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _config(block, r, **over):
    widths = {"vocab_size": len(SPEC["model"]["vocab"]), "max_position_embeddings": 1024,
              "block_size": block, "num_random_blocks": r, **TINY}
    return transformers.BigBirdConfig(**{**widths, **over})


def _pair(block, r, seed, **over):
    """A fresh transformers BigBirdModel in eval with seeded weights, and
    the port's module over the same tensors."""
    config = _config(block, r, **over)
    ref = transformers.BigBirdModel(config).eval()
    _draw_weights(ref, seed)
    ours = bert.BertModel(config.to_dict())
    state = checkpoint.hf_to_state_dict(ref.state_dict(), "big_bird")
    ours.load_state_dict({k: v for k, v in state.items() if not k.startswith("pooler.")})
    return ref, ours


def _ids(lengths, L, seed):
    """(ids, mask): right-padded rows of `lengths` real tokens at L, each
    opening with [CLS] and closing with [SEP], pad id 0."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), L), np.int64)
    mask = np.zeros((len(lengths), L), np.int64)
    for row, n in enumerate(lengths):
        ids[row, :n] = rng.integers(70, len(SPEC["model"]["vocab"]), n)
        ids[row, 0], ids[row, n - 1] = 65, 66
        mask[row, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _lengths(case, block, threshold):
    if case == "just-over":
        return threshold + 1
    if case == "512":
        return 512
    L = (threshold + 512) // 2  # between the threshold and 512, off the block grid
    return L + 1 if L % block == 0 else L


def _assert_rows(got, want, mask):
    real = mask.bool()
    assert float((got - want)[real].abs().max()) <= ATOL
    assert float((got - want)[~real].abs().max()) <= ATOL


# -- the forward against a fresh transformers BigBirdModel ------------------------


@pytest.mark.parametrize("rescale", [False, True], ids=["plain", "rescaled"])
@pytest.mark.parametrize("case", ["just-over", "off-grid", "512"])
@pytest.mark.parametrize("block, r, threshold", SHAPES, ids=SHAPE_IDS)
def test_forward_matches_a_fresh_transformers_model(block, r, threshold, case, rescale):
    """A right-padded batch mixing short texts (one shorter than a block,
    so block 0 holds pads) with long ones, past the threshold: the
    reference pads it to a multiple of the block and runs its sparse
    path; the port matches it on every row, padded rows too."""
    ref, ours = _pair(block, r, seed=block + r, rescale_embeddings=rescale)
    assert bert.sparse_threshold(ours.config) == ours.sparse_threshold == threshold
    L = _lengths(case, block, threshold)
    assert L > threshold and (case == "512" or L % block)
    ids, mask = _ids([L, 3, block - 1, L // 2, L - 7], L, seed=L)
    with torch.no_grad():
        want = ref(input_ids=ids, attention_mask=mask).last_hidden_state
        got = ours(ids, mask)
    assert ref.attention_type == "block_sparse"
    assert got.shape == want.shape == (5, L, TINY["hidden_size"])
    _assert_rows(got, want, mask)


@pytest.mark.parametrize("block, r, threshold", SHAPES, ids=SHAPE_IDS)
def test_sparse_and_full_attention_differ_past_the_threshold(block, r, threshold):
    """Full attention cannot stand in for the sparse path: on the same
    batch the two differ far past the tolerance, and at the threshold
    itself the port runs full attention as the reference does."""
    _ref, ours = _pair(block, r, seed=7)
    full = bert.BertModel({**ours.config, "attention_type": "original_full"})
    full.load_state_dict(ours.state_dict())
    ids, mask = _ids([threshold + 1, 20], threshold + 1, seed=3)
    with torch.no_grad():
        assert float((ours(ids, mask) - full(ids, mask))[mask.bool()].abs().max()) > 1e-3
        ids, mask = ids[:, :threshold], mask[:, :threshold].clone()
        mask[0, -1] = 1
        assert torch.equal(ours(ids, mask), full(ids, mask))


def test_the_pattern_counts_block_zero_once_and_r_more_times():
    """Query block i of 8 at r = 2: block 0 and the last see every key;
    1 sees 0 (three times), 1, 2 and 7; 6 sees 0 (three times), 5, 6 and
    7; the middle ones their neighbours, 0 (three times) and 7."""
    counts = big_bird.block_counts(8, 2).tolist()
    assert counts[0] == counts[7] == [1] * 8
    assert counts[1] == [3, 1, 1, 0, 0, 0, 0, 1]
    assert counts[6] == [3, 0, 0, 0, 0, 1, 1, 1]
    assert counts[3] == [3, 0, 1, 1, 1, 0, 0, 1]


def test_a_padded_length_past_the_positions_is_refused_by_name():
    """490 tokens pad to 512 at block 64, past 500 positions: the
    reference's embeddings fail to add their positions; the port refuses
    the batch by name."""
    ref, ours = _pair(64, 1, seed=3, max_position_embeddings=500)
    ids, mask = _ids([490, 30], 490, seed=4)
    with torch.no_grad(), pytest.raises(RuntimeError, match="512.*500"):
        ref(input_ids=ids, attention_mask=mask)
    with pytest.raises(ValueError, match="pads to 512.*max_position_embeddings 500"):
        ours(ids, mask)


# -- the encoder against the JAX package's FlaxTextEncoder --------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A pytorch_model.bin checkpoint of each of SHAPES, and one of
    (16, 2) with `rescale_embeddings`, beside the BigBird tokenizer."""
    root = tmp_path_factory.mktemp("bigbird_sparse")
    out = {}
    shapes = [(b, r, {}) for b, r, _t in SHAPES] + [(16, 2, {"rescale_embeddings": True})]
    for i, (block, r, over) in enumerate(shapes):
        name = f"block{block}-r{r}" + ("-rescaled" if over else "")
        model = transformers.BigBirdModel(_config(block, r, **over))
        _draw_weights(model, 60 + i)
        out[name] = str(root / name)
        model.save_pretrained(out[name], safe_serialization=False)
        with open(os.path.join(out[name], "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(SPEC, f, ensure_ascii=False)
        with open(os.path.join(out[name], "tokenizer_config.json"), "w") as f:
            json.dump(fixtures.bigbird_tokenizer_config(SPEC), f)
    return out


def _texts(threshold, seed):
    """Short texts beside runs of the vocabulary's words: one just past
    the threshold, so the call's padded length is over it, and one
    shorter."""
    rng = np.random.default_rng(seed)

    def run(n):
        return " ".join(rng.choice(WORDS, size=n))

    return ["hello", run(threshold), "", run(12), run(threshold // 2), "x [MASK] y café"]


def _fresh(path, pooling, texts):
    enc = FlaxTextEncoder(path, pooling)
    want = enc.encode(texts)
    assert enc._flax is None and enc._torch is not None
    return want, enc


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", [*SHAPE_IDS, "block16-r2-rescaled"])
def test_encoder_matches_jax(ckpt, kind, pooling):
    """One call past the threshold (not on the block grid) and one at 512
    tokens (a text past it, truncated), each against a fresh reference."""
    port = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None)
    port._load()
    threshold = port._model.sparse_threshold
    for texts in (_texts(threshold, seed=1), _texts(threshold, seed=2) + [" ".join(WORDS * 50)]):
        want, ref = _fresh(ckpt[kind], pooling, texts)
        assert ref._torch.attention_type == "block_sparse"
        _ids, mask = port._tokenizer(texts, port.max_len)
        assert threshold < mask.shape[1] <= 512
        got = port.encode(texts)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert float(np.abs(got - want).max()) <= ATOL
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
@pytest.mark.parametrize("kind", ["block16-r2", "block64-r1"])
def test_a_call_of_more_texts_than_a_chunk_is_one_batch(ckpt, kind, pooling, monkeypatch):
    """The JAX package pads a call's texts as one batch: past the
    threshold it runs sparse, and its blocks' layout follows that length.
    With chunks of 3 the first chunk holds only texts under the threshold
    (two of them past block 0, which sees every key); cut from the call's
    one padded batch it runs sparse as the reference does (padded to its
    own length it would run full and miss the reference's vectors: by
    1.3e-3 to 5.7e-3 under mean pooling, 2.9e-5 to 1.9e-4 on [CLS],
    whose own block sees every key)."""
    monkeypatch.setattr(hf_encoder, "CHUNK_TEXTS", 3)
    port = hf_encoder.TextEncoder(ckpt[kind], pooling, device=None)
    port._load()
    threshold = port._model.sparse_threshold
    block = port._model.config["block_size"]
    rng = np.random.default_rng(11)
    texts = ["rust"] + [" ".join(rng.choice(WORDS, size=n)) for n in (
        block + 20, threshold // 2, 40, threshold + 20, 7, 600, 3)]
    want, _ref = _fresh(ckpt[kind], pooling, texts)
    got = port.encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL
    alone = port.encode(texts[:3])  # the short chunk as a call of its own: full attention
    assert float(np.abs(alone - want[:3]).max()) > ATOL


def test_fault_328_the_references_bigbird_fallback_keeps_state(ckpt):
    """The JAX package keeps one encoder per (model, pooling). Its model
    runs a long call sparse when that call comes first; a short call
    switches it to full attention for good (`set_attention_type` is never
    undone), and the same long call then runs full. The port decides for
    each forward: the long call runs sparse both times, as a fresh model
    runs it."""
    path = ckpt["block16-r2"]
    rng = np.random.default_rng(12)
    long = ["hello"] + [" ".join(rng.choice(WORDS, size=n)) for n in (200, 90)]
    short = ["rust compiler", "café"]
    ref = FlaxTextEncoder(path, "useModel")
    first = ref.encode(long)
    assert ref._torch.attention_type == "block_sparse"
    ref.encode(short)
    assert ref._torch.attention_type == "original_full"
    again = ref.encode(long)
    assert float(np.abs(again - first).max()) > 1e-3

    port = hf_encoder.TextEncoder(path, "useModel", device=None)
    got = [port.encode(long), port.encode(short), port.encode(long)]
    assert float(np.abs(got[0] - first).max()) <= ATOL
    assert float(np.abs(got[2] - first).max()) <= ATOL
    full = hf_encoder.TextEncoder(path, "useModel", device=None)
    full._load()
    full._model.sparse_threshold = None  # the reference's state after a short call
    assert float(np.abs(full.encode(long) - again).max()) <= ATOL
