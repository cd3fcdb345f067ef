"""Sharded checkpoints: the port's weight reader (models/checkpoint.py)
against transformers' `from_pretrained` on the directories its
`save_pretrained` writes for a model larger than `max_shard_size`
(`model.safetensors.index.json` or `pytorch_model.bin.index.json` and
their shards, float32 or BF16), the port's own writer (`write_shards`)
read back by both, the order in which a directory's weight files are
picked, and the encoder against the JAX package's `FlaxTextEncoder` on
such a directory.

Nothing is downloaded. A tiny Mixtral (hidden 64, 4 heads over 2 KV heads,
6 experts of 48, top 2) is built from transformers' `MixtralConfig`, its
weights drawn with numpy from a seed, beside a seeded Llama-2 byte-fallback
BPE (models/fixtures.py). No Flax Mixtral exists, so the JAX package's
encoder runs transformers' torch model (its AutoModel branch). Weights
must be read bit for bit (BF16 widened exactly); vectors agree within
1e-5."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

from meilisearch_tpu.models.hf_encoder import FlaxTextEncoder  # noqa: E402
from meilisearch_tpu_torch.models import checkpoint, fixtures, hf_encoder  # noqa: E402

ATOL = 1e-5  # max abs error of normalized vectors
WORDS = ["hello", "world", "search", "engine", "rust", "python", "database", "cloud",
         "machine", "learning", "café", "中文"]
SMALL = dict(hidden_size=64, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, num_local_experts=6, num_experts_per_tok=2,
             max_position_embeddings=2048)
SHARD = "40KB"  # save_pretrained's max_shard_size: several shards of the tiny model
FORMATS = [(safe, dtype) for safe in (True, False) for dtype in (torch.float32, torch.bfloat16)]


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in rng.integers(0, 30, n)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spec():
    return fixtures.llama_tokenizer_json(_texts(200, seed=1), 600, seed=25)


def _model(spec, seed):
    model = transformers.MixtralModel(transformers.MixtralConfig(
        **SMALL, vocab_size=len(spec["model"]["vocab"]), pad_token_id=2))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mean, std = (1.0, 0.05) if "norm" in name else (0.0, 0.3 if "gate" in name else 0.05)
            p.copy_(torch.from_numpy(rng.normal(mean, std, tuple(p.shape)).astype(np.float32)))
    return model.eval()


def _tokenizer_files(path, spec):
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(fixtures.llama_tokenizer_config(spec), f)


@pytest.fixture(scope="module")
def saved(spec, tmp_path_factory):
    """(safetensors, dtype) -> a directory save_pretrained wrote in shards
    of at most SHARD, with the tokenizer files."""
    root = tmp_path_factory.mktemp("shards")
    model = _model(spec, 3)
    out = {}
    for safe, dtype in FORMATS:
        path = str(root / f"{'st' if safe else 'bin'}-{str(dtype)[6:]}")
        model.to(dtype).save_pretrained(path, max_shard_size=SHARD, safe_serialization=safe)
        _tokenizer_files(path, spec)
        out[safe, dtype] = path
    return out


def _reference_state(path):
    """transformers' own read: AutoModel's float32 parameters."""
    ref = transformers.AutoModel.from_pretrained(path).eval()
    assert next(ref.parameters()).dtype == torch.float32
    return ref, ref.state_dict()


@pytest.mark.parametrize("safe, dtype", FORMATS)
def test_a_sharded_directory_reads_as_transformers_reads_it(saved, safe, dtype):
    """save_pretrained's shards and index, float32 or BF16: every tensor
    the index names is read, once, from its file, and equals what
    AutoModel loads (BF16 widened to float32 exactly)."""
    path = saved[safe, dtype]
    index = "model.safetensors.index.json" if safe else "pytorch_model.bin.index.json"
    with open(os.path.join(path, index)) as f:
        weight_map = json.load(f)["weight_map"]
    files = set(weight_map.values())
    assert len(files) > 2 and not any(
        os.path.exists(os.path.join(path, f)) for f in ("model.safetensors", "pytorch_model.bin"))
    got = checkpoint.read_weights(path, "mixtral")
    _ref, want = _reference_state(path)
    assert set(got) == set(want) == set(weight_map)
    for name, value in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], value), name


def test_each_shard_is_read_once(saved, monkeypatch):
    """Each file the index names is opened once, however many tensors it
    holds."""
    path = saved[True, torch.bfloat16]
    reads = []
    read = checkpoint._read_file
    monkeypatch.setattr(checkpoint, "_read_file", lambda f: reads.append(f) or read(f))
    checkpoint.read_weights(path, "mixtral")
    assert len(reads) == len(set(reads)) > 2


def test_a_tensor_missing_from_its_shard_is_refused(saved, tmp_path):
    """An index that maps a tensor to a shard without it raises by name,
    as transformers' loader reports it missing."""
    path = str(tmp_path / "broken")
    shutil.copytree(saved[True, torch.float32], path)
    index = os.path.join(path, "model.safetensors.index.json")
    with open(index) as f:
        data = json.load(f)
    name = "layers.1.block_sparse_moe.experts.5.w2.weight"
    other = next(v for v in data["weight_map"].values() if v != data["weight_map"][name])
    data["weight_map"][name] = other
    with open(index, "w") as f:
        json.dump(data, f)
    with pytest.raises(ValueError, match="lacks"):
        checkpoint.read_weights(path, "mixtral")


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("pooling", ["useModel", "forceCls"])
def test_the_encoder_on_shards_matches_jax(saved, safe, pooling):
    """The port's encoder and the JAX package's (AutoModel's torch branch,
    which reads the shards itself) embed the same texts from BF16 shards
    within ATOL; LlamaTokenizerFast pads on the left."""
    path = saved[safe, torch.bfloat16]
    texts = _texts(8, seed=5) + ["", "中文 café"]
    jax_enc = FlaxTextEncoder(path, pooling)
    want = jax_enc.encode(texts)
    assert jax_enc._flax is None and type(jax_enc._torch).__name__ == "MixtralModel"
    got = hf_encoder.TextEncoder(path, pooling, device=None).encode(texts)
    assert float(np.abs(got - want).max()) <= ATOL


@pytest.mark.parametrize("safe", [True, False])
def test_the_port_writes_shards_transformers_reads(saved, safe, tmp_path):
    """`write_checkpoint(..., shard_bytes=...)`: BF16 shards named and
    indexed as save_pretrained names them (`total_size` their bytes), which
    AutoModel loads with nothing missing or unexpected, and which the port
    reads back bit for bit."""
    c = checkpoint.load_checkpoint(saved[True, torch.bfloat16])
    state = {k: v.to(torch.bfloat16) for k, v in c.state_dict.items()}
    config = {k: v for k, v in c.config.items() if k != "torch_dtype"}
    path = str(tmp_path / "port")
    if safe:
        checkpoint.write_checkpoint(path, config, state, tokenizer_json=c.tokenizer_json,
                                    shard_bytes=50_000)
    else:
        os.makedirs(path)
        checkpoint.write_shards(path, state, 50_000, safetensors=False)
        shutil.copy(os.path.join(saved[True, torch.bfloat16], "config.json"), path)
    stem, ext = ("model", "safetensors") if safe else ("pytorch_model", "bin")
    with open(os.path.join(path, f"{stem}.{ext}.index.json")) as f:
        index = json.load(f)
    files = sorted(set(index["weight_map"].values()))
    assert files == [f"{stem}-{i:05d}-of-{len(files):05d}.{ext}" for i in range(1, len(files) + 1)]
    assert index["metadata"]["total_size"] == sum(2 * v.numel() for v in state.values())
    assert len(files) > 2
    ref, info = transformers.MixtralModel.from_pretrained(path, output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"]
    got = checkpoint.read_weights(path, "mixtral")
    for name, value in ref.state_dict().items():
        assert torch.equal(got[name], value) and torch.equal(got[name], c.state_dict[name]), name


def test_write_safetensors_keeps_bf16(tmp_path):
    """A BF16 tensor is written as BF16 (its 16 bits, not a float32), and
    read back widened exactly."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    checkpoint.write_safetensors(path, {"x": x, "y": x.float()})
    with open(path, "rb") as f:
        header = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    assert header["x"]["dtype"] == "BF16" and header["y"]["dtype"] == "F32"
    assert header["x"]["data_offsets"] == [0, 70]
    back = checkpoint.read_safetensors(path)
    assert np.array_equal(back["x"], x.float().numpy()) and np.array_equal(back["y"], back["x"])


def _two_sets(saved, tmp_path, first, second):
    """A directory holding `first`'s weights (saved[first]) and another
    model's (another seed) as `second` (safetensors or not, dtype, one
    file or an index of shards) beside them."""
    path = str(tmp_path / "both")
    shutil.copytree(saved[first], path)
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        other = _model(json.load(f), 9)
    other_dir = str(tmp_path / "other")
    other.to(second[1]).save_pretrained(
        other_dir, max_shard_size=SHARD if second[2] == "index" else "10GB",
        safe_serialization=second[0])
    for f in os.listdir(other_dir):
        if f != "config.json":
            shutil.copy(os.path.join(other_dir, f), path)
    return path, other.state_dict()


@pytest.mark.parametrize("first, second", [
    # an index of safetensors shards beside model.safetensors
    ((True, torch.float32), (True, torch.float32, "single")),
    # an index of .bin shards beside pytorch_model.bin
    ((False, torch.float32), (False, torch.float32, "single")),
    # an index of safetensors shards beside pytorch_model.bin
    ((True, torch.bfloat16), (False, torch.float32, "single")),
    # an index of safetensors shards beside one of .bin shards
    ((True, torch.bfloat16), (False, torch.float32, "index")),
])
def test_the_weight_file_is_picked_as_automodel_picks_it(saved, tmp_path, first, second):
    """Where a directory holds two sets of weights, the port reads the set
    AutoModel loads (model.safetensors, then model.safetensors.index.json,
    then pytorch_model.bin, then pytorch_model.bin.index.json: a single
    file wins over an index of its own kind), and the two sets differ."""
    path, other = _two_sets(saved, tmp_path, first, second)
    _ref, want = _reference_state(path)
    got = checkpoint.read_weights(path, "mixtral")
    assert all(torch.equal(got[k], v) for k, v in want.items())
    single = second[2] == "single" and (second[0] or not first[0])
    name = "layers.0.block_sparse_moe.gate.weight"
    assert torch.equal(got[name], other[name].float()) == single


def test_a_directory_without_weights_is_refused_by_name(tmp_path):
    with pytest.raises(FileNotFoundError, match="model.safetensors.index.json"):
        checkpoint.read_weights(str(tmp_path))
