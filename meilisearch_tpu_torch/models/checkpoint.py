"""Read (and write) a local BERT checkpoint directory without transformers.

A directory as transformers' `save_pretrained` leaves it:
- `config.json`: the model's widths (models/bert.py::CONFIG_KEYS);
- the weights: `model.safetensors`, parsed here (an 8-byte little-endian
  header length, a JSON header of dtype, shape and `data_offsets` per
  tensor, then the raw little-endian bytes), or else `pytorch_model.bin`
  through `torch.load(weights_only=True)`;
- the tokenizer: `vocab.txt`, one WordPiece token per line, and
  `tokenizer_config.json` (`do_lower_case`, default true; `strip_accents`;
  `tokenize_chinese_chars`; the special tokens).

Checkpoint names map onto `BertModel`'s (`hf_to_state_dict`): a `bert.`
prefix is dropped, so are the pooler, the pre-training heads and the
`position_ids` buffer, and old `LayerNorm.gamma/beta` become
`weight/bias`. `flax_to_state_dict` does the same for a Flax parameter
tree given as numpy arrays (transformers' `FlaxBertModel.params`): a
dense `kernel` (in, out) becomes `weight` (out, in), `scale` and
`embedding` become `weight`.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .bert import BertModel, check_config

# safetensors dtype -> numpy little-endian dtype (BF16 is widened below)
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
    "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}
_DROPPED = ("pooler.", "cls.", "embeddings.position_ids")


@dataclass
class Checkpoint:
    config: dict
    state_dict: dict  # BertModel's names -> float32 CPU tensors
    vocab: list
    tokenizer: dict = field(default_factory=dict)  # tokenizer_config.json


def read_safetensors(path: str) -> dict:
    """name -> numpy array of a `.safetensors` file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":  # the high half of a float32
            half = np.frombuffer(data, "<u2", (end - start) // 2, start)
            arr = (half.astype(np.uint32) << 16).view(np.float32)
        elif meta["dtype"] in _ST_DTYPES:
            dt = np.dtype(_ST_DTYPES[meta["dtype"]])
            arr = np.frombuffer(data, dt, (end - start) // dt.itemsize, start)
        else:
            raise ValueError(f"{path}: tensor `{name}` has dtype {meta['dtype']}")
        out[name] = arr.reshape(shape)
    return out


def hf_to_state_dict(named: dict) -> dict:
    """A checkpoint's tensors (torch or numpy) under BertModel's names, as
    float32 CPU tensors."""
    out = {}
    for name, value in named.items():
        if name.startswith("bert."):
            name = name[len("bert."):]
        if name.startswith(_DROPPED):
            continue
        if name.endswith(".gamma"):
            name = name[: -len("gamma")] + "weight"
        elif name.endswith(".beta"):
            name = name[: -len("beta")] + "bias"
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        out[name] = t.detach().to("cpu", torch.float32).contiguous()
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def flax_to_state_dict(params: dict) -> dict:
    """A Flax BERT parameter tree (numpy leaves) as BertModel's state_dict."""
    named = {}
    for name, value in _flatten(params).items():
        value = np.asarray(value, np.float32)
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            named[f"{stem}.weight"] = value.T
        elif leaf in ("scale", "embedding"):
            named[f"{stem}.weight"] = value
        else:
            named[name] = value
    return hf_to_state_dict(named)


def read_weights(path: str) -> dict:
    """BertModel's state_dict from a checkpoint directory's weights."""
    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        return hf_to_state_dict(read_safetensors(st))
    pt = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(pt):
        return hf_to_state_dict(torch.load(pt, map_location="cpu", weights_only=True))
    raise FileNotFoundError(
        f"`{path}` holds neither model.safetensors nor pytorch_model.bin"
    )


def load_checkpoint(path: str) -> Checkpoint:
    """Read a local checkpoint directory (no download: a hub name that is
    not a directory raises)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"`{path}` is not a local checkpoint directory (the model is read"
            " from disk; nothing is downloaded)"
        )
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    check_config(config)
    state = read_weights(path)
    with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
        vocab = [line.rstrip("\n") for line in f]
    tok_path = os.path.join(path, "tokenizer_config.json")
    tokenizer = {}
    if os.path.exists(tok_path):
        with open(tok_path) as f:
            tokenizer = json.load(f)
    return Checkpoint(config, state, vocab, tokenizer)


def build_model(ckpt: Checkpoint) -> BertModel:
    """A BertModel holding the checkpoint's weights (every parameter must
    be present), on the CPU, in eval mode."""
    model = BertModel(ckpt.config)
    model.load_state_dict(ckpt.state_dict, strict=True)
    return model.eval()


def write_checkpoint(path: str, config: dict, state_dict: dict, vocab: list,
                     do_lower_case: bool = True) -> None:
    """Write a directory `load_checkpoint` reads: config.json,
    pytorch_model.bin (BertModel's names), vocab.txt and
    tokenizer_config.json."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "bert", "hidden_act": "gelu", **config}, f)
    torch.save(state_dict, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(f"{token}\n" for token in vocab))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": do_lower_case, "tokenizer_class": "BertTokenizer"}, f)
