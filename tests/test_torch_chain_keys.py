"""K1 parity: the port's chain-DP keys against the JAX package.

`chain_keys` on CPU tensors runs its plain torch version; it must equal
the Pallas kernel (interpret mode) and the XLA reference path bit for bit
(keys, candidate bitmap, counts). `tile_walk` recomputes K1's output the
way `csrc/chain_keys.cu` walks it — thread w, lanes j < 32, pool word
(j % 8)*(D/32) + w — so a layout fault in that mapping shows here without
a GPU. The kernel itself is compared on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from meilisearch_tpu.ops.arena_scorer import _planes_chain_topk_xla
from meilisearch_tpu.ops.pallas_scorer import pallas_chain_keys
from meilisearch_tpu.search.device_batch import T_LADDER
from meilisearch_tpu_torch.ops import _build
from meilisearch_tpu_torch.ops import chain_keys as ck
from meilisearch_tpu_torch.ops.arena_host import INVALID_KEY, _key_layout
from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs

B = 4


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    w = words.astype(np.int64) & 0xFFFFFFFF
    return ((w[..., None] >> np.arange(32)) & 1).sum(axis=(-1, -2)).astype(np.int32)


def _byte(word, shift):
    return (word >> shift) & 0xFF


def tile_walk(byte_pool, rows, adj, mand, use_valid, universe, live, T):
    """K1 as the .cu computes it: per query b, every thread w at once
    (vectorized over w), looping jm over the 8 pool words a thread reads
    and the 4 byte lanes of each, with the DP of `chain_key`."""
    sh_ea, sh_ps, sh_fd, sh_px, sh_ty, sh_w, total = _key_layout(T)
    BIG = 1 << total
    tp = max(T - 1, 1)
    nb, nr = rows.shape
    w32 = byte_pool.shape[1] // 8
    pool = byte_pool.numpy().astype(np.int64) & 0xFFFFFFFF
    keys = np.empty((nb, 32 * w32), np.int64)
    candw = np.zeros((nb, w32), np.int64)
    for b in range(nb):
        aj = adj[b].tolist()
        md = mand[b].tolist()
        valid = live.numpy().astype(np.int64) & 0xFFFFFFFF
        if use_valid[b]:
            valid = valid & (universe[b].numpy().astype(np.int64) & 0xFFFFFFFF)
        for jm in range(8):
            words = [
                pool[int(rows[b, r]), jm * w32 : (jm + 1) * w32] for r in range(nr)
            ]
            for lane in range(4):
                j = lane * 8 + jm
                sh = 8 * lane
                s = [np.full(w32, BIG), np.full(w32, BIG), np.full(w32, BIG),
                     np.zeros(w32, np.int64)]
                for t in range(T):
                    p = [_byte(words[t * 3 + c], sh) for c in range(3)]
                    exact_add = np.where((p[0] >= 0x80) & (p[0] != 0xFF), 0, 1)
                    pr = [
                        _byte(words[3 * T + (t - 1) * 3 + c], sh)
                        if t > 0 and aj[t - 1] else np.zeros(w32, np.int64)
                        for c in range(3)
                    ]
                    ns = []
                    for cls in range(3):
                        base = ((cls << sh_ty) + (((p[cls] >> 4) & 7) << sh_fd)
                                + (np.minimum(p[cls] & 15, 10) << sh_ps) + exact_add)
                        if t == 0:
                            best = s[3] + base
                        else:
                            best = np.minimum.reduce([
                                s[prev] + base + (((pr[prev] >> (2 * cls)) & 3) << sh_px)
                                for prev in range(3)
                            ])
                            if md[t]:
                                best = np.minimum(best, s[3] + base)
                        ns.append(np.where(p[cls] != 0xFF, np.minimum(best, BIG), BIG))
                    skip = np.minimum(np.minimum.reduce(s) + (1 << sh_w), BIG)
                    s = ns + [np.full(w32, BIG) if md[t] else skip]
                key = np.minimum.reduce(s)
                level = np.clip(T - (key >> sh_w), 0, T)
                ea = np.zeros(w32, np.int64)
                for lvl in range(T + 1):
                    r = _byte(words[3 * T + 3 * tp + lvl], sh)
                    ea = np.where(level == lvl, np.where(r >= 0x80, 2, r), ea)
                ok = (key < BIG) & (((valid >> j) & 1) == 1)
                out = np.where(ok, key | (ea << sh_ea), INVALID_KEY)
                keys[b, j * w32 : (j + 1) * w32] = out
                candw[b] |= ok.astype(np.int64) << j
    candw = np.where(candw >= 1 << 31, candw - (1 << 32), candw)
    return keys.astype(np.int32), candw.astype(np.int32), _popcount_rows(candw)


@pytest.mark.parametrize("T,seed", [(3, 7), (6, 11)])
def test_plain_matches_pallas_interpret(T, seed):
    D = 1 << 14
    args = kernel_args(scorer_inputs(T, D, B, seed))
    keys_p, candw_p = pallas_chain_keys(
        *[a.numpy() for a in args], T=T, D=D, interpret=True
    )
    keys, candw, counts = ck.chain_keys(*args, T=T)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(keys_p))
    np.testing.assert_array_equal(candw.numpy(), np.asarray(candw_p))
    np.testing.assert_array_equal(
        counts.numpy(), _popcount_rows(np.asarray(candw_p))
    )


@pytest.mark.parametrize("D", [1024, 1 << 14])
@pytest.mark.parametrize("T", T_LADDER)
def test_plain_matches_xla_reference(T, D):
    inputs = scorer_inputs(T, D, B, seed=100 + T)
    # k = D: the selection returns every doc, so (idx1, key1) spells out
    # the reference's full key row
    out, candw_x, _ = _planes_chain_topk_xla(
        *inputs, np.zeros(4, np.int32), T=T, D=D, k=D
    )
    out = np.asarray(out)
    keys_x = np.empty((B, D), np.int32)
    for b in range(B):
        keys_x[b, out[b, :D]] = out[b, D : 2 * D]
    keys, candw, counts = ck.chain_keys(*kernel_args(inputs), T=T)
    np.testing.assert_array_equal(keys.numpy(), keys_x)
    np.testing.assert_array_equal(candw.numpy(), np.asarray(candw_x))
    np.testing.assert_array_equal(counts.numpy(), out[:, 4 * D])


@pytest.mark.parametrize("T,D", [(t, 1024) for t in T_LADDER] + [(4, 1 << 13)])
def test_tile_walk_matches_plain(T, D):
    args = kernel_args(scorer_inputs(T, D, B, seed=200 + T))
    walked = tile_walk(*args, T=T)
    plain = ck.chain_keys_torch(*args, T=T)
    for w, p in zip(walked, plain):
        np.testing.assert_array_equal(w, p.numpy())


def test_wrapper_rejects_bad_inputs():
    args = list(kernel_args(scorer_inputs(2, 1024, B, seed=1)))
    with pytest.raises(TypeError):
        ck.chain_keys(*[args[0].long()] + args[1:], T=2)
    with pytest.raises(ValueError):
        ck.chain_keys(*args, T=3)  # rows are shaped for T=2
    with pytest.raises(ValueError):
        ck.chain_keys(*[args[0][:, :100].contiguous()] + args[1:], T=2)
    with pytest.raises(ValueError):
        ck.chain_keys(*args[:5] + [args[5].t()] + args[6:], T=2)


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version: anything else launches
    the kernel or raises."""

    def fell_back(*a, **k):
        raise AssertionError("the plain version stood in for the kernel")

    monkeypatch.setattr(ck, "chain_keys_torch", fell_back)
    args = [a.to("meta") for a in kernel_args(scorer_inputs(1, 1024, B, seed=2))]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ck.chain_keys(*args, T=1)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_failure", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
    # the failure stands for the rest of the process
    with pytest.raises(RuntimeError, match="failed to build"):
        _build.load_library()
    # a compiler that fails
    monkeypatch.setattr(_build, "_failure", None)
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_library()
    assert _build._lib is None


def test_refused_launch_raises():
    ck.check_launch(0)
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        ck.check_launch(9)  # cudaErrorInvalidConfiguration
