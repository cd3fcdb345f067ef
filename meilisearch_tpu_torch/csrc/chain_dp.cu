// K6: the fused lexicographic chain DP over a query's candidate axis, for Hopper.
//
// Replaces: meilisearch_tpu/ops/device_scorer.py::chain_cost_matrix (:56)
// and ::chain_query_topk (:111), jitted XLA programs. For every candidate
// column n it runs the `last`-strategy DP over T <= 16 terms with 4 states
// (3 typo classes and the skip state, START in the skip slot before term
// 0), each a 6-dimension int32 cost (words, typo, proximity, fid,
// position, exactness) combined by the lexicographic min `_lexmin`. Two
// modes (template parameter):
// - cost: writes the final (6, N) costs after min(., INF);
// - keys: applies `valid`, clips and packs the costs into the three int32
//   sort keys of device_scorer.py:186-204 (key_hi, key_lo, key_lo2). The
//   sort that follows is torch's (ops/device_scorer.py::sort3).
// The arithmetic is the reference's, bit for bit: plain int32 adds (a
// column's sums stay below 16 * 3 * 2^24 < 2^30 for T <= 16 and inputs
// <= INF, so nothing wraps), int8 pair costs, no skip at t = 0, visits
// from START only at t = 0 and from the 3 classes after, the skip state
// from all 4, and `_lexmin(a, b)` keeping b unless a is strictly less.
//
// What bounds it on this card: at T = 4 a column reads 12 mask bytes, 27
// pair bytes, 96 bytes of fid and position costs and 16 of exactness and
// writes 24 bytes (cost mode): about 175 bytes, so 92 MB at N = 2^19, or
// 0.027 ms at 3.35 TB/s. The DP does about 250 int32 operations a column
// per term (9 visit candidates of 6 adds, 6 + 3 lexicographic mins of 6
// compares, 6 equalities and 6 selects): about 0.031 ms at N = 2^19 on
// 16.7 Tops/s of int32. chip_smoke.py recomputes both from its inputs.
//
// What the design does about it: one thread per column, in a grid-stride
// loop, the 4 x 6 state in registers and the t-loop inside the thread.
// Every input is (..., N), contiguous along N, so neighbouring threads
// read neighbouring bytes and every load and store is coalesced. No
// shared memory: a column's terms are read once each and never shared.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 24;
constexpr int kDims = 6;
constexpr int kMaxTerms = 16;
constexpr int kInvalidHi = 1 << 30;
constexpr int kBlock = 256;
constexpr int kMaxGrid = 65535;

struct Cost {
  int d[kDims];
};

__device__ __forceinline__ Cost add(const Cost& s, int w, int ty, int px, int fd, int ps,
                                    int ex) {
  return Cost{{s.d[0] + w, s.d[1] + ty, s.d[2] + px, s.d[3] + fd, s.d[4] + ps, s.d[5] + ex}};
}

__device__ __forceinline__ Cost all(int v) { return Cost{{v, v, v, v, v, v}}; }

// best = _lexmin(best, cand): best stays only when strictly less
__device__ __forceinline__ void lexmin_into(Cost& best, const Cost& cand) {
  bool lt = false, eq = true;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    lt = lt | (eq & (best.d[d] < cand.d[d]));
    eq = eq & (best.d[d] == cand.d[d]);
  }
#pragma unroll
  for (int d = 0; d < kDims; ++d) best.d[d] = lt ? best.d[d] : cand.d[d];
}

__device__ __forceinline__ int clip(int v, int hi) { return min(max(v, 0), hi); }

template <bool kKeys>
__global__ void __launch_bounds__(kBlock)
    chain_dp_kernel(const uint8_t* __restrict__ class_mask, const int8_t* __restrict__ pair,
                    const int32_t* __restrict__ fid, const int32_t* __restrict__ pos,
                    const void* __restrict__ exact, const int32_t* __restrict__ docids,
                    const uint8_t* __restrict__ valid, int32_t* __restrict__ out0,
                    int32_t* __restrict__ out1, int32_t* __restrict__ out2, int T, int N) {
  const int64_t cols = N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < cols; n += stride) {
    Cost s[4] = {all(kInf), all(kInf), all(kInf), all(0)};
    for (int t = 0; t < T; ++t) {
      const int64_t tn = (int64_t)t * cols + n;
      int ex;
      if constexpr (kKeys) {
        ex = static_cast<const uint8_t*>(exact)[tn] ? 0 : 1;
      } else {
        ex = static_cast<const int32_t*>(exact)[tn];
      }
      Cost next[4];
#pragma unroll
      for (int cls = 0; cls < 3; ++cls) {
        const int64_t at = ((int64_t)t * 3 + cls) * cols + n;
        const int w = class_mask[at] ? 0 : kInf;
        const int fd = fid[at], ps = pos[at];
        if (t == 0) {
          next[cls] = add(s[3], w, cls, 0, fd, ps, ex);
        } else {
#pragma unroll
          for (int prev = 0; prev < 3; ++prev) {
            const int px = pair[(((int64_t)(t - 1) * 3 + prev) * 3 + cls) * cols + n];
            const Cost cand = add(s[prev], w, cls, px, fd, ps, ex);
            if (prev == 0) {
              next[cls] = cand;
            } else {
              lexmin_into(next[cls], cand);
            }
          }
        }
      }
      if (t == 0) {
        next[3] = all(kInf);  // the first term is never skipped
      } else {
        next[3] = add(s[0], 1, 0, 0, 0, 0, 0);
#pragma unroll
        for (int prev = 1; prev < 4; ++prev) lexmin_into(next[3], add(s[prev], 1, 0, 0, 0, 0, 0));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = next[i];
    }
    Cost f = s[0], g = s[2];
    lexmin_into(f, s[1]);
    lexmin_into(g, s[3]);
    lexmin_into(f, g);
#pragma unroll
    for (int d = 0; d < kDims; ++d) f.d[d] = min(f.d[d], kInf);
    if constexpr (!kKeys) {
#pragma unroll
      for (int d = 0; d < kDims; ++d) out0[(int64_t)d * cols + n] = f.d[d];
    } else {
      if (!valid[n]) f = all(kInf);
      const int w = clip(f.d[0], 63), ty = clip(f.d[1], 127), px = clip(f.d[2], 511);
      const int fd = clip(f.d[3], (1 << 20) - 1), ps = clip(f.d[4], (1 << 16) - 1);
      const int ex = clip(f.d[5], (1 << 10) - 1);
      const int hi = f.d[0] >= kInf ? kInvalidHi : (w << 23) | (ty << 16) | (px << 7) | (fd >> 13);
      out0[n] = hi;
      out1[n] = ((fd & ((1 << 13) - 1)) << 18) | (ps << 2) | (ex >> 8);
      out2[n] = ((ex & 255) << 23) | clip(docids[n], (1 << 23) - 1);
    }
  }
}

}  // namespace

// mode 0 (cost): exact is (T, N) int32, out0 is (6, N) int32; docids,
// valid, out1 and out2 are not read. mode 1 (keys): exact is (T, N) bool,
// out0..out2 are key_hi, key_lo, key_lo2, (N,) int32 each. pair has at
// least T - 1 rows of (3, 3, N) int8. Returns the launch's cudaError_t.
extern "C" int mst_chain_dp(const void* class_mask, const void* pair, const void* fid,
                            const void* pos, const void* exact, const void* docids,
                            const void* valid, void* out0, void* out1, void* out2, int T,
                            int N, int mode, void* stream) {
  if (T < 1 || T > kMaxTerms || N < 1 || (mode != 0 && mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == 1 && (docids == nullptr || valid == nullptr || out1 == nullptr || out2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = ((int64_t)N + kBlock - 1) / kBlock;
  const dim3 grid((unsigned)(blocks < kMaxGrid ? blocks : kMaxGrid));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* cm = static_cast<const uint8_t*>(class_mask);
  const auto* pc = static_cast<const int8_t*>(pair);
  const auto* fd = static_cast<const int32_t*>(fid);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* ids = static_cast<const int32_t*>(docids);
  const auto* va = static_cast<const uint8_t*>(valid);
  auto* o0 = static_cast<int32_t*>(out0);
  auto* o1 = static_cast<int32_t*>(out1);
  auto* o2 = static_cast<int32_t*>(out2);
  if (mode == 0) {
    chain_dp_kernel<false><<<grid, kBlock, 0, s>>>(cm, pc, fd, ps, exact, ids, va, o0, o1, o2, T, N);
  } else {
    chain_dp_kernel<true><<<grid, kBlock, 0, s>>>(cm, pc, fd, ps, exact, ids, va, o0, o1, o2, T, N);
  }
  return (int)cudaGetLastError();
}
