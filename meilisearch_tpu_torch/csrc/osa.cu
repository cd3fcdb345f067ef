// K3: the optimal-string-alignment distance from one query word to every
// word of the vocabulary, for Hopper.
//
// Replaces: meilisearch_tpu/ops/device_osa.py::osa_device (a jitted XLA
// program; no Pallas kernel). It computes the same function: for every
// vocabulary row w (MAX_LEN = 32 int32 codepoints, 0-padded, length
// lens[w], 0 = padding row) the restricted Damerau (OSA) DP against the
// query's first m codepoints, then
//   full[w]   = D[m][lens[w]]                  (9999 on a padding row)
//   prefix[w] = min(min_{1<=j<=lens[w]} D[m][j], full[w]), and min(., m)
//               when m <= max_dist (the empty prefix),
// both clipped to max_dist + 1 and stored as int8.
//
// What bounds it on this card: integer operations. The DP costs about 8
// integer operations per cell (two compares, adds and mins, and the
// transposition test) over m * lens[w] cells, some 600 per word for a
// 10-letter query and an 8-letter word, against at most the 128 bytes of
// its row (at most ~138 MB for the whole call at n = 2^20: 128 MiB of
// matrix, 4 MiB of lengths, 2 MiB of output, so ~0.04 ms at 3.35 TB/s).
// The function itself needs less: only the cells with |i - j| <=
// max_dist + 1 can reach the clipped outputs, and only the sectors that
// hold letters need reading; chip_smoke.py::k3_bound_ms counts that
// floor, which this kernel, computing every cell, does not reach.
//
// What the design does about it: one thread per vocabulary word, the DP
// rows (three of 33 cells) and the word's codepoints in registers (the
// j loops are unrolled, so every index is a constant), the query in
// shared memory. The XLA program ran every step over all 32 columns and
// all 32 query positions with a prefix-min trick; here the row recurrence
// is the plain cur[j] = min(best[j], cur[j-1] + 1), the i loop stops at m
// and every j loop at the word's length, so a cell beyond either costs
// nothing. Columns past the length never feed a column at or below it, so
// the results are exact. The word is loaded straight from device memory
// as 16-byte vectors, and only the vectors that hold characters below its
// length: a row is one 128-byte line, so a short word reads one or two
// 32-byte sectors of it. Staging a block's rows through shared memory
// would read every sector; the vector loads are already coalesced per
// sector, so nothing is gained by the staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 32;
constexpr int kBig = 127;        // levenshtein.INF
constexpr int kPadding = 9999;   // full distance of a padding row

__global__ void osa_kernel(const int4* __restrict__ mat,
                           const int32_t* __restrict__ lens,
                           const int32_t* __restrict__ query, int m,
                           int max_dist, int n, int8_t* __restrict__ full_out,
                           int8_t* __restrict__ prefix_out) {
  __shared__ int q[kMaxLen];
  if (threadIdx.x < kMaxLen) q[threadIdx.x] = query[threadIdx.x];
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n) return;
  const int len = lens[w];

  int c[kMaxLen];
  const int4* row = mat + (size_t)w * (kMaxLen / 4);
#pragma unroll
  for (int k = 0; k < kMaxLen / 4; ++k) {
    int4 v = make_int4(0, 0, 0, 0);
    if (4 * k < len) v = __ldg(row + k);
    c[4 * k] = v.x;
    c[4 * k + 1] = v.y;
    c[4 * k + 2] = v.z;
    c[4 * k + 3] = v.w;
  }

  // prev: row i of the DP (row 0: D[0][j] = j), prev2: row i - 1
  int prev[kMaxLen + 1], prev2[kMaxLen + 1];
#pragma unroll
  for (int j = 0; j <= kMaxLen; ++j) {
    prev[j] = j;
    prev2[j] = 0;
  }
#pragma unroll 1
  for (int i = 0; i < m; ++i) {
    const int qc = q[i];
    const int qp = q[i > 0 ? i - 1 : 0];
    int cur[kMaxLen + 1];
    cur[0] = i + 1;
#pragma unroll
    for (int j = 1; j <= kMaxLen; ++j) {
      if (j > len) break;
      // deletion from the query, substitution
      int best = min(prev[j] + 1, prev[j - 1] + (c[j - 1] != qc ? 1 : 0));
      // transposition: q[i-1] == w[j-1] and q[i] == w[j-2]
      if (j >= 2 && i >= 1 && c[j - 1] == qp && c[j - 2] == qc)
        best = min(best, prev2[j - 2] + 1);
      // insertion into the query
      cur[j] = min(best, cur[j - 1] + 1);
    }
#pragma unroll
    for (int j = 0; j <= kMaxLen; ++j) {
      if (j > len) break;
      prev2[j] = prev[j];
      prev[j] = cur[j];
    }
  }

  int full = len == 0 ? kPadding : kBig;
  int prefix = kBig;
#pragma unroll
  for (int j = 1; j <= kMaxLen; ++j) {
    if (j > len) break;
    prefix = min(prefix, prev[j]);
    if (j == len) full = prev[j];
  }
  prefix = min(prefix, full);
  if (m <= max_dist) prefix = min(prefix, m);
  const int cap = max_dist + 1;
  full_out[w] = (int8_t)min(full, cap);
  prefix_out[w] = (int8_t)min(prefix, cap);
}

}  // namespace

// Plain C entry point (bound with ctypes): `mat` is (n, 32) int32 with
// 16-byte aligned rows, `lens` (n,) int32, `query` (32,) int32, outputs
// (n,) int8. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mst_osa(const void* mat, const void* lens, const void* query, int m,
                       int max_dist, int n, void* full, void* prefix, int block,
                       void* stream) {
  if (n <= 0 || m < 0 || m > kMaxLen || max_dist < 0 || block < kMaxLen ||
      block > 1024 || block % 32 != 0 || (reinterpret_cast<uintptr_t>(mat) & 15))
    return (int)cudaErrorInvalidValue;
  const int grid = (n + block - 1) / block;
  osa_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(mat), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(query), m, max_dist, n,
      static_cast<int8_t*>(full), static_cast<int8_t*>(prefix));
  return (int)cudaGetLastError();
}
