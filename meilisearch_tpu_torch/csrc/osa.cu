// K3: the optimal-string-alignment distance from one query word to every
// word of the vocabulary, for Hopper.
//
// Replaces: meilisearch_tpu/ops/device_osa.py::osa_device (a jitted XLA
// program; no Pallas kernel). It computes the same function: for every
// vocabulary row w (MAX_LEN = 32 int32 codepoints, 0-padded, length
// lens[w], 0 = padding row) the restricted Damerau (OSA) distance table D
// against the query's first m codepoints, then
//   full[w]   = D[m][lens[w]]                  (9999 on a padding row)
//   prefix[w] = min(min_{1<=j<=lens[w]} D[m][j], full[w]), and min(., m)
//               when m <= max_dist (the empty prefix),
// both clipped to max_dist + 1 and stored as int8.
//
// What bounds it on this card: bytes. Per word the function needs its
// length, the 32-byte sectors that hold the letters it must read (below),
// and its two output bytes; per letter read, the recurrence and the score
// below take 19 integer instructions in the sm_90a SASS (the match-mask
// lookup and the loop test not counted). chip_smoke.py::k3_bound_ms
// counts both, and at the typo path's word lengths the bytes take longer.
//
// What the design does about it:
// - Bit-parallel columns (Hyyro, "A bit-vector algorithm for computing
//   Levenshtein and Damerau edit distances", Nordic J. Computing 10, 2003,
//   global form). The query is the pattern, one bit per query position
//   (m <= 32 fits one 32-bit word). A thread walks its word letter by
//   letter and keeps the column of D as vertical deltas VP/VN, plus the
//   previous letter's diagonal-zero vector and match mask for the
//   transposition term: a constant number of word operations per letter,
//   whatever m is, and a few registers of state instead of DP rows.
//   Row 0 shifts a +1 horizontal delta in (D[0][j] = j), and a running
//   score at bit m - 1 gives D[m][j] column by column: `prefix` is its
//   running minimum (from D[m][0] = m, which is the empty-prefix rule
//   once clipped), `full` its value at j = lens[w].
// - The query's match masks come from a collision-free multiply-shift
//   hash table built on the host (ops/device_osa.py::query_table) and
//   passed by value; each block stages it in shared memory, so a letter
//   costs one hash, one load and one compare.
// - Exact cuts by length: D[m][j] >= |m - j|. Columns past m + max_dist
//   are at or above the clip, so a thread reads and processes only the
//   letters j < min(len, m + max_dist), and `full` is the clip for a
//   longer word. A word shorter than m - max_dist reads no letter: both
//   outputs are the clip. Only the 16-byte vectors that hold needed
//   letters are loaded, all before the recurrence starts.
// - Warps ordered by length: thread t takes word order[t], the row ids
//   sorted by length once per uploaded vocabulary, so the lanes of a warp
//   stop together; outputs go to the word's own row, in vocabulary order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 32;
constexpr int kSlotBits = 7;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kBlock = 256;

// The query as a kernel parameter (1,036 bytes). key[s] is the codepoint
// in slot s (-1 = empty), mask[s] its position mask (bit i set where
// query[i] == key[s]); a codepoint c lives in slot (c * mult) >> 25.
struct OsaQuery {
  int32_t key[kSlots];
  uint32_t mask[kSlots];
  uint32_t mult;
  int32_t m;
  int32_t max_dist;
};

__device__ __forceinline__ int letter(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kBlock)
    osa_kernel(const int4* __restrict__ mat, const int32_t* __restrict__ lens,
               const int32_t* __restrict__ order, const __grid_constant__ OsaQuery q,
               int n, int8_t* __restrict__ full_out, int8_t* __restrict__ prefix_out) {
  __shared__ int2 table[kSlots];
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x)
    table[s] = make_int2(q.key[s], (int)q.mask[s]);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int w = order[t];
  if ((unsigned)w >= (unsigned)n) return;  // not a row id: read and write nothing
  const int len = lens[w];
  const int m = q.m, cap = q.max_dist + 1;
  int full, best;
  if (m == 0) {
    full = len == 0 ? cap : min(len, cap);
    best = 0;
  } else {
    const int cut = len < m - q.max_dist ? 0 : min(len, m + q.max_dist);
    int4 v[kMaxLen / 4];
    const int4* row = mat + (size_t)w * (kMaxLen / 4);
#pragma unroll
    for (int k = 0; k < kMaxLen / 4; ++k)
      v[k] = 4 * k < cut ? __ldg(row + k) : make_int4(0, 0, 0, 0);
    const int sh = m - 1;
    uint32_t vp = ~0u, vn = 0u, d0 = 0u, pm_prev = 0u;
    int score = m;
    best = m;
#pragma unroll
    for (int j = 0; j < kMaxLen; ++j) {
      if (j >= cut) break;
      const int c = letter(v[j / 4], j % 4);
      const int2 e = table[((uint32_t)c * q.mult) >> (32 - kSlotBits)];
      const uint32_t pm = e.x == c ? (uint32_t)e.y : 0u;
      // transposition into bit i: query[i-1] == word[j] (pm, shifted up)
      // and query[i] == word[j-1] (pm_prev), where the previous letter's
      // diagonal step into bit i - 1 was +1 (~d0)
      const uint32_t tr = ((~d0 & pm) << 1) & pm_prev;
      d0 = (((pm & vp) + vp) ^ vp) | pm | vn | tr;
      uint32_t hp = vn | ~(d0 | vp);
      uint32_t hn = vp & d0;
      score += (int)((hp >> sh) & 1u) - (int)((hn >> sh) & 1u);
      best = min(best, score);
      hp = (hp << 1) | 1u;  // row 0: D[0][j] - D[0][j-1] = +1
      hn <<= 1;
      vp = hn | ~(d0 | hp);
      vn = hp & d0;
      pm_prev = pm;
    }
    full = len == 0 || cut < len ? cap : score;
  }
  full_out[w] = (int8_t)min(full, cap);
  prefix_out[w] = (int8_t)min(best, cap);
}

}  // namespace

// Plain C entry point (bound with ctypes): `mat` is (n, 32) int32 with
// 16-byte aligned rows, `lens` (n,) int32, `order` (n,) int32 a
// permutation of 0..n-1 (ops/device_osa.py::DeviceVocab.order; it is not
// checked: a row id out of range is skipped, and the rows it would have
// named keep whatever their outputs held), `query` a host pointer to the
// OsaQuery parameter, outputs (n,) int8. Launches on `stream` and does
// not synchronise. Returns the cudaError_t of the launch (0 = success).
extern "C" int mst_osa(const void* mat, const void* lens, const void* order,
                       const void* query, int n, void* full, void* prefix,
                       void* stream) {
  const OsaQuery& q = *static_cast<const OsaQuery*>(query);
  if (n <= 0 || q.m < 0 || q.m > kMaxLen || q.max_dist < 0 ||
      (reinterpret_cast<uintptr_t>(mat) & 15))
    return (int)cudaErrorInvalidValue;
  const int grid = (n + kBlock - 1) / kBlock;
  osa_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(mat), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(order), q, n, static_cast<int8_t*>(full),
      static_cast<int8_t*>(prefix));
  return (int)cudaGetLastError();
}
