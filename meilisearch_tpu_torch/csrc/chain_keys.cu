// K1: the packed-key chain DP over the resident plane pool, for Hopper.
//
// Replaces: meilisearch_tpu/ops/pallas_scorer.py::pallas_chain_keys (the
// Pallas kernel body _kernel_body). It computes the same function: for
// every (query b, document n) it unpacks n's byte from the query's term,
// pair and ExactAttribute rows of the lane-blocked int32 pool, runs the
// `last`-strategy suffix DP over 4 states on one packed int32 key
// (layout: arena_scorer._key_layout), folds in the ExactAttribute rank of
// the final words level, applies the live bitmap and the query's filter
// universe, and writes INVALID_KEY (1 << 30) for dead or filtered docs.
// It also writes the bit-blocked candidate bitmap and the per-query
// candidate count.
//
// What bounds it on this card: bytes. A query streams its NR pool rows
// (NR = 3T + 3max(T-1,1) + T+1 rows of D bytes each) and writes 4*D bytes
// of keys; the DP is a few dozen integer ops per byte read.
//
// What the design does about it: one thread owns bitmap word w of query b
// and handles the 32 documents n = j*(D/32) + w, j < 32. Document n lives
// in pool word (j % 8)*(D/32) + w at byte lane j / 8 (pack_plane's
// lane-blocked layout), so neighbouring threads read neighbouring words
// and every load and key store is coalesced. Each pool word is loaded
// once and serves four documents. The thread alone writes candw[b, w], so
// the bitmap needs no atomics; the count is a warp reduction of __popc
// and one atomicAdd per block. Nothing is staged through shared memory in
// this first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInvalidKey = 1 << 30;

__host__ __device__ constexpr int bit_length(int x) {
  return x ? 1 + bit_length(x >> 1) : 0;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// arena_scorer._key_layout(T)
template <int T>
struct KeyLayout {
  static constexpr int ex_b = bit_length(T + 1);
  static constexpr int ps_b = bit_length(10 * T + 1);
  static constexpr int fd_b = bit_length(7 * T + 1);
  static constexpr int px_b = cmax(bit_length(3 * (T - 1) + 1), 1);
  static constexpr int ty_b = bit_length(2 * T + 1);
  static constexpr int w_b = bit_length(T + 1);
  static constexpr int sh_ea = ex_b;
  static constexpr int sh_ps = sh_ea + 2;
  static constexpr int sh_fd = sh_ps + ps_b;
  static constexpr int sh_px = sh_fd + fd_b;
  static constexpr int sh_ty = sh_px + px_b;
  static constexpr int sh_w = sh_ty + ty_b;
  static constexpr int total = sh_w + w_b;
  static_assert(total <= 29, "packed key exceeds 29 bits");
};

__device__ __forceinline__ int byte_at(uint32_t word, int shift) {
  return (int)((word >> shift) & 0xFFu);
}

// The DP for one document whose bytes sit at `shift` in words[NR].
// Rows: [0, 3T) term rows (t*3 + class), [3T, 3T + 3TP) pair rows
// ((t-1)*3 + left class), then T+1 ExactAttribute rows by words level.
template <int T>
__device__ __forceinline__ int chain_key(const uint32_t* words, int shift,
                                         const int* aj, const int* md) {
  using L = KeyLayout<T>;
  constexpr int TP = T > 1 ? T - 1 : 1;
  constexpr int BIG = 1 << L::total;
  int s0 = BIG, s1 = BIG, s2 = BIG, s3 = 0;  // visit classes 0-2, skip
#pragma unroll
  for (int t = 0; t < T; ++t) {
    int p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p[c] = byte_at(words[t * 3 + c], shift);
    // raw bytes: 0xFF is the absence sentinel, bit 7 the exact flag
    const int exact_add = (p[0] >= 0x80 && p[0] != 0xFF) ? 0 : 1;
    int pr[3] = {0, 0, 0};
    if (t > 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        pr[c] = aj[t - 1] ? byte_at(words[3 * T + (t - 1) * 3 + c], shift) : 0;
    }
    int ns[3];
#pragma unroll
    for (int cls = 0; cls < 3; ++cls) {
      const int base = (cls << L::sh_ty) + (((p[cls] >> 4) & 7) << L::sh_fd) +
                       (min(p[cls] & 15, 10) << L::sh_ps) + exact_add;
      int best;
      if (t == 0) {
        best = s3 + base;
      } else {
        // a non-adjacent edge is free: pr[] is 0 there
        best = s0 + base + (((pr[0] >> (2 * cls)) & 3) << L::sh_px);
        best = min(best, s1 + base + (((pr[1] >> (2 * cls)) & 3) << L::sh_px));
        best = min(best, s2 + base + (((pr[2] >> (2 * cls)) & 3) << L::sh_px));
        // a mandatory term may also be entered from the skip state
        if (md[t]) best = min(best, s3 + base);
      }
      ns[cls] = p[cls] != 0xFF ? min(best, BIG) : BIG;
    }
    const int skip =
        md[t] ? BIG : min(min(min(s0, s1), min(s2, s3)) + (1 << L::sh_w), BIG);
    s0 = ns[0];
    s1 = ns[1];
    s2 = ns[2];
    s3 = skip;
  }
  int key = min(min(s0, s1), min(s2, s3));
  if (key >= BIG) return kInvalidKey;  // no valid interpretation
  const int level = min(max(T - (key >> L::sh_w), 0), T);
  int ea = 0;
#pragma unroll
  for (int lvl = 0; lvl <= T; ++lvl) {
    const int r = byte_at(words[3 * T + 3 * TP + lvl], shift);
    if (lvl == level) ea = r >= 0x80 ? 2 : r;
  }
  return key | (ea << L::sh_ea);
}

template <int T>
__global__ void chain_keys_kernel(const int32_t* __restrict__ pool,
                                  const int32_t* __restrict__ rows,
                                  const int32_t* __restrict__ adj,
                                  const int32_t* __restrict__ mand,
                                  const int32_t* __restrict__ use_valid,
                                  const int32_t* __restrict__ universe,
                                  const int32_t* __restrict__ live,
                                  int32_t* __restrict__ keys,
                                  int32_t* __restrict__ candw,
                                  int32_t* __restrict__ counts, int w32) {
  constexpr int TP = T > 1 ? T - 1 : 1;
  constexpr int NR = 3 * T + 3 * TP + T + 1;
  const int b = blockIdx.y;
  const int w = blockIdx.x * blockDim.x + threadIdx.x;  // blockDim | w32
  const uint32_t d4 = (uint32_t)w32 * 8;

  // word offsets into the pool; the caller checks the pool holds < 2^31
  // words, so they fit 32 bits
  uint32_t row_off[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) row_off[r] = (uint32_t)rows[b * NR + r] * d4 + w;
  int aj[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) aj[i] = adj[b * TP + i];
  int md[T];
#pragma unroll
  for (int t = 0; t < T; ++t) md[t] = mand[b * T + t];

  uint32_t valid = (uint32_t)live[w];
  if (use_valid[b]) valid &= (uint32_t)universe[(size_t)b * w32 + w];

  int32_t* out = keys + (size_t)b * w32 * 32 + w;
  uint32_t cand = 0;
#pragma unroll 1
  for (int jm = 0; jm < 8; ++jm) {
    uint32_t words[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      words[r] = (uint32_t)__ldg(pool + (row_off[r] + (uint32_t)(jm * w32)));
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const int j = lane * 8 + jm;
      int key = chain_key<T>(words, 8 * lane, aj, md);
      if (!((valid >> j) & 1u)) key = kInvalidKey;
      out[(size_t)j * w32] = key;
      cand |= (uint32_t)(key != kInvalidKey) << j;
    }
  }
  candw[(size_t)b * w32 + w] = (int32_t)cand;

  int c = __popc(cand);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xffffffffu, c, off);
  __shared__ int warp_sums[32];
  const int lane_id = threadIdx.x & 31;
  const int warp_id = threadIdx.x >> 5;
  if (lane_id == 0) warp_sums[warp_id] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sums[i];
    atomicAdd(counts + b, s);
  }
}

template <int T>
cudaError_t launch(const int32_t* pool, const int32_t* rows, const int32_t* adj,
                   const int32_t* mand, const int32_t* use_valid,
                   const int32_t* universe, const int32_t* live, int32_t* keys,
                   int32_t* candw, int32_t* counts, int B, int w32, int block,
                   cudaStream_t stream) {
  dim3 grid(w32 / block, B);
  chain_keys_kernel<T><<<grid, block, 0, stream>>>(
      pool, rows, adj, mand, use_valid, universe, live, keys, candw, counts, w32);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). `counts` must be zeroed by the
// caller. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mst_chain_keys(const void* pool, const void* rows, const void* adj,
                              const void* mand, const void* use_valid,
                              const void* universe, const void* live, void* keys,
                              void* candw, void* counts, int B, int T, int w32,
                              int block, void* stream) {
  if (B <= 0 || w32 < 32 || block < 32 || block > 1024 || block % 32 != 0 ||
      w32 % block != 0)
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const int32_t*>(pool);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* a = static_cast<const int32_t*>(adj);
  const auto* m = static_cast<const int32_t*>(mand);
  const auto* uv = static_cast<const int32_t*>(use_valid);
  const auto* u = static_cast<const int32_t*>(universe);
  const auto* l = static_cast<const int32_t*>(live);
  auto* k = static_cast<int32_t*>(keys);
  auto* c = static_cast<int32_t*>(candw);
  auto* n = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (T) {
    case 1: err = launch<1>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    case 2: err = launch<2>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    case 3: err = launch<3>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    case 4: err = launch<4>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    case 5: err = launch<5>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    case 6: err = launch<6>(p, r, a, m, uv, u, l, k, c, n, B, w32, block, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
