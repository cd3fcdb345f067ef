// K4h: the hamming distance from one packed sign query to every row of a
// binary-quantized vector matrix, for Hopper.
//
// Replaces: the XOR-popcount of meilisearch_tpu/vector/store.py's
// _device_topk_dispatch (its hamming branch) and _device_hamming, jitted
// XLA programs (no Pallas kernel). It computes the same function:
//   ham[r] = sum_w popc(mat[r, w] ^ q[w])     for every row r < n,
// where mat is (n, W) 32-bit sign words (bit i of word w is set where
// dimension 32w + i is >= 0; vector/store.py::_pack_signs), q the query's
// (W,) sign words, and ham (n,) int32.
//
// What bounds it on this card: bytes. The function reads n * W * 4 bytes
// of matrix and writes n * 4 bytes; per word it does one XOR, one POPC and
// one add, far below the card's integer rate
// (chip_smoke.py::k4h_bound_ms counts both).
//
// What the design does about it:
// - One thread per row: a row's words are summed in registers and written
//   once, with no reduction across threads and no atomics.
// - Every block stages q in shared memory; all the threads of a warp read
//   the same word of it at once, a broadcast.
// - Where W % 4 == 0 and the matrix is 16-byte aligned (100, 384, 768 and
//   1536 dimensions give W = 4, 12, 24 and 48), a thread reads its row as
//   16-byte vectors; other widths (W = 1 for 32 dimensions, 3 for 96) read
//   word by word. Neighbouring threads take neighbouring rows, so
//   a warp's loads cover one contiguous span of 32 * W * 4 bytes and each
//   32-byte sector comes from device memory once (what one load leaves of
//   a sector, the next finds in L1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// q staged in at most 48 KB of dynamic shared memory (the default limit
// of a launch): 393,216 dimensions
constexpr int kMaxWords = 12288;

template <bool kVec>
__global__ void __launch_bounds__(kBlock)
    hamming_kernel(const uint32_t* __restrict__ mat, const uint32_t* __restrict__ q,
                   int n, int w, int32_t* __restrict__ out) {
  extern __shared__ uint32_t qs[];
  for (int k = threadIdx.x; k < w; k += blockDim.x) qs[k] = q[k];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t* row = mat + (size_t)r * w;
  int h = 0;
  if (kVec) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int k = 0; k < w / 4; ++k) {
      const uint4 v = __ldg(row4 + k);
      h += __popc(v.x ^ qs[4 * k]) + __popc(v.y ^ qs[4 * k + 1]) +
           __popc(v.z ^ qs[4 * k + 2]) + __popc(v.w ^ qs[4 * k + 3]);
    }
  } else {
    for (int k = 0; k < w; ++k) h += __popc(__ldg(row + k) ^ qs[k]);
  }
  out[r] = h;
}

}  // namespace

// Plain C entry point (bound with ctypes): `mat` is (n, w) 32-bit words,
// `q` (w,) words, both on the device; `out` (n,) int32. Launches on
// `stream` and does not synchronise. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int mst_hamming(const void* mat, const void* q, int n, int w, void* out,
                           void* stream) {
  if (n <= 0 || w <= 0 || w > kMaxWords) return (int)cudaErrorInvalidValue;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = (size_t)w * sizeof(uint32_t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mat);
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  int32_t* o = static_cast<int32_t*>(out);
  if (w % 4 == 0 && (reinterpret_cast<uintptr_t>(mat) & 15) == 0)
    hamming_kernel<true><<<grid, kBlock, smem, s>>>(m, qw, n, w, o);
  else
    hamming_kernel<false><<<grid, kBlock, smem, s>>>(m, qw, n, w, o);
  return (int)cudaGetLastError();
}
