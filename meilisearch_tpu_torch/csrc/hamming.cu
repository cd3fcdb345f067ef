// K4h: the hamming distance from one packed sign query to every row of a
// binary-quantized vector matrix, for Hopper, with the binary leg's
// elementwise tail in its epilogue.
//
// Replaces: the XOR-popcount of meilisearch_tpu/vector/store.py's
// _device_topk_dispatch (its hamming branch, with the cosine, the pad mask
// and, for lax.top_k's order, the sort key) and _device_hamming, jitted
// XLA programs (no Pallas kernel). mat is (n, W) 32-bit sign words (bit i
// of word w is set where dimension 32w + i is >= 0;
// vector/store.py::_pack_signs), q the query's (W,) sign words. Two modes,
// a template parameter, each reading the matrix once:
//   ham:    ham[r] = sum_w popc(mat[r, w] ^ q[w]), (n,) int32, every row;
//   keyed:  for r < n_live, cos[r] = (dim - 2 ham[r]) / dim rounded as one
//           IEEE division (never a reciprocal), and -2.0 for the pad rows
//           n_live <= r < n, which are not read; key[r] the int64
//           (order-preserving bits of cos[r]) << 32 | (2^32 - 1 - r), the
//           unique key on which vector/store.py::_topk_from_key selects.
//
// What bounds it on this card: bytes. It reads n_read * W * 4 bytes of
// matrix (n_read = n, or n_live when keyed) and writes 4 or 12 bytes a
// row; per word it does one XOR, one POPC and one add, far below the
// card's rates (chip_smoke.py::k4h_bound_ms counts both).
//
// What the design does about it:
// - A persistent grid: as many blocks as the SMs hold at once (the SM
//   count read once per device). Block b takes one contiguous range of
//   rows, an even share that starts on a multiple of 4 rows (so every
//   range starts 16-byte aligned), and walks it in tiles of kTile rows.
// - The tiles come in by one-dimensional bulk copies (cp.async.bulk, the
//   TMA's non-tensor form) into a ring of kStages stages in shared
//   memory, each completing on its own mbarrier. Thread 0 issues them,
//   the first kStages before the block reads q (the keyed mode's pad rows
//   are written while they are in flight); at W = 24 a block keeps 4 x 12
//   KB in flight and an SM holds 4 blocks, so every SM asks for its whole
//   share of the matrix at the start and counts rows as they land. A
//   stage is refilled once the block has counted it (__syncthreads, then
//   thread 0).
// - Counting: one thread per row of a tile. For the widths the product
//   uses (100, 384, 768 and 1536 dimensions: W = 4, 12, 24, 48) W is a
//   template parameter: the row is read as W / 4 16-byte shared loads,
//   against q held in registers; a 96-byte row stride costs a 2-way bank
//   conflict at W = 24, far below the copies' time. Other widths read the
//   row word by word against q in shared memory (a broadcast).
// - A copy moves a multiple of 16 bytes; the few rows at the very end of
//   the matrix that the last copy leaves out are read from device memory
//   directly. A matrix that is not 16-byte aligned (a view that starts
//   one word in), or rows wider than kMaxBulkWords, take the plain path:
//   the same ranges, each thread reading its rows word by word from
//   device memory.
// - The epilogue writes ham, or cos and key, straight from the register
//   that holds the count: the tail that took about 14 elementwise torch
//   launches between K4h and torch.topk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTile = kThreads;  // rows per tile, a multiple of kThreads
constexpr int kStages = 4;  // tiles in flight per block
constexpr int kMaxBulkWords = 64;  // wider rows take the plain path
// q staged in at most 48 KB of dynamic shared memory: 393,216 dimensions
constexpr int kMaxWords = 12288;
constexpr int kHeader = 128;  // the stages' mbarriers, before q
constexpr int kMaxBlocksPerSm = 8;
constexpr int kSmemPerSm = 233472;  // 228 KB of shared memory on an SM
constexpr int kSmemPerBlock = 1024;  // reserved by the system per block
// the largest dynamic shared memory a launch asks for: the ring at
// kMaxBulkWords (the plain path's q alone, at kMaxWords, needs less)
constexpr int kSmemLimit = kHeader + kMaxBulkWords * 4 + kStages * kTile * kMaxBulkWords * 4;
static_assert(kSmemLimit <= 232448 && kHeader + kMaxWords * 4 <= kSmemLimit,
              "a launch must fit the shared memory a block can use");

enum Mode { kModeHam = 0, kModeKeyed = 1 };

struct Args {
  const uint32_t* mat;
  const uint32_t* q;
  int n;  // rows written
  int n_read;  // rows read: n, or n_live when keyed
  int w;
  int dim;
  int32_t* ham;
  float* cos;
  int64_t* key;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the one arrival of a stage's phase, announcing `bytes` of copies
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the bytes of a tile's copy: its rows rounded down to 16 bytes
__device__ __forceinline__ uint32_t copy_bytes(int rows, int w) {
  return (uint32_t)rows * (uint32_t)w * 4u & ~15u;
}

// thread 0: `rows` rows from `first` on into a stage, completing on `bar`
__device__ __forceinline__ void issue_tile(uint64_t* bar, uint32_t* stage, const uint32_t* mat,
                                           int first, int rows, int w) {
  const uint32_t bytes = copy_bytes(rows, w);
  bar_expect(bar, bytes);
  if (bytes) bulk_load(stage, mat + (size_t)first * w, bytes, bar);
}

__device__ __forceinline__ int words_ham(const uint32_t* row, const uint32_t* qs, int w) {
  int h = 0;
  for (int k = 0; k < w; ++k) h += __popc(row[k] ^ qs[k]);
  return h;
}

__device__ __forceinline__ int global_ham(const uint32_t* row, const uint32_t* qs, int w) {
  int h = 0;
  for (int k = 0; k < w; ++k) h += __popc(__ldg(row + k) ^ qs[k]);
  return h;
}

template <int kW>
__device__ __forceinline__ int vec_ham(const uint4* row, const uint4* qv) {
  int h = 0;
#pragma unroll
  for (int k = 0; k < kW / 4; ++k) {
    const uint4 v = row[k];
    h += __popc(v.x ^ qv[k].x) + __popc(v.y ^ qv[k].y) + __popc(v.z ^ qv[k].z) +
         __popc(v.w ^ qv[k].w);
  }
  return h;
}

template <bool kKeyed>
__device__ __forceinline__ void emit(const Args& a, int r, int h) {
  if (!kKeyed) {
    a.ham[r] = h;
    return;
  }
  const float c =
      r < a.n_read ? __fdiv_rn((float)a.dim - 2.0f * (float)h, (float)a.dim) : -2.0f;
  const int32_t b = __float_as_int(c);
  const uint32_t ordered = (uint32_t)(b < 0 ? b ^ 0x7FFFFFFF : b);
  a.cos[r] = c;
  a.key[r] = (int64_t)(((uint64_t)ordered << 32) | (uint64_t)(0xFFFFFFFFu - (uint32_t)r));
}

// kW: the row width in words, or 0 for any width (read word by word)
template <int kW, bool kKeyed>
__global__ void __launch_bounds__(kThreads) hamming_kernel(const Args a, const bool bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = kW > 0 ? kW : a.w;
  const int tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + kHeader);
  uint32_t* ring = qs + ((w + 31) & ~31);  // 128-byte aligned

  // this block's rows [r0, r1) of the n_read that are read
  const long long units = (a.n_read + 3) / 4;
  const int r0 = (int)(4 * (units * blockIdx.x / gridDim.x));
  const int r1 = min((int)(4 * (units * (blockIdx.x + 1) / gridDim.x)), a.n_read);
  const int tiles = bulk && r1 > r0 ? (r1 - r0 + kTile - 1) / kTile : 0;

  if (bulk && tid == 0) {  // the first copies go out before q is read
    for (int s = 0; s < kStages; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(tiles, kStages); ++t)
      issue_tile(&bars[t], ring + (size_t)t * kTile * w, a.mat, r0 + t * kTile,
                 min(kTile, r1 - r0 - t * kTile), w);
  }
  if (kKeyed) {  // the pad rows, written while the copies are in flight
    for (int r = a.n_read + blockIdx.x * kThreads + tid; r < a.n; r += gridDim.x * kThreads)
      emit<kKeyed>(a, r, 0);
  }
  for (int k = tid; k < w; k += kThreads) qs[k] = a.q[k];
  __syncthreads();
  uint4 qv[kW > 0 ? kW / 4 : 1];
  if constexpr (kW > 0) {
#pragma unroll
    for (int k = 0; k < kW / 4; ++k) qv[k] = reinterpret_cast<const uint4*>(qs)[k];
  }

  if (bulk) {
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      const int first = r0 + t * kTile;
      const int rows = min(kTile, r1 - first);
      bar_wait(&bars[s], (uint32_t)(t / kStages) & 1u);
      for (int i = tid; i < rows; i += kThreads) {
        const int r = first + i;
        const uint32_t* row = ring + ((size_t)s * kTile + i) * w;
        int h;
        if ((uint32_t)(i + 1) * (uint32_t)w * 4u > copy_bytes(rows, w))
          h = global_ham(a.mat + (size_t)r * w, qs, w);  // past the copy's last 16 bytes
        else if constexpr (kW > 0)
          h = vec_ham<kW>(reinterpret_cast<const uint4*>(row), qv);
        else
          h = words_ham(row, qs, w);
        emit<kKeyed>(a, r, h);
      }
      __syncthreads();  // stage s counted by every thread: refill it
      const int next = t + kStages;
      if (tid == 0 && next < tiles)
        issue_tile(&bars[s], ring + (size_t)s * kTile * w, a.mat, r0 + next * kTile,
                   min(kTile, r1 - r0 - next * kTile), w);
    }
  } else {
    for (int r = r0 + tid; r < r1; r += kThreads)
      emit<kKeyed>(a, r, global_ham(a.mat + (size_t)r * w, qs, w));
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = v > 0 ? v : 132;
  }
  return cached[dev];
}

template <int kW, bool kKeyed>
int launch(const Args& a, bool bulk, cudaStream_t stream) {
  // raised once per instantiation: the ring at kMaxBulkWords needs more
  // than the default 48 KB
  static const cudaError_t raised = cudaFuncSetAttribute(
      hamming_kernel<kW, kKeyed>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (raised != cudaSuccess) return (int)raised;
  const size_t q_bytes = ((size_t)a.w * 4 + 127) & ~(size_t)127;
  const size_t smem = kHeader + q_bytes + (bulk ? (size_t)kStages * kTile * a.w * 4 : 0);
  const int per_sm = max(1, min(kMaxBlocksPerSm, (int)(kSmemPerSm / (smem + kSmemPerBlock))));
  const int work = max((a.n_read + kTile - 1) / kTile, (a.n - a.n_read + kThreads - 1) / kThreads);
  const int grid = max(1, min(sm_count() * per_sm, work));
  hamming_kernel<kW, kKeyed><<<grid, kThreads, smem, stream>>>(a, bulk);
  return (int)cudaGetLastError();
}

template <bool kKeyed>
int dispatch(const Args& a, bool bulk, cudaStream_t stream) {
  if (bulk) {
    switch (a.w) {
      case 4: return launch<4, kKeyed>(a, bulk, stream);
      case 12: return launch<12, kKeyed>(a, bulk, stream);
      case 24: return launch<24, kKeyed>(a, bulk, stream);
      case 48: return launch<48, kKeyed>(a, bulk, stream);
      default: break;
    }
  }
  return launch<0, kKeyed>(a, bulk, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes): `mat` is (n, w) 32-bit words,
// `q` (w,) words, both on the device. mode 0 (ham) writes `ham` (n,)
// int32; mode 1 (keyed) writes `cos` (n,) float32 and `key` (n,) int64
// for the first n_live rows of a `dim`-dimension matrix, the rest as pad
// rows. Launches on `stream` and does not synchronise. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int mst_hamming(const void* mat, const void* q, int n, int w, int mode, int dim,
                           int n_live, void* ham, void* cos, void* key, void* stream) {
  if (n <= 0 || w <= 0 || w > kMaxWords) return (int)cudaErrorInvalidValue;
  if (mode == kModeKeyed) {
    if (dim <= 0 || n_live < 0 || n_live > n || cos == nullptr || key == nullptr)
      return (int)cudaErrorInvalidValue;
  } else if (mode != kModeHam || ham == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool keyed = mode == kModeKeyed;
  const Args a{static_cast<const uint32_t*>(mat), static_cast<const uint32_t*>(q), n,
               keyed ? n_live : n, w, dim, static_cast<int32_t*>(ham),
               static_cast<float*>(cos), static_cast<int64_t*>(key)};
  const bool bulk = w <= kMaxBulkWords && (reinterpret_cast<uintptr_t>(mat) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keyed ? dispatch<true>(a, bulk, s) : dispatch<false>(a, bulk, s);
}
