// K6: the fused lexicographic chain DP over a query's candidate axis, for Hopper.
//
// Replaces: meilisearch_tpu/ops/device_scorer.py::chain_cost_matrix (:56)
// and ::chain_query_topk (:111), jitted XLA programs. For every candidate
// column n it runs the `last`-strategy DP over T <= 16 terms with 4 states
// (3 typo classes and the skip state, START in the skip slot before term
// 0), each a 6-dimension int32 cost (words, typo, proximity, fid,
// position, exactness) combined by the lexicographic min `_lexmin`. Three
// modes (template parameter):
// - cost: writes the final (6, n) costs after min(., INF);
// - keys: applies `valid`, clips and packs the costs into the three int32
//   sort keys of device_scorer.py:186-204 (key_hi, key_lo, key_lo2);
// - top-k: the keys mode's keys, then each tile of columns keeps its k
//   <= 32 smallest entries by (key_hi, key_lo, key_lo2, column), in that
//   order, in survivor arrays of tiles x k slots; a slot past a short
//   last tile holds the sentinel (2^31 - 1 in every word), which sorts
//   after every real key. A column among the k best overall is among the
//   k best of its tile, and the full key ends with the column, so the
//   order is strict: any regrouping of the survivors keeps the same k
//   best in the same order as the stable 3-key sort of all n
//   (lax.sort(num_keys=3), device_scorer.py:206).
// A second kernel, select_kernel, merges the survivors: each block sorts
// a run of 1024 of them and keeps its k best, pass after pass until one
// run is left, whose pass also gathers the docids (two launches at k = 10
// and n = 355,439). mst_chain_topk enqueues the top-k mode and every pass
// in one call from the host (the plain walk of its loop is
// ops/device_scorer.py::merge_survivors). k <= 32 covers a page of
// results, every caller in the port; for a larger k the wrapper runs the
// keys mode and sorts all n with torch (sort3).
// The arithmetic is the reference's, bit for bit: plain int32 adds (a
// column's sums stay below 16 * 3 * 2^24 < 2^30 for T <= 16 and inputs
// <= INF, so nothing wraps), int8 pair costs, no skip at t = 0, visits
// from START only at t = 0 and from the 3 classes after, the skip state
// from all 4, and `_lexmin(a, b)` keeping b unless a is strictly less.
//
// What bounds it on this card: at T = 4 a column reads 12 mask bytes, 27
// pair bytes, 96 bytes of fid and position costs and 16 of exactness and
// writes 24 bytes (cost mode): about 175 bytes, so 62 MB at n = 355,439,
// 0.0186 ms at 3.35 TB/s. The DP does about 750 int32 operations a column
// at T = 4 (9 visit candidates of 6 adds a term, their lexicographic mins
// of 12 compares and 6 selects, the skip state): 0.0159 ms at the same n
// on 16.7 Tops/s of int32. chip_smoke.py recomputes both from its inputs.
// The two are close, so the kernel must overlap its copies with its
// arithmetic to come near either.
//
// What the design does about it:
// - A persistent grid (the bulk path): as many blocks as the SMs hold at
//   once (2 a SM where two blocks' rings fit, else 1). Block b takes one
//   contiguous range of tiles; a tile is kTile consecutive columns, one
//   thread a column: 256 columns for T <= 8, 128 above, so that a stage
//   of a column's 37T + 5 bytes fits twice in a block's shared memory.
// - A ring of stages in shared memory: each tile's row segments (3T mask
//   rows, 9(T - 1) pair rows, 3T fid rows, 3T position rows, T exactness
//   rows, and docids and valid in the keys and top-k modes) come in by
//   one-dimensional bulk copies (cp.async.bulk, the TMA's non-tensor
//   form) completing on the stage's mbarrier. The lanes of warp 0 issue
//   a tile's copies together, after lane 0 announced the tile's bytes;
//   the first stages go out before any DP starts, and a stage is refilled
//   with the block's tile after next once every thread has read it
//   (__syncthreads). The next tiles' copies are in flight while the DP
//   runs on this one. At T = 4 the cost mode's stage is 38.6 KB: two
//   blocks of two stages an SM.
// - A bulk copy needs a 16-byte-aligned source and a multiple of 16
//   bytes, so the bulk path takes a row stride (the inputs' width) that
//   is a multiple of 16 columns and 16-byte-aligned inputs: every tile
//   then starts aligned in every row, and its last copy rounds up into
//   the stride's padding. The port's callers lay the candidate axis out
//   so (ops/device_scorer.py::aligned_width) and compute only the first
//   n columns. Any other shape takes the direct path: the same tiles,
//   one block a tile in as many waves as it takes, each thread loading
//   its column's terms from device memory (a persistent grid there waits
//   on each term's loads with nothing in flight). Both run on the card;
//   the wrapper says which it asked for.
// - The DP reads its column from the stage (consecutive threads,
//   consecutive bytes: no bank conflicts), the 4 x 6 state in registers.
// - The top-k mode's select: each warp sorts its 32 entries (two 64-bit
//   words: hi << 32 | lo and lo2 << 32 | column) by shuffles, then a tree
//   of merges halves the warps' sorted lists (block_small: one
//   __syncthreads a level, 3 at kTile = 256), exact for k <= 32; k rounds
//   of a block-wide minimum would cost a reduction and two barriers a
//   round. select_kernel runs the same network over 1024 entries. The
//   stable 3-key sort in torch that this replaces is host-bound: about
//   0.37 ms of launches whether it sorts 13,890 survivors or all 355,439
//   columns (PERF.md).
// - What the card showed (tools/k6_ab.py, PERF.md): two blocks of 8 warps
//   an SM with two stages each beat one block with four stages (0.0388
//   against 0.0508 ms at T = 4, n = 355,439) and equal four blocks of
//   128 columns. The direct path takes 0.0555 ms (cost) and 0.0604 ms
//   (keys) there, once the cost and keys modes are held to 3 blocks an
//   SM (__launch_bounds__): at 83 registers the keys mode fit 2 and took
//   0.0777 ms; a persistent direct grid took 0.064 ms in the cost mode.
// - ptxas: 72 (cost), 78 (keys) and 118 (top-k) registers at kTile = 256,
//   87, 89 and 137 at kTile = 128, 27 in select_kernel; no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 24;
constexpr int kDims = 6;
constexpr int kMaxTerms = 16;
constexpr int kInvalidHi = 1 << 30;
constexpr uint32_t kSentinel = 0x7FFFFFFFu;
constexpr int kMaxStages = 4;
constexpr int kMaxTopk = 32;  // block_small's reach: one warp's lanes
constexpr int kHeader = 128;  // the stages' mbarriers, before the ring
constexpr int kSmemPerSm = 233472;  // 228 KB of shared memory on an SM
constexpr int kSmemPerBlock = 1024;  // reserved by the system per block
constexpr int kSmemLimit = 232448;  // the most a block may use

enum Mode { kCost = 0, kKeys = 1, kTopk = 2 };

struct Args {
  const uint8_t* mask;
  const int8_t* pair;
  const int32_t* fid;
  const int32_t* pos;
  const void* exact;
  const int32_t* docids;
  const uint8_t* valid;
  int32_t* out0;
  int32_t* out1;
  int32_t* out2;
  int32_t* out3;
  int T;
  int n;  // columns computed
  int64_t stride;  // the inputs' row stride, >= n
  int k;  // top-k: slots a tile, <= kMaxTopk
  int stages;  // bulk path: stages in the ring (0: the direct path)
  int tiles;
};

// byte offsets of a stage's segments; every one is a multiple of 16
struct Layout {
  int fid, pos, ex, doc, mask, pair, valid, bytes;
};

__host__ __device__ __forceinline__ Layout layout(int T, int mode, int tile) {
  const int ex_size = mode == kCost ? 4 : 1;
  const int keyed = mode != kCost;
  Layout l;
  l.fid = 0;
  l.pos = l.fid + 3 * T * tile * 4;
  l.ex = l.pos + 3 * T * tile * 4;
  l.doc = l.ex + T * tile * ex_size;
  l.mask = l.doc + keyed * tile * 4;
  l.pair = l.mask + 3 * T * tile;
  l.valid = l.pair + 9 * (T - 1) * tile;
  l.bytes = l.valid + keyed * tile;
  return l;
}

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

// One column's inputs: pointers at the column, rows `pitch` elements apart
// (the stage's kTile, or the inputs' stride on the direct path).
template <typename P>
struct Column {
  const uint8_t* mask;
  const int8_t* pair;
  const int32_t* fid;
  const int32_t* pos;
  const void* exact;
  P pitch;
};

// the DP of one column: the final costs after min(., INF)
template <int kMode, typename P>
__device__ __forceinline__ Cost column_dp(const Column<P>& c, int T) {
  Cost s[4] = {all(kInf), all(kInf), all(kInf), all(0)};
  for (int t = 0; t < T; ++t) {
    int ex;
    if constexpr (kMode == kCost) {
      ex = static_cast<const int32_t*>(c.exact)[t * c.pitch];
    } else {
      ex = static_cast<const uint8_t*>(c.exact)[t * c.pitch] ? 0 : 1;
    }
    Cost next[4];
#pragma unroll
    for (int cls = 0; cls < 3; ++cls) {
      const P at = (P)(t * 3 + cls) * c.pitch;
      const int w = c.mask[at] ? 0 : kInf;
      const int fd = c.fid[at], ps = c.pos[at];
      if (t == 0) {
        next[cls] = add(s[3], w, cls, 0, fd, ps, ex);
      } else {
#pragma unroll
        for (int prev = 0; prev < 3; ++prev) {
          const int px = c.pair[(P)(((t - 1) * 3 + prev) * 3 + cls) * c.pitch];
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
  return f;
}

// the three sort keys of a column's final costs (device_scorer.py:186-204)
__device__ __forceinline__ void pack(Cost f, bool valid, int docid, uint32_t& hi, uint32_t& lo,
                                     uint32_t& lo2) {
  if (!valid) f = all(kInf);
  const int w = clip(f.d[0], 63), ty = clip(f.d[1], 127), px = clip(f.d[2], 511);
  const int fd = clip(f.d[3], (1 << 20) - 1), ps = clip(f.d[4], (1 << 16) - 1);
  const int ex = clip(f.d[5], (1 << 10) - 1);
  hi = f.d[0] >= kInf ? kInvalidHi : (w << 23) | (ty << 16) | (px << 7) | (fd >> 13);
  lo = ((fd & ((1 << 13) - 1)) << 18) | (ps << 2) | (ex >> 8);
  lo2 = ((ex & 255) << 23) | clip(docid, (1 << 23) - 1);
}

// a top-k entry: a = hi << 32 | lo, b = lo2 << 32 | column
struct Entry {
  unsigned long long a, b;
};

__device__ __forceinline__ bool less(const Entry& x, const Entry& y) {
  return x.a < y.a || (x.a == y.a && x.b < y.b);
}

// one compare-exchange of a bitonic network with `o`, the partner's entry:
// the lower index keeps the min when `up`, else the max
__device__ __forceinline__ Entry keep(Entry v, const Entry& o, bool lower, bool up) {
  return (lower == up) == less(o, v) ? o : v;
}

// the same across lanes `j` apart, by warp shuffles
__device__ __forceinline__ Entry exchange(Entry v, int j, bool lower, bool up) {
  Entry o;
  o.a = __shfl_xor_sync(0xFFFFFFFFu, v.a, j);
  o.b = __shfl_xor_sync(0xFFFFFFFFu, v.b, j);
  return keep(v, o, lower, up);
}

// the k <= 32 smallest of the block's kTile entries, ascending in lanes
// 0..k-1 of warp 0: each warp sorts its 32 entries by shuffles; then, level
// by level, warp w takes warp w + half's sorted list reversed, keeps the
// elementwise min (the 32 smallest of both lists, a bitonic sequence) and
// sorts it in 5 shuffle steps. One __syncthreads a level, the exchange
// alternating between the two halves of `buf` (`flip`), so a level's
// writes never meet the reads of the level before.
template <int kTile>
__device__ __forceinline__ Entry block_small(Entry v, ulonglong2* buf, int& flip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) v = exchange(v, j, (lane & j) == 0, (lane & size) == 0);
  }
#pragma unroll
  for (int half = kTile / 64; half >= 1; half >>= 1) {
    ulonglong2* b = buf + flip * (kTile / 2);
    if (warp >= half && warp < 2 * half) b[(warp - half) * 32 + lane] = make_ulonglong2(v.a, v.b);
    __syncthreads();
    if (warp < half) {
      const ulonglong2 p = b[warp * 32 + 31 - lane];
      const Entry o{p.x, p.y};
      if (less(o, v)) v = o;
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) v = exchange(v, j, (lane & j) == 0, true);
    }
    flip ^= 1;
  }
  return v;
}

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

// warp 0: the row segments of the tile at column c0 (c columns, rounded
// up to 16 into the stride's padding) into `stage`, completing on `bar`
template <int kTile, int kMode>
__device__ __forceinline__ void issue_tile(const Args& a, const Layout& l, uint64_t* bar,
                                           unsigned char* stage, int c0, int c) {
  const int lane = threadIdx.x;
  const int T = a.T;
  const uint32_t c16 = (uint32_t)(c + 15) & ~15u;
  const int ex_size = kMode == kCost ? 4 : 1;
  const int pairs = 9 * (T - 1);
  const int segments = 10 * T + pairs + (kMode == kCost ? 0 : 2);
  if (lane == 0) bar_expect(bar, c16 * (uint32_t)(l.bytes / kTile));
  __syncwarp();
  for (int q = lane; q < segments; q += 32) {
    const char* src;
    int dst;
    uint32_t bytes;
    if (q < 6 * T) {  // fid rows, then position rows
      const bool is_pos = q >= 3 * T;
      const int r = is_pos ? q - 3 * T : q;
      src = reinterpret_cast<const char*>((is_pos ? a.pos : a.fid) + r * a.stride + c0);
      dst = (is_pos ? l.pos : l.fid) + r * kTile * 4;
      bytes = c16 * 4;
    } else if (q < 7 * T) {
      const int r = q - 6 * T;
      src = static_cast<const char*>(a.exact) + (r * a.stride + c0) * ex_size;
      dst = l.ex + r * kTile * ex_size;
      bytes = c16 * ex_size;
    } else if (q < 10 * T) {
      const int r = q - 7 * T;
      src = reinterpret_cast<const char*>(a.mask + r * a.stride + c0);
      dst = l.mask + r * kTile;
      bytes = c16;
    } else if (q < 10 * T + pairs) {
      const int r = q - 10 * T;
      src = reinterpret_cast<const char*>(a.pair + r * a.stride + c0);
      dst = l.pair + r * kTile;
      bytes = c16;
    } else if (q == 10 * T + pairs) {
      src = reinterpret_cast<const char*>(a.docids + c0);
      dst = l.doc;
      bytes = c16 * 4;
    } else {
      src = reinterpret_cast<const char*>(a.valid + c0);
      dst = l.valid;
      bytes = c16;
    }
    bulk_load(stage + dst, src, bytes, bar);
  }
}

template <int kTile, int kMode>
__global__ void __launch_bounds__(kTile, kMode == kTopk ? 2 : 3) chain_dp_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int i = threadIdx.x;
  const bool bulk = a.stages > 0;
  const Layout l = layout(a.T, kMode, kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHeader;
  ulonglong2* sort_buf = reinterpret_cast<ulonglong2*>(ring + (bulk ? a.stages * l.bytes : 0));
  int flip = 0;

  // this block's tiles [g0, g1)
  const int g0 = (int)((int64_t)a.tiles * blockIdx.x / gridDim.x);
  const int g1 = (int)((int64_t)a.tiles * (blockIdx.x + 1) / gridDim.x);
  const int mine = g1 - g0;
  auto cols = [&](int g) { return min(kTile, a.n - g * kTile); };

  if (bulk) {
    if (i == 0) {
      for (int s = 0; s < a.stages; ++s) bar_init(&bars[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (i < 32) {
      for (int j = 0; j < min(mine, a.stages); ++j)
        issue_tile<kTile, kMode>(a, l, &bars[j], ring + j * l.bytes, (g0 + j) * kTile,
                                 cols(g0 + j));
    }
  }

  for (int j = 0; j < mine; ++j) {
    const int g = g0 + j;
    const int c0 = g * kTile, c = cols(g);
    const int s = bulk ? j % a.stages : 0;
    unsigned char* stage = ring + s * l.bytes;
    if (bulk) bar_wait(&bars[s], (uint32_t)(j / a.stages) & 1u);
    const int64_t col = (int64_t)c0 + i;
    uint32_t hi = kSentinel, lo = kSentinel, lo2 = kSentinel;
    if (i < c) {
      Cost f;
      bool valid = true;
      int docid = 0;
      if (bulk) {
        const Column<int> src{stage + l.mask + i,
                              reinterpret_cast<const int8_t*>(stage + l.pair) + i,
                              reinterpret_cast<const int32_t*>(stage + l.fid) + i,
                              reinterpret_cast<const int32_t*>(stage + l.pos) + i,
                              stage + l.ex + i * (kMode == kCost ? 4 : 1), kTile};
        f = column_dp<kMode>(src, a.T);
        if constexpr (kMode != kCost) {
          valid = stage[l.valid + i] != 0;
          docid = reinterpret_cast<const int32_t*>(stage + l.doc)[i];
        }
      } else {
        const Column<int64_t> src{
            a.mask + col, a.pair + col, a.fid + col, a.pos + col,
            static_cast<const char*>(a.exact) + col * (kMode == kCost ? 4 : 1), a.stride};
        f = column_dp<kMode>(src, a.T);
        if constexpr (kMode != kCost) {
          valid = a.valid[col] != 0;
          docid = a.docids[col];
        }
      }
      if constexpr (kMode == kCost) {
#pragma unroll
        for (int d = 0; d < kDims; ++d) a.out0[(int64_t)d * a.n + col] = f.d[d];
      } else {
        pack(f, valid, docid, hi, lo, lo2);
        if constexpr (kMode == kKeys) {
          a.out0[col] = (int32_t)hi;
          a.out1[col] = (int32_t)lo;
          a.out2[col] = (int32_t)lo2;
        }
      }
    }
    if constexpr (kMode == kTopk) {
      // a short tile's idle threads hold the sentinel (column too)
      Entry e{((unsigned long long)hi << 32) | lo,
              ((unsigned long long)lo2 << 32) | (i < c ? (uint32_t)col : kSentinel)};
      e = block_small<kTile>(e, sort_buf, flip);
      if (i < a.k) {
        const int64_t slot = (int64_t)g * a.k + i;
        a.out0[slot] = (int32_t)(e.a >> 32);
        a.out1[slot] = (int32_t)(uint32_t)e.a;
        a.out2[slot] = (int32_t)(e.b >> 32);
        a.out3[slot] = (int32_t)(uint32_t)e.b;
      }
    }
    if (bulk) {
      __syncthreads();  // stage s read by every thread: refill it
      const int next = j + a.stages;
      if (i < 32 && next < mine)
        issue_tile<kTile, kMode>(a, l, &bars[s], stage, (g0 + next) * kTile, cols(g0 + next));
    }
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

template <int kTile, int kMode>
int launch(Args a, bool bulk, cudaStream_t stream) {
  // raised once per instantiation: a ring takes more than the default 48 KB
  static const cudaError_t raised = cudaFuncSetAttribute(
      chain_dp_kernel<kTile, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (raised != cudaSuccess) return (int)raised;
  const Layout l = layout(a.T, kMode, kTile);
  const int fixed = kHeader + (kMode == kTopk ? kTile * 16 : 0);  // block_small's buffer
  int per_sm = 0;
  a.stages = 0;
  if (bulk) {
    // two blocks an SM where two rings of two or more stages fit, else one
    for (int blocks = 2; blocks >= 1 && a.stages == 0; --blocks) {
      const int budget = min(kSmemLimit, kSmemPerSm / blocks - kSmemPerBlock) - fixed;
      const int stages = min(kMaxStages, budget / l.bytes);
      if (stages >= 2 || (blocks == 1 && stages >= 1)) {
        per_sm = blocks;
        a.stages = stages;
      }
    }
    if (a.stages == 0) return (int)cudaErrorInvalidValue;
  }
  a.tiles = (int)(((int64_t)a.n + kTile - 1) / kTile);
  const size_t smem = fixed + (size_t)a.stages * l.bytes;
  // the direct path: one block a tile, as many waves as it takes (a
  // persistent block would wait on each term's loads with nothing in
  // flight, and its last wave would hold an uneven share of the tiles)
  const int grid = bulk ? max(1, min(sm_count() * per_sm, a.tiles)) : a.tiles;
  chain_dp_kernel<kTile, kMode><<<grid, kTile, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The survivors' merge: block b sorts entries [b * kWidth, (b + 1) *
// kWidth) of `kept` (rows hi, lo, lo2 and column, m apart) by the full key
// (the column last, so the order is strict and does not depend on where an
// entry stands) and writes its first k to slots b * k ... of `out` (rows
// gridDim.x * k apart). On the last pass (one block) `docids` is given and
// the column row receives docids[column].
template <int kWidth>
__global__ void __launch_bounds__(kWidth) select_kernel(const int32_t* __restrict__ kept, int m,
                                                        int k, const int32_t* __restrict__ docids,
                                                        int32_t* __restrict__ out) {
  __shared__ ulonglong2 buf[kWidth];
  const int i = threadIdx.x;
  const int64_t at = (int64_t)blockIdx.x * kWidth + i;
  constexpr unsigned long long kNone = ((unsigned long long)kSentinel << 32) | kSentinel;
  Entry e{kNone, kNone};
  if (at < m) {
    e = Entry{((unsigned long long)(uint32_t)kept[at] << 32) | (uint32_t)kept[m + at],
              ((unsigned long long)(uint32_t)kept[2 * (int64_t)m + at] << 32) |
                  (uint32_t)kept[3 * (int64_t)m + at]};
  }
  int flip = 0;
  e = block_small<kWidth>(e, buf, flip);
  if (i < k) {
    const int64_t pitch = (int64_t)gridDim.x * k, slot = (int64_t)blockIdx.x * k + i;
    const uint32_t c = (uint32_t)e.b;
    out[slot] = (int32_t)(e.a >> 32);
    out[pitch + slot] = (int32_t)(uint32_t)e.a;
    out[2 * pitch + slot] = (int32_t)(e.b >> 32);
    out[3 * pitch + slot] = docids != nullptr && c != kSentinel ? docids[c] : (int32_t)c;
  }
}

constexpr int kSelectWidth = 1024;

template <int kTile>
int dispatch(const Args& a, int mode, bool bulk, cudaStream_t stream) {
  switch (mode) {
    case kCost: return launch<kTile, kCost>(a, bulk, stream);
    case kKeys: return launch<kTile, kKeys>(a, bulk, stream);
    default: return launch<kTile, kTopk>(a, bulk, stream);
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C entry point (bound with ctypes). Inputs are (..., stride) on the
// device; the first n <= stride columns are computed. mode 0 (cost):
// exact is (T, stride) int32, out0 is (6, n) int32; docids, valid, out1..3
// are not read. mode 1 (keys): exact is (T, stride) bool, out0..out2 are
// key_hi, key_lo, key_lo2, (n,) int32 each. mode 2 (top-k): as keys, but
// out0..out3 are the survivors' key_hi, key_lo, key_lo2 and column,
// (ceil(n / tile) * k,) int32 each, k <= 32 slots a tile. pair has at
// least T - 1 rows of (3, 3, stride) int8. tile is 256 for T <= 8 and 128
// above (ops/device_scorer.py::tile_width). bulk asks for the bulk path,
// which needs stride % 16 == 0 and 16-byte-aligned inputs; 0 the direct
// path. Launches on `stream` and does not synchronise. Returns the
// launch's cudaError_t (0 = success).
extern "C" int mst_chain_dp(const void* class_mask, const void* pair, const void* fid,
                            const void* pos, const void* exact, const void* docids,
                            const void* valid, void* out0, void* out1, void* out2, void* out3,
                            int T, int n, long long stride, int mode, int k, int tile, int bulk,
                            void* stream) {
  if (T < 1 || T > kMaxTerms || n < 1 || stride < n || mode < kCost || mode > kTopk ||
      tile != (T <= 8 ? 256 : 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode != kCost && (docids == nullptr || valid == nullptr || out1 == nullptr ||
                        out2 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (mode == kTopk && (out3 == nullptr || k < 1 || k > kMaxTopk)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bulk) {
    const void* inputs[] = {class_mask, pair, fid, pos, exact};
    for (const void* p : inputs)
      if (!aligned(p)) return (int)cudaErrorInvalidValue;
    if (stride % 16 != 0 || (mode != kCost && (!aligned(docids) || !aligned(valid))))
      return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.mask = static_cast<const uint8_t*>(class_mask);
  a.pair = static_cast<const int8_t*>(pair);
  a.fid = static_cast<const int32_t*>(fid);
  a.pos = static_cast<const int32_t*>(pos);
  a.exact = exact;
  a.docids = static_cast<const int32_t*>(docids);
  a.valid = static_cast<const uint8_t*>(valid);
  a.out0 = static_cast<int32_t*>(out0);
  a.out1 = static_cast<int32_t*>(out1);
  a.out2 = static_cast<int32_t*>(out2);
  a.out3 = static_cast<int32_t*>(out3);
  a.T = T;
  a.n = n;
  a.stride = stride;
  a.k = k;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 256 ? dispatch<256>(a, mode, bulk != 0, s) : dispatch<128>(a, mode, bulk != 0, s);
}

// K6's top-k mode and the survivors' merge in one call (bound with
// ctypes), for k <= 32: the top-k mode writes its tiles x k survivors to
// the first 4 * m0 words of `work` (m0 = ceil(n / tile) * k); each pass of
// select_kernel keeps the k best of every run of kSelectWidth, alternating
// between that part of `work` and the next 4 * m1 words (m1 =
// ceil(m0 / kSelectWidth) * k where m0 > kSelectWidth, else 0), until one
// run is left; the last pass writes its `keep` <= k best to `out`, (4,
// keep) int32 (hi, lo, lo2, docid). The other arguments are mst_chain_dp's.
// *passes receives the merge's launches. Launches on `stream` and does
// not synchronise; returns the first failed launch's cudaError_t.
extern "C" int mst_chain_topk(const void* class_mask, const void* pair, const void* fid,
                              const void* pos, const void* exact, const void* docids,
                              const void* valid, void* work, long long work_words, void* out,
                              int T, int n, long long stride, int k, int keep, int tile,
                              int bulk, int* passes, void* stream) {
  *passes = 0;
  if (n < 1 || k < 1 || k > kMaxTopk || keep < 1 || keep > k || out == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t m0 = ((int64_t)n + tile - 1) / tile * k;
  const int64_t m1 = m0 > kSelectWidth ? (m0 + kSelectWidth - 1) / kSelectWidth * k : 0;
  if (4 * (m0 + m1) > work_words || m0 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int32_t* a = static_cast<int32_t*>(work);
  int32_t* b = a + 4 * m0;
  int rc = mst_chain_dp(class_mask, pair, fid, pos, exact, docids, valid, a, a + m0, a + 2 * m0,
                        a + 3 * m0, T, n, stride, kTopk, k, tile, bulk, stream);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int m = (int)m0;
  while (m > kSelectWidth) {
    const int blocks = (m + kSelectWidth - 1) / kSelectWidth;
    select_kernel<kSelectWidth><<<blocks, kSelectWidth, 0, s>>>(a, m, k, nullptr, b);
    if ((rc = (int)cudaGetLastError()) != 0) return rc;
    ++*passes;
    m = blocks * k;
    int32_t* t = a;
    a = b;
    b = t;
  }
  select_kernel<kSelectWidth><<<1, kSelectWidth, 0, s>>>(
      a, m, keep, static_cast<const int32_t*>(docids), static_cast<int32_t*>(out));
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  ++*passes;
  return 0;
}
