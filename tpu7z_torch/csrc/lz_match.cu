// Hand-written Hopper kernel of the shared LZ matcher's exact match lengths.
//
// Replaces no TPU kernel: tpu7z's `_match_lengths` (tpu7z/models/lz4/block.py:195)
// is numpy. Its plain PyTorch version, `match_lengths_ref` in
// tpu7z_torch/ops/hash_chain.py, ran on the card as a `cummin` over the
// n + 1 positions, a `cumprod` a panel pass and a host read before every
// pass; this kernel gives the same integers with no host read and no
// PyTorch scan.
//
// Built by tpu7z_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: the launcher has a plain C signature, takes raw
// device pointers and a stream, launches on that stream without
// synchronising, allocates nothing, and returns the first CUDA error.
//
// The algorithm is the plain version's. Position p of `pos`, with its
// verified candidate c (0 <= c < p) and cap max(limit - 4, 0), is linked
// when p + 1 is in `pos` with candidate c + 1 and byte p + 4 equals byte
// c + 4: then p's common prefix is p + 1's plus one. Links form chains of
// consecutive positions; each position's chain end is the first unlinked
// position at or after it, and only chain ends compare bytes, up to the
// most any position of their chain can use (`need`). So the work follows
// the input, whatever the limit.
//
// One cooperative launch of a persistent grid (every SM, as many CTAs as
// fit), in phases that a grid barrier separates:
//   0. the position -> candidate plane set to -1;
//   1. the plane and each position's reach (p + its cap) scattered from
//      pos, cand and limit;
//   2. the links as one bit a position (a warp ballot makes each 32-bit
//      word), and each tile's first unlinked position (a tile is a CTA's
//      8192 positions);
//   3. one CTA takes the suffix minimum over the tiles: the first unlinked
//      position at or after each tile;
//   4. each word's first unlinked position at or after it (a suffix minimum
//      within the warp and CTA, then the tile's carry), and each chain's
//      greatest reach at its end: a warp's lanes with one chain end
//      reduce theirs first (match_any, reduce_max), a CTA its chain that
//      runs past the tile in shared memory, then one atomicMax;
//   5. the panels: a warp takes 32 positions, and each chain end among them
//      compares its first 16 bytes alone; an end whose 16 bytes agree and
//      whose bound is longer takes the whole warp, 512 bytes a step (each
//      lane 16, as four words, the first differing byte by __ballot_sync
//      and __ffs), until the first mismatch or its bound. The warp stops at
//      the first mismatch, so its work follows the common prefix, not the
//      bound. An end still equal after SPLIT bytes goes to a queue on the
//      card;
//   6. the queued ends, cut into segments of SEG bytes that any warp
//      claims (an atomic counter an end), the first mismatch of an end
//      reduced by atomicMin: a long common prefix under LZ4's or LZMA's
//      limits is compared by many warps, not one;
//   7. the lengths: 4 + min(end - p + tail[end], cap) for every entry.
// Linked positions are skipped inside the kernel, never compacted on the
// host.
//
// Bound: bytes. By its contract the kernel reads pos, cand and limit
// (8 bytes an entry each), writes the lengths (8 bytes an entry), and
// writes and reads the candidate plane (4 bytes a position), each entry's
// reach and tail (4 bytes an entry) and the link and chain-end words (4
// bytes a word each); gzip's 4 MiB request, 2.19 Mi entries, moves 123 MB,
// 0.037 ms at 3.35 TB/s. The bytes of s it compares are what the data
// asks for and are left out. The design keeps every phase's loads
// coalesced where they follow positions (the planes, the link words) and
// the scattered ones (the candidate's bytes, the chain ends' reach) in L2,
// and replaces the plain version's host round trip a pass with one grid
// barrier a phase (a few microseconds each). On one H100 it takes 0.21 ms
// at gzip's shape, 5.7 times this bound, which counts the design's own
// scratch planes (53 of the 123 MB), and 9.4 times the 0.022 ms that the
// work alone moves (pos, cand and limit read, the lengths written, s read
// once): phases 2 and 4 walk a warp's 32 words in series (PERF.md
// section 6).

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int WARP_SPAN = 32 * 32;           // positions a warp takes in phases 2 and 4
constexpr int TILE = NWARPS * WARP_SPAN;     // positions a CTA takes there
constexpr int VERIFIED = 4;
constexpr int LANE_BYTES = 16;               // bytes a lane compares a step
constexpr int STEP = 32 * LANE_BYTES;        // bytes a warp compares a step
constexpr int SPLIT = LANE_BYTES + 8 * STEP; // an end still equal past this goes to the queue
constexpr int SEG = 8 * STEP;                // bytes of a queued end a warp claims at once
constexpr int QCAP = 1 << 16;                // queued ends at most; past it a warp goes on alone
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const uint8_t* s;
  const int64_t* pos;
  const int64_t* cand;
  const int64_t* limit;
  int64_t* out;
  int* plane;       // n + 1: the candidate of each position of pos, else -1
  int* nt;          // n + 1: a position's reach; at chain ends their chain's, then the tail
  unsigned* link;   // nwords: bit p & 31 of word p >> 5 is p's link
  int* wend;        // nwords + 1: the first unlinked position at or after each word
  int* zt;          // ntiles + 1: the same at or after each tile
  int* queue;       // 2 * QCAP: (chain end, segments claimed) of each queued end
  int* ctr;         // 2: queued ends, the first queued end not yet exhausted
  int n, m, nwords, ntiles;
};

struct Layout {
  long long plane, nt, link, wend, zt, queue, ctr, total;
};

Layout layout(int n) {
  const long long nwords = (n + 31LL) / 32, ntiles = (n + (long long)TILE - 1) / TILE;
  Layout l;
  l.plane = 0;
  l.nt = l.plane + n + 1;
  l.link = l.nt + n + 1;
  l.wend = l.link + nwords;
  l.zt = l.wend + nwords + 1;
  l.queue = l.zt + ntiles + 1;
  l.ctr = l.queue + 2LL * QCAP;
  l.total = l.ctr + 2;
  return l;
}

// The first unlinked position in a link word whose first position is
// `base`, at most n (every bit past the input is 0).
__device__ __forceinline__ int first_zero(unsigned word, int base, int n) {
  const unsigned zeros = ~word;
  return zeros ? min(base + __ffs(zeros) - 1, n) : n;
}

// s[a .. a + 15] as four little-endian words, from five aligned loads.
// A word is loaded only if it holds a byte of s at or before s[n - 1]
// (`last_word` is the address of the aligned word that holds s[n - 1]),
// so no load leaves the pages of s; bytes past s[n - 1] are not compared.
__device__ __forceinline__ void window16(const uint8_t* s, uintptr_t last_word, long long a,
                                         uint32_t (&w)[4]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s) + (uintptr_t)a;
  const uintptr_t al = addr & ~uintptr_t(3);
  const unsigned sh = (unsigned)(addr & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uintptr_t at = al + 4 * i;
    x[i] = at <= last_word ? __ldg(reinterpret_cast<const uint32_t*>(at)) : 0u;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], sh);
}

// The first of the 16 bytes from a and from b that differ, 16 if none.
__device__ __forceinline__ int first_diff16(const uint8_t* s, uintptr_t last_word, long long a,
                                            long long b) {
  uint32_t wa[4], wb[4];
  window16(s, last_word, a, wa);
  window16(s, last_word, b, wb);
  int r = LANE_BYTES;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const uint32_t x = wa[i] ^ wb[i];
    if (x) r = 4 * i + ((__ffs(x) - 1) >> 3);
  }
  return r;
}

// Inclusive prefix minimum over the block's threads, one value a thread;
// `total` gets the minimum of all. Every thread calls it.
__device__ int block_prefix_min(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = min(v, o);
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  int pre = INT_MAX;
  total = INT_MAX;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    if (w < warp) pre = min(pre, wsum[w]);
    total = min(total, wsum[w]);
  }
  __syncthreads();
  return min(pre, v);
}

// The tail of chain end e (candidate ec) past its first 16 bytes, known
// equal, at most `bound`: the whole warp compares, 512 bytes a step. An
// end still equal at byte SPLIT, and longer, is queued for phase 6
// instead while the queue has room, and -1 returned for it.
__device__ int warp_tail(const Args& A, uintptr_t last_word, int e, int ec, int bound) {
  const int lane = threadIdx.x & 31;
  for (int d = LANE_BYTES;; d += STEP) {
    if (d == SPLIT && bound > SPLIT) {
      int slot = 0;
      if (lane == 0) {
        slot = atomicAdd(&A.ctr[0], 1);
        if (slot < QCAP) {
          A.queue[2 * slot] = e;
          A.queue[2 * slot + 1] = 0;
        }
      }
      if (__shfl_sync(FULL, slot, 0) < QCAP) return -1;
    }
    const int off = d + LANE_BYTES * lane;
    const int lim = min(bound - off, LANE_BYTES);
    int r = 0;
    if (lim > 0) r = min(first_diff16(A.s, last_word, (long long)e + VERIFIED + off,
                                      (long long)ec + VERIFIED + off), lim);
    const unsigned stops = __ballot_sync(FULL, r < LANE_BYTES);
    if (stops) {
      const int f = __ffs(stops) - 1;
      return d + LANE_BYTES * f + __shfl_sync(FULL, r, f);
    }
  }
}

__global__ void __launch_bounds__(THREADS) lz_match_kernel(const Args A) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int sh_warp[NWARPS];
  __shared__ int sh_carry;
  const int n = A.n, m = A.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = blockIdx.x * THREADS + threadIdx.x, nthreads = gridDim.x * THREADS;
  const int gwarp = tid >> 5, gwarps = nthreads >> 5;
  const uintptr_t last_word = (reinterpret_cast<uintptr_t>(A.s) + n - 1) & ~uintptr_t(3);

  // 0. the plane empty, the counters and the sentinels set
  for (int q = tid; q <= n; q += nthreads) A.plane[q] = -1;
  if (tid == 0) {
    A.ctr[0] = A.ctr[1] = 0;
    A.wend[A.nwords] = n;
    A.zt[A.ntiles] = n;
  }
  grid.sync();

  // 1. each entry's candidate and reach at its position; a cap past the
  //    input's end is cut to it, which changes no length (a tail never
  //    reaches past n - 4)
  for (int i = tid; i < m; i += nthreads) {
    const int p = (int)A.pos[i];
    const long long cap = max((long long)A.limit[i] - VERIFIED, 0LL);
    A.plane[p] = (int)A.cand[i];
    A.nt[p] = p + (int)min(cap, (long long)(n - p));
  }
  grid.sync();

  // 2. the link words, and each tile's first unlinked position
  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    const int base = t * TILE + warp * WARP_SPAN;
    unsigned mine = 0;   // lane k keeps word k of the warp's 32
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int q = base + 32 * k + lane;
      bool linked = false;
      if (q < n - VERIFIED) {
        const int c = A.plane[q];
        linked = c >= 0 && c < q && A.plane[q + 1] == c + 1 &&
                 __ldg(A.s + q + VERIFIED) == __ldg(A.s + c + VERIFIED);
      }
      const unsigned word = __ballot_sync(FULL, linked);
      if (lane == k) mine = word;
    }
    const int w = (base >> 5) + lane;
    if (w < A.nwords) A.link[w] = mine;
    const int fz = __reduce_min_sync(FULL, first_zero(mine, base + 32 * lane, n));
    if (lane == 0) sh_warp[warp] = fz;
    __syncthreads();
    if (threadIdx.x == 0) {
      int z = n;
#pragma unroll
      for (int u = 0; u < NWARPS; ++u) z = min(z, sh_warp[u]);
      A.zt[t] = z;
    }
    __syncthreads();
  }
  grid.sync();

  // 3. the suffix minimum over the tiles, by one CTA from the last tile
  //    down: thread i takes the i-th tile from the top of each chunk
  if (blockIdx.x == 0) {
    int carry = n;
    for (int top = A.ntiles; top > 0; top -= THREADS) {
      const int t = top - 1 - (int)threadIdx.x;
      int total;
      const int v = min(block_prefix_min(t >= 0 ? A.zt[t] : n, sh_warp, total), carry);
      if (t >= 0) A.zt[t] = v;
      carry = min(carry, total);
    }
  }
  grid.sync();

  // 4. each word's first unlinked position at or after it, and each
  //    chain's greatest reach at its end
  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    const int base = t * TILE + warp * WARP_SPAN;
    const int tile_end = (t + 1) * TILE;
    const int w = (base >> 5) + lane;
    const unsigned mine = w < A.nwords ? A.link[w] : 0u;
    int v = first_zero(mine, base + 32 * lane, n);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(FULL, v, d);
      if (lane + d < 32) v = min(v, o);
    }
    if (lane == 0) sh_warp[warp] = v;
    if (threadIdx.x == 0) sh_carry = -1;
    __syncthreads();
    int carry = A.zt[t + 1];   // the first unlinked position past this warp's words
    for (int u = warp + 1; u < NWARPS; ++u) carry = min(carry, sh_warp[u]);
    const int at = min(v, carry);
    if (w < A.nwords) A.wend[w] = at;
    int next = __shfl_down_sync(FULL, at, 1);
    if (lane == 31) next = carry;
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
      const int q = base + 32 * k + lane;
      const unsigned word = __shfl_sync(FULL, mine, k);
      const int after = __shfl_sync(FULL, next, k);
      const unsigned ahead = ~word & (FULL << lane);
      const int end = ahead ? base + 32 * k + __ffs(ahead) - 1 : after;
      const bool member = q < n && A.plane[q] >= 0;
      const unsigned members = __ballot_sync(FULL, member);
      if (member) {
        // chain ends rise with the position, so a chain's lanes are one run
        const unsigned peers = __match_any_sync(members, end);
        const int most = __reduce_max_sync(peers, A.nt[q]);
        if (lane == 31 - __clz(peers)) {
          if (end >= tile_end) atomicMax(&sh_carry, most);   // end is zt[t + 1]
          else atomicMax(&A.nt[end], most);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && sh_carry >= 0) atomicMax(&A.nt[A.zt[t + 1]], sh_carry);
    __syncthreads();
  }
  grid.sync();

  // 5. the chain ends' tails: 16 bytes a lane alone, then the warp
  for (int w = gwarp; w < A.nwords; w += gwarps) {
    const int q = 32 * w + lane;
    const unsigned word = A.link[w];
    const int c = q < n ? A.plane[q] : -1;
    const bool is_end = c >= 0 && !((word >> lane) & 1u);
    if (!__ballot_sync(FULL, is_end)) continue;
    int bound = 0, tail = 0;
    if (is_end) {
      bound = min(A.nt[q] - q, max(n - VERIFIED - q, 0));
      if (bound > 0)
        tail = min(first_diff16(A.s, last_word, (long long)q + VERIFIED,
                                (long long)c + VERIFIED), min(bound, LANE_BYTES));
    }
    const bool longer = is_end && tail == LANE_BYTES && bound > LANE_BYTES;
    if (is_end && !longer) A.nt[q] = tail;
    for (unsigned todo = __ballot_sync(FULL, longer); todo; todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      const int ec = __shfl_sync(FULL, c, j), b = __shfl_sync(FULL, bound, j);
      const int e = 32 * w + j;
      const int got = warp_tail(A, last_word, e, ec, b);
      if (lane == 0) A.nt[e] = got < 0 ? b : got;
    }
  }
  grid.sync();

  // 6. the queued ends' segments, claimed by any warp
  const int queued = min(*(volatile int*)&A.ctr[0], QCAP);
  while (queued) {
    int j = 0, e = 0, seg = 0, best = 0;
    if (lane == 0) {
      j = *(volatile int*)&A.ctr[1];
      if (j < queued) {
        e = A.queue[2 * j];
        seg = atomicAdd(&A.queue[2 * j + 1], 1);
        best = *(volatile int*)&A.nt[e];
      }
    }
    j = __shfl_sync(FULL, j, 0);
    if (j >= queued) break;
    e = __shfl_sync(FULL, e, 0);
    seg = __shfl_sync(FULL, seg, 0);
    best = __shfl_sync(FULL, best, 0);
    const long long start = SPLIT + (long long)seg * SEG;
    if (start >= best) {   // this end is exhausted: move the cursor past it
      if (lane == 0) atomicMax(&A.ctr[1], j + 1);
      continue;
    }
    const int stop = (int)min(start + SEG, (long long)best);
    const int ec = A.plane[e];
    for (int d = (int)start; d < stop; d += STEP) {
      const int off = d + LANE_BYTES * lane;
      const int lim = min(stop - off, LANE_BYTES);
      const int r = lim > 0 ? first_diff16(A.s, last_word, (long long)e + VERIFIED + off,
                                           (long long)ec + VERIFIED + off) : LANE_BYTES;
      const unsigned found = __ballot_sync(FULL, lim > 0 && r < lim);
      if (found) {
        const int f = __ffs(found) - 1;
        const int at = d + LANE_BYTES * f + __shfl_sync(FULL, r, f);
        if (lane == 0) atomicMin(&A.nt[e], at);
        break;
      }
    }
  }
  grid.sync();

  // 7. the lengths
  for (int i = tid; i < m; i += nthreads) {
    const int p = (int)A.pos[i];
    const unsigned ahead = ~A.link[p >> 5] & (FULL << (p & 31));
    const int end = ahead ? (p & ~31) + __ffs(ahead) - 1 : A.wend[(p >> 5) + 1];
    const long long cap = max((long long)A.limit[i] - VERIFIED, 0LL);
    A.out[i] = VERIFIED + min((long long)(end - p + A.nt[end]), cap);
  }
}

// The CTAs of the kernel that the current card holds at once: the
// largest grid a cooperative launch takes.
cudaError_t resident_ctas(int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lz_match_kernel, THREADS, 0);
  *ctas = sms * per_sm;
  return err;
}

}  // namespace

// ---------------------------------------------------------------------------
// C launcher
// ---------------------------------------------------------------------------

extern "C" {

const char* lz_match_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Positions and grid-stride counters are int32 inside the kernel: the
// input may hold at most this many bytes.
int lz_match_max_n() { return INT_MAX - (1 << 22); }

// The int32 scratch a launch over n bytes needs.
long long lz_match_scratch(int n) { return layout(n).total; }

// What the compiler and the card make of the kernel: registers and local
// (spill) bytes a thread, static shared bytes and threads a CTA, resident
// CTAs per SM.
int lz_match_kernel_info(int* regs, int* local_bytes, int* shared_bytes, int* threads,
                         int* ctas_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, lz_match_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, lz_match_kernel,
                                                            THREADS, 0);
}

// s: n bytes; pos, cand, limit: m int64 entries each (distinct positions
// below n, each candidate 0 <= cand < pos, pos + limit <= n); out: m int64
// lengths; scratch: lz_match_scratch(n) int32. One cooperative launch,
// none when m is 0. Refuses (cudaErrorInvalidValue, nothing launched) n
// past lz_match_max_n() and negative sizes.
int lz_match_launch(const uint8_t* s, const int64_t* pos, const int64_t* cand,
                    const int64_t* limit, int64_t* out, int* scratch, int n, int m,
                    cudaStream_t stream) {
  if (n < 0 || m < 0 || n > lz_match_max_n()) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const Layout l = layout(n);
  Args a;
  a.s = s;
  a.pos = pos;
  a.cand = cand;
  a.limit = limit;
  a.out = out;
  a.plane = scratch + l.plane;
  a.nt = scratch + l.nt;
  a.link = reinterpret_cast<unsigned*>(scratch + l.link);
  a.wend = scratch + l.wend;
  a.zt = scratch + l.zt;
  a.queue = scratch + l.queue;
  a.ctr = scratch + l.ctr;
  a.n = n;
  a.m = m;
  a.nwords = (int)((n + 31LL) / 32);
  a.ntiles = (int)((n + (long long)TILE - 1) / TILE);
  int ctas = 0;
  const cudaError_t err = resident_ctas(&ctas);
  if (err != cudaSuccess) return (int)err;
  if (ctas <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long want = std::max((long long)a.ntiles, (m + (long long)THREADS - 1) / THREADS);
  const unsigned grid = (unsigned)std::max(1LL, std::min(want, (long long)ctas));
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)lz_match_kernel, dim3(grid),
                                                    dim3(THREADS), args, 0, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
