// Hand-written Hopper kernels of the LZ4 device block encoder.
//
// Four kernels replace the six Pallas TPU kernels of tpu7z/ops/lz4_pallas.py
// (a1, a2, a3, and b1+b2+c as one); two more, lz4_keys and lz4_probe, run
// the sorted-neighbour candidate tiers that the JAX package left to XLA.
// Each works on a batch of B independent 64 KiB blocks; the plain PyTorch
// version of every kernel is in tpu7z_torch/ops/lz4_plane.py and gives the
// same integers.
//
// Built by tpu7z_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every launcher has a plain C signature, takes raw
// device pointers, B (and W) and a stream, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError().
//
// Layouts (row-major, contiguous):
//   blocks   (B, BLOCK)  uint8     raw bytes, zero padded past n
//   ns       (B,)        int32     valid length of each block
//   keys     (2, B, BLOCK) int32   uint32 sort keys (tier B, tier B4), raw bits
//   so*      (B, BLOCK)  int32     sorted-neighbour candidate offsets
//                                  (lz4_probe writes them as one (3, B, BLOCK))
//   mlen/moff(B, BLOCK)  int32
//   is_start (B, BLOCK)  uint8     0/1
//   geo      (B, G_NPLANES, BLOCK) int32, planes in GeoPlane order
//   out      (B, OUT_CAP)  uint8

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 128;
constexpr int NROWS = 512;
constexpr int BLOCK = ROW * NROWS;
constexpr int OUT_CAP = 676 * ROW;
constexpr int MIN_MATCH = 4;
constexpr int MIN_MATCH_B = 8;
constexpr int TAIL_GUARD = 12;
constexpr int END_LITERALS = 5;
constexpr int LONG_LIT = 270;

// geometry planes; the order is GEO_NAMES in ops/lz4_plane.py
enum GeoPlane {
  G_KEPT, G_ANCHOR, G_MSTART, G_TOKEN, G_LITREM, G_E, G_GAP255, G_LONG_RUN,
  G_MLC, G_ML_EXT, G_GLEN, G_CORE_POS, G_GAP_HERE, G_GAP_BEFORE, G_NPLANES
};

// The row kernels (match, geometry): one CUDA block per 64 KiB block. A
// warp takes one 128-byte row at a time and each of its lanes 4 consecutive
// positions, so a plane moves as one 16-byte load or store a lane and a
// warp instruction covers 512 contiguous bytes. Results that cross rows
// come from per-row summaries in shared memory, joined by one warp's scan
// over the block's 512 rows between two barriers.
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;
constexpr int LANE_POS = ROW / 32;               // positions a lane owns
constexpr int ROWS_PER_LANE = NROWS / 32;        // rows a lane joins in a row scan
constexpr unsigned FULL = 0xffffffffu;
static_assert(LANE_POS == 4, "a lane owns one int4 of each row");

struct MinOp { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct MaxOp { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct SumOp { __device__ int operator()(int a, int b) const { return a + b; } };

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the combination of v over the lanes below this one (ident at lane 0)
template <typename Op>
__device__ __forceinline__ int warp_exclusive_up(int v, Op op, int ident) {
  const int lane = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = op(v, o);
  }
  const int ex = __shfl_up_sync(FULL, v, 1);
  return lane ? ex : ident;
}

// the combination of v over the lanes above this one (ident at lane 31)
template <typename Op>
__device__ __forceinline__ int warp_exclusive_down(int v, Op op, int ident) {
  const int lane = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(FULL, v, d);
    if (lane + d < 32) v = op(v, o);
  }
  const int ex = __shfl_down_sync(FULL, v, 1);
  return lane == 31 ? ident : ex;
}

// Row scans, run by one whole warp over a table of NROWS ints in shared
// memory, ROWS_PER_LANE consecutive rows a lane.
// tab[r] <- the combination of tab[0 .. r); returns that of all rows.
template <typename Op>
__device__ int rows_exclusive_scan(int* tab, Op op, int ident) {
  int* t = tab + lane_id() * ROWS_PER_LANE;
  int acc = ident;
  for (int i = 0; i < ROWS_PER_LANE; ++i) acc = op(acc, t[i]);
  int ex = warp_exclusive_up(acc, op, ident);
  const int total = __shfl_sync(FULL, op(ex, acc), 31);
  for (int i = 0; i < ROWS_PER_LANE; ++i) {
    const int v = t[i];
    t[i] = ex;
    ex = op(ex, v);
  }
  return total;
}

// tab[r] <- the combination of tab(r .. NROWS)
template <typename Op>
__device__ void rows_suffix_scan(int* tab, Op op, int ident) {
  int* t = tab + lane_id() * ROWS_PER_LANE;
  int acc = ident;
  for (int i = 0; i < ROWS_PER_LANE; ++i) acc = op(acc, t[i]);
  int ex = warp_exclusive_down(acc, op, ident);
  for (int i = ROWS_PER_LANE - 1; i >= 0; --i) {
    const int v = t[i];
    t[i] = ex;
    ex = op(ex, v);
  }
}

__device__ __forceinline__ void load4(const int32_t* p, int v[LANE_POS]) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void store4(int32_t* p, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

// ---------------------------------------------------------------------------
// lz4_match: replaces tpu7z/ops/lz4_pallas.py:58 _kernel_a1
//   (lz4_plane.phase0_words, phase1_nearest_offset, phase2_lengths)
//
// Bound: bytes. Per 64 KiB block it reads three candidate planes (768 KiB)
// and writes mlen and moff (512 KiB): 1.31 MB, 0.67 GB per 32 MiB, 0.200 ms
// at 3.35 TB/s. The run length at q is uncapped and crosses rows: it ends at
// the first break (no same nonzero offset at q+1) at or after q. Pass 1
// finds each row's first break per tier (a warp min); one warp's suffix
// min over the rows gives every row the first break in a later row. Pass 2
// reads the planes again, coalesced, and joins in-lane, in-row (a warp
// suffix min) and later-row breaks; the tier choice and the caps follow.
// Every plane moves as 16-byte lanes; reading the planes twice moves 1.6x
// the bound's bytes.
// With a tier-A window (W > 0, not the main path) the block's bytes go to
// shared memory and both passes recompute the nearest offset.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t word_at(const uint8_t* sb, int q) {
  return (uint32_t)sb[q] | ((uint32_t)sb[q + 1] << 8) |
         ((uint32_t)sb[q + 2] << 16) | ((uint32_t)sb[q + 3] << 24);
}

// tier A: the nearest o in 1..W with the same 4 bytes; 0 past the guard
__device__ int tier_a(const uint8_t* sb, int q, int W, int guard) {
  if (W == 0 || q >= guard) return 0;
  const uint32_t v = word_at(sb, q);
  for (int o = 1; o <= W && o <= q; ++o)
    if (word_at(sb, q - o) == v) return o;
  return 0;
}

constexpr int NTIERS = 4;  // A, so4a, so4b, so8: a later tier needs a longer run

__global__ void __launch_bounds__(ROW_THREADS)
lz4_match_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ so8, const int32_t* __restrict__ so4a,
                 const int32_t* __restrict__ so4b, int32_t* __restrict__ mlen_out,
                 int32_t* __restrict__ moff_out, int W) {
  extern __shared__ __align__(16) uint8_t sb[];  // BLOCK + 4 bytes when W > 0
  __shared__ int later_brk[NTIERS][NROWS];  // first break of each row, then of the later rows
  const int b = blockIdx.x, lane = lane_id(), warp = threadIdx.x >> 5;
  const size_t base = (size_t)b * BLOCK;
  const int n = ns[b];
  const int guard = max(n - TAIL_GUARD, 0);
  const int32_t* plane[NTIERS] = {nullptr, so4a + base, so4b + base, so8 + base};
  if (W > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(blocks + base);
    for (int i = threadIdx.x; i < BLOCK / 16; i += ROW_THREADS)
      reinterpret_cast<uint4*>(sb)[i] = src[i];
    if (threadIdx.x < 4) sb[BLOCK + threadIdx.x] = 0;
  }
  __syncthreads();
  const int p0 = LANE_POS * lane;  // the lane's first position in its row

  // tier k at the lane's positions q0 .. q0+3 into v; returns tier k at q0+4
  auto tier = [&](int k, int q0, int v[LANE_POS]) {
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < LANE_POS; ++j) v[j] = tier_a(sb, q0 + j, W, guard);
    } else {
      load4(plane[k] + q0, v);
    }
    int nxt = __shfl_down_sync(FULL, v[0], 1);
    if (lane == 31) {
      const int q = q0 + LANE_POS;
      nxt = q >= BLOCK ? 0 : k == 0 ? tier_a(sb, q, W, guard) : plane[k][q];
    }
    return nxt;
  };
  // bit j: a run breaks at q0+j (q0+j and the position after it do not
  // carry the same nonzero offset)
  auto breaks = [&](const int v[LANE_POS], int nxt) {
    int m = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      const int after = j + 1 < LANE_POS ? v[j + 1] : nxt;
      if (!(v[j] > 0 && after == v[j])) m |= 1 << j;
    }
    return m;
  };
  auto first_break = [&](int brk, int q0) { return brk ? q0 + __ffs(brk) - 1 : BLOCK; };

  // pass 1: each row's first break, per tier
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    const int q0 = r * ROW + p0;
#pragma unroll
    for (int k = 0; k < NTIERS; ++k) {
      if (k == 0 && W == 0) continue;
      int v[LANE_POS];
      const int nxt = tier(k, q0, v);
      const int row_first = __reduce_min_sync(FULL, first_break(breaks(v, nxt), q0));
      if (lane == 0) later_brk[k][r] = row_first;
    }
  }
  __syncthreads();
  if (warp < NTIERS && (warp > 0 || W > 0)) rows_suffix_scan(later_brk[warp], MinOp(), BLOCK);
  __syncthreads();

  // pass 2: run lengths, the tier choice, the caps
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    const int q0 = r * ROW + p0;
    int ml[LANE_POS] = {0, 0, 0, 0}, mo[LANE_POS] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < NTIERS; ++k) {
      if (k == 0 && W == 0) continue;
      int v[LANE_POS];
      const int nxt = tier(k, q0, v);
      const int brk = breaks(v, nxt);
      // the first break after the lane: in the lanes above, else a later row
      int at = min(warp_exclusive_down(first_break(brk, q0), MinOp(), BLOCK),
                   later_brk[k][r]);
      const int kmin = k == NTIERS - 1 ? MIN_MATCH_B : MIN_MATCH;
#pragma unroll
      for (int j = LANE_POS - 1; j >= 0; --j) {
        if ((brk >> j) & 1) at = q0 + j;
        const int run = v[j] > 0 ? at - (q0 + j) + kmin : 0;
        if (run > ml[j]) {
          ml[j] = run;
          mo[j] = v[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      const int q = q0 + j;
      int m = min(ml[j], max(n - END_LITERALS - q, 0));
      m = min(m, ROW - (p0 + j));
      const bool ok = m >= MIN_MATCH && q < guard && mo[j] > 0;
      ml[j] = ok ? m : 0;
      mo[j] = ok ? mo[j] : 0;
    }
    store4(mlen_out + base + q0, ml[0], ml[1], ml[2], ml[3]);
    store4(moff_out + base + q0, mo[0], mo[1], mo[2], mo[3]);
  }
}

// ---------------------------------------------------------------------------
// lz4_parse: replaces tpu7z/ops/lz4_pallas.py:72 _kernel_a2
//   (lz4_plane.phase3_parse)
//
// A cursor walks each 128-position row from 0. At c it takes a match
// (is_start[c] = 1, c += mlen[c]) when mlen[c] >= MIN_MATCH and it does not
// defer, else c += 1; it defers when c + 1 < ROW and mlen[c+1] > mlen[c] + 1
// (one-step lazy matching). Whether position p is taken when the cursor
// stands on it depends on mlen[p] and mlen[p+1] alone, not on the path. So
// the first start at or after the cursor is the first take at or after
// it, and the walk jumps from one start to the next: at most 32 starts a
// row (each moves the cursor by MIN_MATCH or more), not 128 steps.
//
// A group of 4 lanes a row, eight rows a warp, no shared memory. Lane i of
// a group holds positions 16k + 4i .. 16k + 4i + 3 of its row for spans
// k = 0..7 as eight 16-byte loads; each load instruction reads 64
// contiguous bytes of each of the warp's eight rows, and the eight loads
// the rows' 4 KiB whole. The neighbour of a lane's last position in a span
// comes from the next lane, or from lane 0's next span, by shuffles within
// the group; position 127 has none, so never defers. Each lane tables, for
// each of its 32 positions p, the next take t at or after p and the cursor
// after it, packed as t << 8 | min(t + mlen[t], ROW) (NO_TAKE above every
// real entry): in the lane, then from the lanes above in the span by a
// suffix min within the group, then from the later spans (a smaller t
// packs smaller). Two 16-bit entries go to a register. The walk: the lane
// picks its entry c & 3 of span c / 16 (a tree of selects and a byte
// permute: no register array is indexed at run time, so nothing goes to
// local memory), and one shuffle from lane (c >> 2) & 3 of the group gives
// t and the next cursor; lane (t >> 2) & 3 marks start t. A row's walk
// ends when no take is left at or after c or c reaches the row end; it
// then reads NO_TAKE, so the walk has no branch but the loop's. The eight
// groups walk at once, so one warp instruction serves eight rows, until
// the last of them ends. Lane i then stores its 4 is_start bytes of each
// span as one 4-byte store (16 contiguous bytes a group). A 256-thread
// CTA takes 64 rows and the grid is B * 8 CTAs. The warps resident on an
// SM hide one another's loads, so a warp does not prefetch its next rows
// (a form that did was slower, PERF.md section 6).
//
// The SM's integer units (16 lanes a clock per sub-partition) set the
// pace, not the bytes: the walk's steps are serial in a row, so what
// counts is how many rows a warp instruction serves (the forms measured,
// from a warp a row to this one, are in PERF.md, section 6).
//
// No int32 overflows, so the kernel equals the plain version (int64) on
// any int32 plane: defer compares after with mlen + 1 saturated at INT_MAX
// (nothing is greater), and a take's cursor is t + min(mlen[t], ROW - t).
//
// Bound: bytes. mlen at each cursor position and the one after it, and
// is_start written (chip_smoke.py, Stages.bytes_moved): 0.029 ms over the
// 32 MiB corpus at 3.35 TB/s. This design reads the whole plane: 5 bytes a
// position, 167,772,160 bytes per 32 MiB, a floor of 0.050 ms.
// ---------------------------------------------------------------------------

constexpr int PARSE_THREADS = 256;
constexpr int WARP_ROWS = 8;                   // rows a warp walks at once
constexpr int ROW_LANES = 32 / WARP_ROWS;       // lanes a row
constexpr int PARSE_ROWS = PARSE_THREADS / ROW_LANES;  // rows a CTA
constexpr int SPAN = ROW_LANES * LANE_POS;      // positions a load covers in a row
constexpr int SPANS = ROW / SPAN;               // 16-byte loads a lane and row
constexpr int LANE_SHIFT = 2;                   // log2(ROW_LANES)
constexpr unsigned NO_TAKE = 0xff80u;  // t 255, cursor ROW: above every real entry
static_assert(ROW_LANES == 1 << LANE_SHIFT && NROWS % WARP_ROWS == 0, "8 rows a warp");
static_assert(SPANS * LANE_POS <= 32, "a lane's starts fit one 32-bit mask");

__device__ __forceinline__ void load_row(const int32_t* src, int m[SPANS][LANE_POS]) {
#pragma unroll
  for (int k = 0; k < SPANS; ++k) load4(src + k * SPAN, m[k]);
}

// t[k][h] for a run-time k, by a tree of selects over k's bits (an index
// into a register array would put the array in local memory)
template <int LO, int N>
__device__ __forceinline__ unsigned pick_span(const unsigned (&t)[SPANS][2], unsigned k, int h) {
  if constexpr (N == 1) {
    return t[LO][h];
  } else {
    return k & (N / 2) ? pick_span<LO + N / 2, N / 2>(t, k, h) : pick_span<LO, N / 2>(t, k, h);
  }
}

__global__ void __launch_bounds__(PARSE_THREADS)
lz4_parse_kernel(const int32_t* __restrict__ mlen, uint8_t* __restrict__ is_start) {
  const int i = threadIdx.x % ROW_LANES;  // lane i of the row's group
  const long long row = (long long)blockIdx.x * PARSE_ROWS + threadIdx.x / ROW_LANES;
  int m[SPANS][LANE_POS];
  load_row(mlen + row * ROW + LANE_POS * i, m);
  // the next take at or after each of the lane's positions, in the lane
  unsigned e[SPANS][LANE_POS];
#pragma unroll
  for (int k = 0; k < SPANS; ++k) {
    const int down = __shfl_down_sync(FULL, m[k][0], 1, ROW_LANES);
    const int first = __shfl_sync(FULL, m[(k + 1) % SPANS][0], 0, ROW_LANES);
    unsigned acc = NO_TAKE;
#pragma unroll
    for (int j = LANE_POS - 1; j >= 0; --j) {
      const int p = k * SPAN + LANE_POS * i + j;
      const bool last = j == LANE_POS - 1;
      const bool has_next = !last || i + 1 < ROW_LANES || k + 1 < SPANS;
      const int after = !last ? m[k][j + 1] : i + 1 < ROW_LANES ? down : first;
      // mlen + 1 saturates at INT_MAX, where nothing is greater
      const bool defer = has_next && after > min(m[k][j], 0x7ffffffe) + 1;
      if (m[k][j] >= MIN_MATCH && !defer)
        acc = (unsigned)((p << 8) + p + min(m[k][j], ROW - p));
      e[k][j] = acc;
    }
  }
  // then from the lanes above in the span, then from the later spans
  unsigned later = NO_TAKE;
#pragma unroll
  for (int k = SPANS - 1; k >= 0; --k) {
    unsigned v = e[k][0];
#pragma unroll
    for (int d = 1; d < ROW_LANES; d <<= 1) {
      const unsigned o = __shfl_down_sync(FULL, v, d, ROW_LANES);
      if (i + d < ROW_LANES) v = min(v, o);
    }
    const unsigned above = __shfl_down_sync(FULL, v, 1, ROW_LANES);
    const unsigned rest = i + 1 < ROW_LANES ? min(above, later) : later;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) e[k][j] = min(e[k][j], rest);
    later = min(later, __shfl_sync(FULL, v, 0, ROW_LANES));
  }
  unsigned tab[SPANS][2];  // entries 2h and 2h + 1 of span k
#pragma unroll
  for (int k = 0; k < SPANS; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) tab[k][h] = e[k][2 * h] | e[k][2 * h + 1] << 16;

  // The walks of the warp's rows, from start to start. A row whose walk
  // has ended reads NO_TAKE, whose cursor is ROW again and whose t (bit
  // 15 of the entry set) marks nothing.
  unsigned st = 0;  // bit 4k + j: position k * SPAN + 4i + j starts a match
  unsigned c = 0;
  // the entry's t names this lane: t < ROW and (t >> 2) % ROW_LANES == i
  constexpr unsigned lane_mask = 0x8000u | (ROW_LANES - 1) << 10;
  const unsigned lane_key = (unsigned)i << 10;
  // at most 32 starts a row; the bound of ROW steps makes the end evident
  for (int step = 0; step < ROW && __any_sync(FULL, c < ROW); ++step) {
    // the lane's entry c & 3 of span c / SPAN (the byte permute takes its
    // 16 bits from the span's two registers; the upper half is unused)
    const unsigned k = c / SPAN;
    const unsigned own = c < ROW ? __byte_perm(pick_span<0, SPANS>(tab, k, 0),
                                               pick_span<0, SPANS>(tab, k, 1),
                                               0x10u + (c & 3) * 0x22u)
                                 : NO_TAKE;
    const unsigned v = __shfl_sync(FULL, own, (c >> 2) % ROW_LANES, ROW_LANES);
    if ((v & lane_mask) == lane_key)
      st |= 1u << ((v >> (10 + LANE_SHIFT) & (SPANS - 1)) << 2 | (v >> 8 & 3u));
    c = v & 0xffu;
  }
  uint8_t* dst = is_start + row * ROW + LANE_POS * i;
#pragma unroll
  for (int k = 0; k < SPANS; ++k)  // bits 4k .. 4k+3 of st to 4 bytes of 0/1
    *reinterpret_cast<uint32_t*>(dst + k * SPAN) =
        (st >> 4 * k & 0xfu) * 0x204081u & 0x01010101u;
}

// ---------------------------------------------------------------------------
// lz4_geometry: replaces tpu7z/ops/lz4_pallas.py:77 _kernel_a3
//   (lz4_plane.phase4_geometry)
//
// Bound: bytes. Per 64 KiB block it reads is_start (64 KiB) and mlen and
// moff where a match starts, and writes 14 int32 planes (3.5 MiB): 1.93 GB
// per 32 MiB, 0.577 ms at 3.35 TB/s. Nearly all of it is the stores, so
// every plane is written once, as one 16-byte store a lane (512 contiguous
// bytes a warp instruction), and nothing is read back. Four passes over the
// rows, separated by barriers: (1) starts and covered (an in-row max scan
// of each start's reach) as ballot masks in shared memory, and the row's
// summaries for the odd-row continuation; (2) each row's first head;
// (3) the row totals of glen and gap_here; (4) every plane. Between them
// one warp joins the row summaries: the continuation, a suffix max (the
// next head after each row) and two exclusive prefix sums (the bases of
// core_pos and gap_before). Passes 2-4 read mlen again (coalesced, 256 KiB
// a pass) rather than keep it on chip, and read moff only where a match
// ends at its row end.
// ---------------------------------------------------------------------------

// One position's sequence geometry: L (0 unless an anchor), mlc (0 unless
// a head) and flags: bit 0 kept, 1 anchor, 2 head, bits 4-7 the length
// nibble of the next head at or after the position.
struct GeoPos {
  int L, mlc, f;
  __device__ bool kept() const { return f & 1; }
  __device__ bool anchor() const { return (f >> 1) & 1; }
  __device__ bool head() const { return (f >> 2) & 1; }
  __device__ int nib() const { return f >> 4; }
  __device__ int e() const { return L >= 15 ? (L - 15) / 255 + 1 : 0; }
  __device__ bool ml_ext() const { return head() && mlc >= 15; }
  __device__ int glen() const {
    return (int)kept() + (anchor() ? 1 + min(e(), 1) : 0) + (head() ? 2 + (int)ml_ext() : 0);
  }
  __device__ int gap_here() const { return L >= LONG_LIT ? max(e() - 1, 0) : 0; }
};

__global__ void __launch_bounds__(ROW_THREADS)
lz4_geometry_kernel(const int32_t* __restrict__ mlen, const int32_t* __restrict__ moff,
                    const uint8_t* __restrict__ is_start, const int32_t* __restrict__ ns,
                    int32_t* __restrict__ geo, int32_t* __restrict__ core_used,
                    int32_t* __restrict__ used) {
  // bit l of [r][j]: position r*ROW + 4l + j starts a match / is covered
  __shared__ uint32_t start_bits[NROWS][LANE_POS];
  __shared__ uint32_t cov_bits[NROWS][LANE_POS];
  __shared__ int end_off[NROWS];   // moff of the start whose match ends at the row end
  // mlen and moff of a start at the row's first position; after the join,
  // those of the odd-row continuation there, else 0
  __shared__ int cont_len[NROWS];
  __shared__ int cont_off[NROWS];
  __shared__ int next_enc[NROWS];   // the row's first head's enc, then the later rows'
  __shared__ int glen_base[NROWS];  // row totals, then their exclusive prefix sums
  __shared__ int gap_base[NROWS];
  __shared__ int totals[2];
  const int b = blockIdx.x, lane = lane_id(), warp = threadIdx.x >> 5;
  const size_t base = (size_t)b * BLOCK;
  const int n = ns[b];
  const int32_t* ml = mlen + base;
  const int32_t* mo = moff + base;
  const uint8_t* is = is_start + base;
  int32_t* g = geo + (size_t)b * G_NPLANES * BLOCK;
  const int p0 = LANE_POS * lane;  // the lane's first position in its row

  // pass 1: starts, covered (the in-row running max of each start's reach
  // passes the position), the match ending at the row end, the first start
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    const int q0 = r * ROW + p0;
    int m[LANE_POS];
    load4(ml + q0, m);
    const uint32_t s4 = *reinterpret_cast<const uint32_t*>(is + q0);
    bool st[LANE_POS];
    int reach[LANE_POS], acc = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      st[j] = ((s4 >> (8 * j)) & 0xFF) && q0 + j < n;
      if (st[j]) acc = max(acc, p0 + j + m[j]);
      reach[j] = acc;
    }
    const int below = warp_exclusive_up(acc, MaxOp(), 0);
    int eo = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      const bool cov = q0 + j < n && p0 + j < max(below, reach[j]);
      const uint32_t sbits = __ballot_sync(FULL, st[j]);
      const uint32_t cbits = __ballot_sync(FULL, cov);
      if (lane == 0) {
        start_bits[r][j] = sbits;
        cov_bits[r][j] = cbits;
      }
      if (st[j] && p0 + j + m[j] == ROW) eo = max(eo, mo[q0 + j]);
    }
    eo = __reduce_max_sync(FULL, eo);
    if (lane == 0) {
      end_off[r] = eo;
      cont_len[r] = st[0] ? m[0] : 0;
      cont_off[r] = st[0] ? mo[q0] : 0;
    }
  }
  __syncthreads();

  // the odd-row continuation: a start at an odd row's first position with
  // the offset of the previous row's match that ends at the row end
  for (int r = threadIdx.x; r < NROWS; r += ROW_THREADS) {
    const bool cont = (r & 1) && (start_bits[r][0] & 1) && end_off[r - 1] > 0 &&
                      cont_off[r] == end_off[r - 1];
    if (!cont) {
      cont_len[r] = 0;
      cont_off[r] = 0;
    }
  }
  __syncthreads();

  // The lane's heads (starts that are no continuation) in row r as bits,
  // their merged match-length codes (a head ending at the row end absorbs
  // the next row's continuation) and enc = (BLOCK - q) * 16 + min(mlc, 15).
  auto heads = [&](int r, int q0, int mlc[LANE_POS], int enc[LANE_POS]) {
    int m[LANE_POS];
    load4(ml + q0, m);
    const int ncl = r + 1 < NROWS ? cont_len[r + 1] : 0;
    const int nco = r + 1 < NROWS ? cont_off[r + 1] : 0;
    int hb = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      const bool hd = ((start_bits[r][j] >> lane) & 1) &&
                      !(j == 0 && lane == 0 && cont_off[r] > 0);
      mlc[j] = 0;
      enc[j] = 0;
      if (hd) {
        const bool add = p0 + j + m[j] == ROW && ncl > 0 && mo[q0 + j] == nco;
        mlc[j] = m[j] + (add ? ncl : 0) - MIN_MATCH;
        enc[j] = (BLOCK - (q0 + j)) * 16 + min(mlc[j], 15);
        hb |= 1 << j;
      }
    }
    return hb;
  };

  // pass 2: each row's first head (the largest enc)
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    int mlc[LANE_POS], enc[LANE_POS];
    heads(r, r * ROW + p0, mlc, enc);
    const int e = __reduce_max_sync(FULL, max(max(enc[0], enc[1]), max(enc[2], enc[3])));
    if (lane == 0) next_enc[r] = e;
  }
  __syncthreads();
  if (warp == 0) rows_suffix_scan(next_enc, MaxOp(), 0);
  __syncthreads();

  auto positions = [&](int r, int q0, GeoPos p[LANE_POS]) {
    int mlc[LANE_POS], enc[LANE_POS];
    const int hb = heads(r, q0, mlc, enc);
    // the next head at or after each position: in the lane, in the lanes
    // above, in a later row
    int suf[LANE_POS], acc = 0;
#pragma unroll
    for (int j = LANE_POS - 1; j >= 0; --j) {
      acc = max(acc, enc[j]);
      suf[j] = acc;
    }
    const int later = max(warp_exclusive_down(acc, MaxOp(), 0), next_enc[r]);
    bool prev_cov = lane ? (cov_bits[r][LANE_POS - 1] >> (lane - 1)) & 1
                         : r > 0 && (cov_bits[r - 1][LANE_POS - 1] >> 31);
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      const int q = q0 + j;
      const bool in_range = q < n;
      const bool hd = (hb >> j) & 1;
      const bool cov = (cov_bits[r][j] >> lane) & 1;
      const bool anchor = in_range && (q == 0 || (prev_cov && (hd || !cov)));
      const int best = max(suf[j], later);
      const int next_start = min(best > 0 ? BLOCK - (best >> 4) : n, n);
      const int nib = best > 0 ? (best & 15) : 0;
      p[j].L = anchor ? next_start - q : 0;
      p[j].mlc = mlc[j];
      p[j].f = (int)(in_range && !cov) | (int)anchor << 1 | (int)hd << 2 | nib << 4;
      prev_cov = cov;
    }
  };

  // pass 3: each row's glen and gap_here totals
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    GeoPos p[LANE_POS];
    positions(r, r * ROW + p0, p);
    int gl = 0, gp = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      gl += p[j].glen();
      gp += p[j].gap_here();
    }
    gl = __reduce_add_sync(FULL, gl);
    gp = __reduce_add_sync(FULL, gp);
    if (lane == 0) {
      glen_base[r] = gl;
      gap_base[r] = gp;
    }
  }
  __syncthreads();
  if (warp < 2) {
    const int total = rows_exclusive_scan(warp ? gap_base : glen_base, SumOp(), 0);
    if (lane == 0) totals[warp] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    core_used[b] = totals[0];
    used[b] = totals[0] + totals[1];
  }

  // pass 4: every plane; core_pos and gap_before from the row bases
  for (int r = warp; r < NROWS; r += ROW_WARPS) {
    const int q0 = r * ROW + p0;
    GeoPos p[LANE_POS];
    positions(r, q0, p);
    int gl[LANE_POS], gp[LANE_POS], sl = 0, sp = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      gl[j] = p[j].glen();
      gp[j] = p[j].gap_here();
      sl += gl[j];
      sp += gp[j];
    }
    int cp[LANE_POS], gb[LANE_POS];
    cp[0] = glen_base[r] + warp_exclusive_up(sl, SumOp(), 0);
    gb[0] = gap_base[r] + warp_exclusive_up(sp, SumOp(), 0);
#pragma unroll
    for (int j = 1; j < LANE_POS; ++j) {
      cp[j] = cp[j - 1] + gl[j - 1];
      gb[j] = gb[j - 1] + gp[j - 1];
    }
    auto put = [&](int plane, auto f) {
      store4(g + plane * BLOCK + q0, f(0), f(1), f(2), f(3));
    };
    put(G_KEPT, [&](int j) { return (int)p[j].kept(); });
    put(G_ANCHOR, [&](int j) { return (int)p[j].anchor(); });
    put(G_MSTART, [&](int j) { return (int)p[j].head(); });
    put(G_TOKEN, [&](int j) {
      return p[j].anchor() ? min(p[j].L, 15) << 4 | p[j].nib() : 0;
    });
    put(G_LITREM, [&](int j) { return p[j].L >= 15 ? (p[j].L - 15) % 255 : 0; });
    put(G_E, [&](int j) { return p[j].e(); });
    put(G_GAP255, [&](int j) { return max(p[j].e() - 1, 0); });
    put(G_LONG_RUN, [&](int j) { return (int)(p[j].L >= LONG_LIT); });
    put(G_MLC, [&](int j) { return p[j].mlc; });
    put(G_ML_EXT, [&](int j) { return (int)p[j].ml_ext(); });
    put(G_GLEN, [&](int j) { return gl[j]; });
    put(G_CORE_POS, [&](int j) { return cp[j]; });
    put(G_GAP_HERE, [&](int j) { return gp[j]; });
    put(G_GAP_BEFORE, [&](int j) { return gb[j]; });
  }
}

// ---------------------------------------------------------------------------
// lz4_emit: replaces tpu7z/ops/lz4_pallas.py:108 _kernel_b1, :120 _kernel_b2
//   and :127 _kernel_c (lz4_plane.emit_ref: phase6_expand of phase5_core)
//
// Writes each block's LZ4 bytes straight into out; no core buffer exists.
// Position p's bytes run from o(p) = core_pos + gap_before: the token, a
// long run's 255-bytes, litrem, the literal, offset lo and hi, the
// match-length extension.
//
// One warp takes one 128-position row, 4 positions a lane; glen and kept
// arrive as one 16-byte load a lane each (512 contiguous bytes a warp
// instruction). Which bytes a position writes follows from them, by the
// definitions of lz4_plane.phase4_geometry, so anchor, mstart, e and
// ml_ext are never read:
//   - a position emits where glen > 0, and is then either kept or a match
//     start (mstart; matches cover their start);
//   - it is an anchor where it emits and is position 0 or follows a
//     position that is not kept;
//   - glen = kept + (1 + [e >= 1] at an anchor) + (2 + ml_ext at a match
//     start), and an anchor at a match start holds no literals (e = 0):
//     so e >= 1 where a kept anchor has glen 3, and ml_ext where a match
//     start has glen 3, or 4 at an anchor.
// The other inputs are read as the lane's 16 bytes only where one of its
// positions needs them: token at an anchor, litrem where e >= 1, moff at a
// match start, mlc where ml_ext, the 4 block bytes where kept.
//
// o(p) is the row's first offset S (core_pos + gap_before, read once a
// row), plus the glen of the row's positions before p (a warp scan), plus
// the row's 255-run where that comes before p. A long run needs 270
// literals, so a row holds at most one, after its last anchor's token, and
// its length is what the row's span holds beyond its glen: E - S - sum of
// glen, E being the next row's S (used after the last row).
//
// A row's bytes are the span [S, E): at most 4 bytes a position (an
// anchor at a match start holds no literals, one before literals no
// match) and 256 bytes of 255, 768 bytes. The warp builds the span in
// shared memory at its offset within its first 16-byte word, the whole
// warp filling the 255-run, then stores the span's whole words as 16-byte
// stores and its ragged ends byte by byte, so rows meet without two
// writing one byte. The CTAs of a block zero [used, OUT_CAP), 16 bytes a
// store past used's own word.
//
// Bound: bytes. glen everywhere, kept where it or the next position
// emits, the field each sequence part needs where it emits, two offsets a
// row, used, and out written (86.5 KiB a block); chip_smoke.py
// (Stages.bytes_moved) counts it for each run's data.
// ---------------------------------------------------------------------------

constexpr int EMIT_WARPS = 8;                         // rows a CTA, one a warp
constexpr int EMIT_THREADS = 32 * EMIT_WARPS;
constexpr int EMIT_CTAS_PER_BLOCK = NROWS / EMIT_WARPS;
constexpr int EMIT_CTAS_PER_SM = 5;  // 48 registers a thread; at 6 it spills
constexpr int SPAN_CAP = 1024;                        // staging bytes a warp
static_assert(4 * ROW + 256 + 15 <= SPAN_CAP, "a row's span and its word offset fit");
static_assert(OUT_CAP % 16 == 0, "each block's out starts on a 16-byte boundary");

// The lane's 16 bytes of a plane where `need`, else zeros
__device__ __forceinline__ void load4_if(bool need, const int32_t* p, int v[LANE_POS]) {
  if (need) {
    load4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) v[j] = 0;
  }
}

__global__ void __launch_bounds__(EMIT_THREADS, EMIT_CTAS_PER_SM)
lz4_emit_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ moff,
                const int32_t* __restrict__ geo, const int32_t* __restrict__ used,
                uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t stage[EMIT_WARPS][SPAN_CAP];
  const int b = blockIdx.x / EMIT_CTAS_PER_BLOCK, cta = blockIdx.x % EMIT_CTAS_PER_BLOCK;
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  const int r = cta * EMIT_WARPS + warp;
  const size_t base = (size_t)b * BLOCK;
  const int32_t* g = geo + (size_t)b * G_NPLANES * BLOCK;
  uint8_t* dst = out + (size_t)b * OUT_CAP;
  const int u = used[b];

  // zeros from used on: the rest of used's word byte by byte, then whole
  // words, spread over the block's CTAs
  {
    const int w0 = (u + 15) >> 4;
    const int t = cta * EMIT_THREADS + threadIdx.x;
    if (t < 16 * w0 - u) dst[u + t] = 0;
    for (int w = w0 + t; w < OUT_CAP / 16; w += EMIT_CTAS_PER_BLOCK * EMIT_THREADS)
      reinterpret_cast<uint4*>(dst)[w] = make_uint4(0, 0, 0, 0);
  }

  const int q0 = r * ROW + LANE_POS * lane;
  int gl[LANE_POS], kp[LANE_POS];
  load4(g + G_GLEN * BLOCK + q0, gl);
  load4(g + G_KEPT * BLOCK + q0, kp);
  // lane 0: the row's first offset, and whether the position before the
  // row is kept (not at position 0); lane 31: the next row's first offset
  int edge = 0, prev_kept = 0;
  if (lane == 0) {
    edge = g[G_CORE_POS * BLOCK + q0] + g[G_GAP_BEFORE * BLOCK + q0];
    if (q0 > 0) prev_kept = g[G_KEPT * BLOCK + q0 - 1];
  } else if (lane == 31) {
    const int q = q0 + LANE_POS;
    edge = q < BLOCK ? g[G_CORE_POS * BLOCK + q] + g[G_GAP_BEFORE * BLOCK + q] : u;
  }
  const int S = __shfl_sync(FULL, edge, 0), E = __shfl_sync(FULL, edge, 31);
  if (S >= E) return;  // the row emits nothing (the whole warp)

  // the flags of each position, as bits j of the lane's masks
  const int up = __shfl_up_sync(FULL, kp[LANE_POS - 1], 1);
  if (lane > 0) prev_kept = up;
  unsigned an = 0, hd = 0, e1 = 0, ext = 0, kept = 0;
  int lane_glen = 0, last_an = -1;
#pragma unroll
  for (int j = 0; j < LANE_POS; ++j) {
    const bool emits = gl[j] > 0, k = kp[j] != 0;
    const bool a_j = emits && !prev_kept, h_j = emits && !k;
    an |= (unsigned)a_j << j;
    hd |= (unsigned)h_j << j;
    kept |= (unsigned)k << j;
    e1 |= (unsigned)(a_j && k && gl[j] == 3) << j;
    ext |= (unsigned)(h_j && gl[j] == (a_j ? 4 : 3)) << j;
    if (a_j) last_an = j;
    lane_glen += gl[j];
    prev_kept = kp[j];
  }

  // offsets: the row's glen before each position, and its 255-run (G
  // bytes after the token of the row's last anchor, in lane run_lane)
  const int before = warp_exclusive_up(lane_glen, SumOp(), 0);
  const int G = E - S - __shfl_sync(FULL, before + lane_glen, 31);
  const unsigned anchors = __ballot_sync(FULL, an != 0);
  const int run_lane = G > 0 && anchors ? 31 - __clz(anchors) : 32;
  const int run_j = lane == run_lane ? last_an : -1;
  int o[LANE_POS];
  {
    int at = S + before + (lane > run_lane ? G : 0);
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) {
      o[j] = at;
      at += gl[j] + (j == run_j ? G : 0);
    }
  }

  // byte i of out goes to sp[i - a]; a span holds at most 4 bytes a
  // position and one 255-run, so it fits (the static_assert on SPAN_CAP)
  const int a = S & ~15;
  uint8_t* sp = stage[warp];

  int tk[LANE_POS], lr[LANE_POS], mc[LANE_POS], mo[LANE_POS];
  load4_if(an, g + G_TOKEN * BLOCK + q0, tk);
  load4_if(e1, g + G_LITREM * BLOCK + q0, lr);
  load4_if(ext, g + G_MLC * BLOCK + q0, mc);
  load4_if(hd, moff + base + q0, mo);
  const uint32_t lit = kept ? *reinterpret_cast<const uint32_t*>(blocks + base + q0) : 0u;

  // the 255-run, filled by the whole warp
  if (run_lane < 32) {
    int from = 0;
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j)
      if (j == run_j) from = o[j] + 1 - a;
    from = __shfl_sync(FULL, from, run_lane);
    for (int i = lane; i < G; i += 32) sp[from + i] = 255;
  }
  // each position's own bytes
#pragma unroll
  for (int j = 0; j < LANE_POS; ++j) {
    if (gl[j] == 0) continue;
    int k = o[j] - a;
    if (an >> j & 1) {
      sp[k++] = (uint8_t)tk[j];
      if (j == run_j) k += G;
      if (e1 >> j & 1) sp[k++] = (uint8_t)lr[j];
    }
    if (kept >> j & 1) sp[k++] = (uint8_t)(lit >> (8 * j));
    if (hd >> j & 1) {
      sp[k++] = (uint8_t)mo[j];
      sp[k++] = (uint8_t)(mo[j] >> 8);
      if (ext >> j & 1) sp[k] = (uint8_t)(mc[j] - 15);
    }
  }
  __syncwarp();

  // the span to out: whole 16-byte words as such, the ragged ends by byte
  for (int w = a + 16 * lane; w < E; w += 16 * 32) {
    if (w >= S && w + 16 <= E) {
      *reinterpret_cast<uint4*>(dst + w) = *reinterpret_cast<const uint4*>(sp + (w - a));
    } else {
      for (int i = max(w, S); i < min(w + 16, E); ++i) dst[i] = sp[i - a];
    }
  }
}

// ---------------------------------------------------------------------------
// lz4_keys and lz4_probe: replace no Pallas kernel. The JAX package left
//   its sorted-neighbour tiers to XLA (tpu7z/ops/lz4_plane.py:174-248,
//   tier_b_candidates and tier_b4_candidates: a lax.sort by hash, the K = 2
//   probes, a lax.sort back). Here lz4_keys writes both tiers' keys, one
//   sort_rows launch (csrc/sort.cu) sorts their 2B rows by the hash, and
//   lz4_probe verifies each sorted entry's two predecessors and puts the
//   offsets back in position order (lz4_plane.candidate_keys,
//   candidate_probe). No int64 plane exists on the way.
//
// lz4_keys: keys[0][b][p] = hash16(8 bytes at p) << 16 | p and keys[1][b][p]
// = hash16(4 bytes at p) << 16 | p, the hashes mod 2^32, the bytes zero past
// the block's end. A thread takes 4 positions: three aligned words of the
// block (its positions' 8-byte windows end 11 bytes on), two 16-byte stores.
// Bound: bytes. Per 64 KiB block it reads the block and writes two int32
// planes (576 KiB): 302 MB per 32 MiB, 0.090 ms at 3.35 TB/s.
//
// lz4_probe: one CTA a (block, plane), 3B CTAs, the three of a block next to
// one another so the block and tier B4's keys meet in L2. The block's bytes
// go to shared memory with a zero pad, for the byte compares; each sorted
// entry i compares its hash and its bytes (8 for so8, 4 for so4a and so4b)
// with entries i-1 and i-2 of its row and writes its offset, as 16 bits
// (offsets lie in 1..65535), at its own position of the plane staged in
// shared memory. The sorted keys are a permutation of the positions, so
// every staged word is written once and nothing is zero-filled. The plane
// then goes out as coalesced 16-byte stores with the tail guard applied:
// the random scatter never reaches device memory. 64 KiB + 128 KiB of
// shared memory, so one 1024-thread CTA an SM.
// Bound: bytes. By contract per block: the block and both tiers' sorted
// keys read once, ns, the three planes written (1.31 MiB): 706 MB per
// 32 MiB, 0.211 ms at 3.35 TB/s. The design reads the block three times
// and tier B4's keys twice (1.69 MiB a block), the extra reads mostly from
// L2; its shared-memory work (the byte windows, the scatter) is about 10
// shared accesses an entry.
// ---------------------------------------------------------------------------

constexpr uint32_t HASH_C1 = 0x9E3779B1u;
constexpr uint32_t HASH_C2 = 0x85EBCA77u;
constexpr int BLOCK_WORDS = BLOCK / 4;
constexpr int KEYS_THREADS = 256;
constexpr int PROBE_THREADS = 1024;
constexpr int PROBE_PAD = 16;  // zero bytes past the block: the last 8-byte window's words
constexpr int PROBE_SMEM = BLOCK + PROBE_PAD + 2 * BLOCK;  // the block, then the plane as u16
constexpr int PROBE_PLANES = 3;  // so8, so4a, so4b
static_assert(BLOCK_WORDS % KEYS_THREADS == 0, "whole CTAs a block");
constexpr int PROBE_SWEEPS = BLOCK / (LANE_POS * PROBE_THREADS);  // 4 entries a thread a sweep
static_assert(BLOCK % (LANE_POS * PROBE_THREADS) == 0, "whole sweeps of the sorted row");

__global__ void __launch_bounds__(KEYS_THREADS)
lz4_keys_kernel(const uint8_t* __restrict__ blocks, int32_t* __restrict__ keys, int B) {
  const long long t = (long long)blockIdx.x * KEYS_THREADS + threadIdx.x;
  const int b = (int)(t / BLOCK_WORDS), w = (int)(t % BLOCK_WORDS);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(blocks + (size_t)b * BLOCK);
  const uint32_t w0 = src[w];
  const uint32_t w1 = w + 1 < BLOCK_WORDS ? src[w + 1] : 0u;
  const uint32_t w2 = w + 2 < BLOCK_WORDS ? src[w + 2] : 0u;
  const int q = LANE_POS * w;
  int kb[LANE_POS], k4[LANE_POS];
#pragma unroll
  for (int j = 0; j < LANE_POS; ++j) {
    const uint32_t lo = __funnelshift_r(w0, w1, 8 * j);  // bytes q+j .. q+j+3
    const uint32_t hi = __funnelshift_r(w1, w2, 8 * j);  // bytes q+j+4 .. q+j+7
    const uint32_t m = lo * HASH_C1;
    kb[j] = (int)(((m ^ hi * HASH_C2) >> 16) << 16 | (uint32_t)(q + j));
    k4[j] = (int)((m >> 16) << 16 | (uint32_t)(q + j));
  }
  int32_t* dst = keys + (size_t)b * BLOCK + q;
  store4(dst, kb[0], kb[1], kb[2], kb[3]);
  store4(dst + (size_t)B * BLOCK, k4[0], k4[1], k4[2], k4[3]);
}

__global__ void __launch_bounds__(PROBE_THREADS)
lz4_probe_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ skeys,
                 const int32_t* __restrict__ ns, int32_t* __restrict__ so, int B) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* stage = reinterpret_cast<uint16_t*>(smem + BLOCK + PROBE_PAD);
  const int b = blockIdx.x / PROBE_PLANES, plane = blockIdx.x % PROBE_PLANES;
  const int lane = lane_id();
  const size_t base = (size_t)b * BLOCK;
  const int32_t* sk = skeys + (plane ? (size_t)B * BLOCK : 0) + base;  // tier B, else B4
  const bool wide = plane == 0;  // tier B carries 8 bytes
  {
    const uint4* src = reinterpret_cast<const uint4*>(blocks + base);
#pragma unroll
    for (int i = 0; i < BLOCK / 16 / PROBE_THREADS; ++i)
      reinterpret_cast<uint4*>(smem)[i * PROBE_THREADS + threadIdx.x] =
          src[i * PROBE_THREADS + threadIdx.x];
    if (threadIdx.x < PROBE_PAD / 4) reinterpret_cast<uint32_t*>(smem + BLOCK)[threadIdx.x] = 0;
  }
  __syncthreads();
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);

  // entries i0-2 .. i0+3 of the sorted row: their keys and byte windows
  constexpr int NE = LANE_POS + 2;
#pragma unroll 1
  for (int it = 0; it < PROBE_SWEEPS; ++it) {
    const int i0 = LANE_POS * (it * PROBE_THREADS + threadIdx.x);
    int cur[LANE_POS];
    load4(sk + i0, cur);
    uint32_t e[NE];
    e[0] = (uint32_t)__shfl_up_sync(FULL, cur[2], 1);
    e[1] = (uint32_t)__shfl_up_sync(FULL, cur[3], 1);
    if (lane == 0 && i0 > 0) {
      e[0] = (uint32_t)sk[i0 - 2];
      e[1] = (uint32_t)sk[i0 - 1];
    }
#pragma unroll
    for (int j = 0; j < LANE_POS; ++j) e[j + 2] = (uint32_t)cur[j];
    uint32_t lo[NE], hi[NE];
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int p = e[j] & 0xFFFF, a = p >> 2, s = (p & 3) * 8;
      const uint32_t x1 = sw[a + 1];
      lo[j] = __funnelshift_r(sw[a], x1, s);
      hi[j] = wide ? __funnelshift_r(x1, sw[a + 2], s) : 0u;
    }
#pragma unroll
    for (int j = 2; j < NE; ++j) {
      // the offset to entry j-k where its hash and bytes agree, else 0
      auto probe = [&](int k) {
        const bool ok = i0 + j - 2 >= k && (e[j] >> 16) == (e[j - k] >> 16) &&
                        lo[j] == lo[j - k] && hi[j] == hi[j - k];
        return ok ? (int)(e[j] & 0xFFFF) - (int)(e[j - k] & 0xFFFF) : 0;
      };
      const int o1 = probe(1), o2 = probe(2);
      const int v = plane == 0 ? (o1 ? o1 : o2) : plane == 1 ? o1 : o2;
      stage[e[j] & 0xFFFF] = (uint16_t)v;
    }
  }
  __syncthreads();

  const int guard = max(ns[b] - TAIL_GUARD, 0);
  int32_t* dst = so + (size_t)plane * B * BLOCK + base;
#pragma unroll 4
  for (int it = 0; it < PROBE_SWEEPS; ++it) {
    const int q = LANE_POS * (it * PROBE_THREADS + threadIdx.x);
    const uint2 v = *reinterpret_cast<const uint2*>(stage + q);
    const int x[LANE_POS] = {(int)(v.x & 0xFFFF), (int)(v.x >> 16), (int)(v.y & 0xFFFF),
                             (int)(v.y >> 16)};
    store4(dst + q, q < guard ? x[0] : 0, q + 1 < guard ? x[1] : 0, q + 2 < guard ? x[2] : 0,
           q + 3 < guard ? x[3] : 0);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers
// ---------------------------------------------------------------------------

extern "C" {

int lz4_geo_planes() { return G_NPLANES; }

const char* lz4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// What the compiler and the card make of each encoder kernel, in the order
// of KERNELS in ops/lz4_cuda.py (0 lz4_match, at W = 0 as the main path
// launches it; 1 lz4_parse; 2 lz4_geometry; 3 lz4_emit; 4 lz4_keys;
// 5 lz4_probe, with its dynamic shared memory): registers and local
// (spill) bytes a thread, shared bytes (static and dynamic) and threads a
// CTA, and resident CTAs per SM.
int lz4_kernel_info(int which, int* regs, int* local_bytes, int* shared_bytes, int* threads,
                    int* ctas_per_sm) {
  const void* fns[6] = {(const void*)lz4_match_kernel, (const void*)lz4_parse_kernel,
                        (const void*)lz4_geometry_kernel, (const void*)lz4_emit_kernel,
                        (const void*)lz4_keys_kernel, (const void*)lz4_probe_kernel};
  const int nthreads[6] = {ROW_THREADS, PARSE_THREADS, ROW_THREADS, EMIT_THREADS,
                           KEYS_THREADS, PROBE_THREADS};
  if (which < 0 || which > 5) return (int)cudaErrorInvalidValue;
  const int dynamic = which == 5 ? PROBE_SMEM : 0;
  if (which == 5) {
    cudaError_t err = cudaFuncSetAttribute(
        lz4_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PROBE_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes + dynamic;
  *threads = nthreads[which];
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fns[which],
                                                            nthreads[which], dynamic);
}

int lz4_match_launch(const uint8_t* blocks, const int32_t* ns, const int32_t* so8,
                     const int32_t* so4a, const int32_t* so4b, int32_t* mlen,
                     int32_t* moff, int B, int W, cudaStream_t stream) {
  const int smem = W > 0 ? BLOCK + 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      lz4_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK + 4);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    lz4_match_kernel<<<B, ROW_THREADS, smem, stream>>>(blocks, ns, so8, so4a, so4b,
                                                       mlen, moff, W);
  return (int)cudaGetLastError();
}

int lz4_parse_launch(const int32_t* mlen, uint8_t* is_start, int B, cudaStream_t stream) {
  if (B > 0)
    lz4_parse_kernel<<<B * (NROWS / PARSE_ROWS), PARSE_THREADS, 0, stream>>>(mlen, is_start);
  return (int)cudaGetLastError();
}

int lz4_geometry_launch(const int32_t* mlen, const int32_t* moff, const uint8_t* is_start,
                        const int32_t* ns, int32_t* geo, int32_t* core_used,
                        int32_t* used, int B, cudaStream_t stream) {
  if (B > 0)
    lz4_geometry_kernel<<<B, ROW_THREADS, 0, stream>>>(mlen, moff, is_start, ns, geo,
                                                       core_used, used);
  return (int)cudaGetLastError();
}

// Refuses (cudaErrorInvalidValue, nothing launched) more blocks than a
// flat grid of EMIT_CTAS_PER_BLOCK CTAs each can hold.
int lz4_emit_launch(const uint8_t* blocks, const int32_t* moff, const int32_t* geo,
                    const int32_t* used, uint8_t* out, int B, cudaStream_t stream) {
  if (B < 0 || (long long)B * EMIT_CTAS_PER_BLOCK > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B > 0)
    lz4_emit_kernel<<<B * EMIT_CTAS_PER_BLOCK, EMIT_THREADS, 0, stream>>>(blocks, moff, geo,
                                                                        used, out);
  return (int)cudaGetLastError();
}

// Refuse (cudaErrorInvalidValue, nothing launched) more blocks than their
// flat grids can hold.
int lz4_keys_launch(const uint8_t* blocks, int32_t* keys, int B, cudaStream_t stream) {
  if (B < 0 || (long long)B * (BLOCK_WORDS / KEYS_THREADS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B > 0)
    lz4_keys_kernel<<<B * (BLOCK_WORDS / KEYS_THREADS), KEYS_THREADS, 0, stream>>>(blocks, keys,
                                                                                 B);
  return (int)cudaGetLastError();
}

int lz4_probe_launch(const uint8_t* blocks, const int32_t* skeys, const int32_t* ns,
                     int32_t* so, int B, cudaStream_t stream) {
  if (B < 0 || (long long)B * PROBE_PLANES > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      lz4_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PROBE_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    lz4_probe_kernel<<<B * PROBE_PLANES, PROBE_THREADS, PROBE_SMEM, stream>>>(blocks, skeys, ns,
                                                                             so, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
