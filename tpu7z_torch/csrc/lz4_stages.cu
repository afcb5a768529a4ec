// Hand-written Hopper kernels of the LZ4 device block encoder.
//
// Five kernels replace the six Pallas TPU kernels of tpu7z/ops/lz4_pallas.py
// (a1, a2, a3, b1+b2, c). Each works on a batch of B independent 64 KiB
// blocks; the plain PyTorch version of every kernel is in
// tpu7z_torch/ops/lz4_plane.py and gives the same integers.
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
//   so*      (B, BLOCK)  int32     sorted-neighbour candidate offsets
//   mlen/moff(B, BLOCK)  int32
//   is_start (B, BLOCK)  uint8     0/1
//   geo      (B, G_NPLANES, BLOCK) int32, planes in GeoPlane order
//   core     (B, CORE_CAP) uint8
//   out      (B, OUT_CAP)  uint8

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 128;
constexpr int NROWS = 512;
constexpr int BLOCK = ROW * NROWS;
constexpr int CORE_CAP = 672 * ROW;
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

// the scan kernels (match, geometry): one CUDA block of SCAN_THREADS per
// 64 KiB block, each thread owning a contiguous SPAN of positions
constexpr int SCAN_THREADS = 1024;
constexpr int SPAN = BLOCK / SCAN_THREADS;      // 64: two threads per row
constexpr int NWARPS = SCAN_THREADS / 32;

struct MinOp { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct MaxOp { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct SumOp { __device__ int operator()(int a, int b) const { return a + b; } };

template <typename Op>
__device__ int warp_inclusive_scan(int v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, o);
  }
  return v;
}

// Exclusive scan over the block's threads in thread order. `wsum` holds
// NWARPS ints of shared memory; `total` receives the combination of all.
template <typename Op>
__device__ int block_exclusive_scan(int v, Op op, int ident, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = warp_inclusive_scan(v, op);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) wsum[lane] = warp_inclusive_scan(wsum[lane], op);
  __syncthreads();
  int ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = ident;
  int r = op(warp ? wsum[warp - 1] : ident, ex);
  if (total) *total = wsum[NWARPS - 1];
  __syncthreads();  // wsum may be reused at once
  return r;
}

// Exclusive scan in reverse thread order: thread t gets the combination of
// the values of threads t+1 .. SCAN_THREADS-1.
template <typename Op>
__device__ int block_suffix_scan(int v, Op op, int ident, int* buf, int* wsum) {
  const int t = threadIdx.x, rt = SCAN_THREADS - 1 - t;
  buf[t] = v;
  __syncthreads();
  int r = block_exclusive_scan(buf[rt], op, ident, wsum, nullptr);
  buf[rt] = r;  // every read of buf happened before the scan's barriers
  __syncthreads();
  int out = buf[t];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// lz4_match: replaces tpu7z/ops/lz4_pallas.py:58 _kernel_a1
//   (lz4_plane.phase0_words, phase1_nearest_offset, phase2_lengths)
//
// Bound: bytes. Per 64 KiB block it reads the block (64 KiB) and three
// candidate planes (768 KiB) and writes mlen and moff (512 KiB): 1.34 MB,
// 0.4 us at 3.35 TB/s. The run lengths are uncapped suffix runs that cross
// rows, so each thread scans its span in reverse and a block-wide suffix
// min of "next position where the run breaks" joins the spans. The block's
// bytes go to shared memory only when the tier-A window is on (W > 0).
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

__device__ __forceinline__ int tier_value(int k, const uint8_t* sb, const int32_t* s4a,
                                          const int32_t* s4b, const int32_t* s8,
                                          int q, int W, int guard) {
  if (q >= BLOCK) return 0;
  switch (k) {
    case 0: return tier_a(sb, q, W, guard);
    case 1: return s4a[q];
    case 2: return s4b[q];
    default: return s8[q];
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
lz4_match_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ so8, const int32_t* __restrict__ so4a,
                 const int32_t* __restrict__ so4b, int32_t* __restrict__ mlen_out,
                 int32_t* __restrict__ moff_out, int W) {
  extern __shared__ uint8_t sb[];  // BLOCK + 4 bytes when W > 0
  __shared__ int buf[SCAN_THREADS];
  __shared__ int wsum[NWARPS];
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t base = (size_t)b * BLOCK;
  const int n = ns[b];
  const int guard = max(n - TAIL_GUARD, 0);
  const int32_t* s8 = so8 + base;
  const int32_t* s4a = so4a + base;
  const int32_t* s4b = so4b + base;
  if (W > 0) {
    for (int i = t; i < BLOCK; i += SCAN_THREADS) sb[i] = blocks[base + i];
    if (t < 4) sb[BLOCK + t] = 0;
    __syncthreads();
  }
  const int a = t * SPAN;

  // pass 1: first run break in this span, per tier. diag(q) means q and
  // q+1 carry the same nonzero offset; the run at q ends at the first q'
  // >= q without diag (there is always one at BLOCK-1).
  int first_brk[NTIERS];
#pragma unroll
  for (int k = 0; k < NTIERS; ++k) {
    int nxt = tier_value(k, sb, s4a, s4b, s8, a + SPAN, W, guard);
    int fb = BLOCK;
    for (int q = a + SPAN - 1; q >= a; --q) {
      int cur = tier_value(k, sb, s4a, s4b, s8, q, W, guard);
      if (!(cur > 0 && nxt == cur)) fb = q;
      nxt = cur;
    }
    first_brk[k] = fb;
  }
  int brk[NTIERS], nxt[NTIERS];
#pragma unroll
  for (int k = 0; k < NTIERS; ++k) {
    brk[k] = block_suffix_scan(first_brk[k], MinOp(), BLOCK, buf, wsum);
    nxt[k] = tier_value(k, sb, s4a, s4b, s8, a + SPAN, W, guard);
  }

  // pass 2: lengths, tier choice, caps
  for (int q = a + SPAN - 1; q >= a; --q) {
    int ml = 0, mo = 0;
#pragma unroll
    for (int k = 0; k < NTIERS; ++k) {
      int cur = tier_value(k, sb, s4a, s4b, s8, q, W, guard);
      if (!(cur > 0 && nxt[k] == cur)) brk[k] = q;
      nxt[k] = cur;
      int run = cur > 0 ? brk[k] - q + (k == NTIERS - 1 ? MIN_MATCH_B : MIN_MATCH) : 0;
      if (k == 0 || run > ml) { ml = run; mo = cur; }
    }
    ml = min(ml, max(n - END_LITERALS - q, 0));
    ml = min(ml, ROW - (q & (ROW - 1)));
    const bool ok = ml >= MIN_MATCH && q < guard && mo > 0;
    mlen_out[base + q] = ok ? ml : 0;
    moff_out[base + q] = ok ? mo : 0;
  }
}

// ---------------------------------------------------------------------------
// lz4_parse: replaces tpu7z/ops/lz4_pallas.py:72 _kernel_a2
//   (lz4_plane.phase3_parse)
//
// Bound: bytes. Reads mlen (256 KiB per block), writes is_start (64 KiB):
// 0.1 us per block at 3.35 TB/s. The cursor is serial within a row, so one
// thread walks one row; the rows of a CUDA block are staged through shared
// memory so that the loads and stores stay coalesced. The walk stops at the
// row end, which gives the same result as the TPU's fixed 128 steps.
// ---------------------------------------------------------------------------

constexpr int PARSE_ROWS = 64;  // rows (and threads) per CUDA block

__global__ void __launch_bounds__(PARSE_ROWS)
lz4_parse_kernel(const int32_t* __restrict__ mlen, uint8_t* __restrict__ is_start) {
  __shared__ int32_t ml[PARSE_ROWS][ROW + 1];
  __shared__ uint8_t st[PARSE_ROWS][ROW];
  const size_t row0 = (size_t)blockIdx.x * PARSE_ROWS;
  const int32_t* src = mlen + row0 * ROW;
  for (int i = threadIdx.x; i < PARSE_ROWS * ROW; i += PARSE_ROWS) {
    ml[i / ROW][i % ROW] = src[i];
    st[i / ROW][i % ROW] = 0;
  }
  __syncthreads();
  const int r = threadIdx.x;
  int c = 0;
  while (c < ROW) {
    const int cur = ml[r][c];
    // one-step lazy matching: defer when the next position's match is
    // more than one byte longer
    const bool defer = c + 1 < ROW && ml[r][c + 1] > cur + 1;
    if (cur >= MIN_MATCH && !defer) {
      st[r][c] = 1;
      c += cur;
    } else {
      c += 1;
    }
  }
  __syncthreads();
  uint8_t* dst = is_start + row0 * ROW;
  for (int i = threadIdx.x; i < PARSE_ROWS * ROW; i += PARSE_ROWS)
    dst[i] = st[i / ROW][i % ROW];
}

// ---------------------------------------------------------------------------
// lz4_geometry: replaces tpu7z/ops/lz4_pallas.py:77 _kernel_a3
//   (lz4_plane.phase4_geometry)
//
// Bound: bytes. Reads mlen, moff and is_start (576 KiB per block) and
// writes 14 int32 planes (3.5 MiB): 4.1 MB, 1.2 us per block at 3.35 TB/s.
// Nothing needs all 64K positions at once, so each thread keeps its span's
// flags in 64-bit masks and the block joins spans with shared-memory row
// tables (the odd-row merge), a suffix max (the next match start) and two
// prefix sums (core_pos, gap_before) over span totals.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SCAN_THREADS)
lz4_geometry_kernel(const int32_t* __restrict__ mlen, const int32_t* __restrict__ moff,
                    const uint8_t* __restrict__ is_start, const int32_t* __restrict__ ns,
                    int32_t* __restrict__ geo, int32_t* __restrict__ core_used,
                    int32_t* __restrict__ used) {
  __shared__ int row_end_off[NROWS];   // offset of the match ending at the row end
  __shared__ int row_cont_len[NROWS];  // continuation at lane 0 (odd rows)
  __shared__ int row_cont_off[NROWS];
  __shared__ int last_cov[SCAN_THREADS];
  __shared__ int buf[SCAN_THREADS];
  __shared__ int wsum[NWARPS];
  const int b = blockIdx.x, t = threadIdx.x;
  const size_t base = (size_t)b * BLOCK;
  const int n = ns[b];
  const int32_t* ml = mlen + base;
  const int32_t* mo = moff + base;
  const uint8_t* is = is_start + base;
  int32_t* g = geo + (size_t)b * G_NPLANES * BLOCK;
  const int a = t * SPAN;
  const int r = a / ROW;
  const int lane0 = a % ROW;  // 0 or 64
  if (t < NROWS) {
    row_end_off[t] = 0;
    row_cont_len[t] = 0;
    row_cont_off[t] = 0;
  }

  // pass 1: match starts and the span's furthest reach
  uint64_t mstart = 0;
  int span_reach = 0;
  for (int i = 0; i < SPAN; ++i) {
    const int q = a + i;
    if (q < n && is[q]) {
      mstart |= 1ull << i;
      span_reach = max(span_reach, lane0 + i + ml[q]);
    }
  }
  // the first half of the row feeds the second (same warp: t even, t+1)
  int reach = __shfl_up_sync(0xffffffffu, span_reach, 1);
  if (lane0 == 0) reach = 0;
  __syncthreads();  // row tables are initialised

  // pass 2: covered (in-row running max of reach), matches ending at the row end
  uint64_t covered = 0;
  for (int i = 0; i < SPAN; ++i) {
    const int q = a + i;
    if ((mstart >> i) & 1) {
      const int m = ml[q];
      reach = max(reach, lane0 + i + m);
      if (lane0 + i + m == ROW) row_end_off[r] = mo[q];
    }
    if (q < n && lane0 + i < reach) covered |= 1ull << i;
  }
  last_cov[t] = (int)(covered >> (SPAN - 1));
  __syncthreads();

  // the odd-row continuation
  bool cont = false;
  if (lane0 == 0 && (r & 1) && (mstart & 1)) {
    const int pe = row_end_off[r - 1];
    if (pe > 0 && mo[a] == pe) {
      cont = true;
      row_cont_len[r] = ml[a];
      row_cont_off[r] = mo[a];
    }
  }
  __syncthreads();
  const uint64_t head = mstart & ~(uint64_t)cont;
  const int next_cont_len = r + 1 < NROWS ? row_cont_len[r + 1] : 0;
  const int next_cont_off = r + 1 < NROWS ? row_cont_off[r + 1] : 0;

  // the merged match-length code of a head at position q = a + i
  auto head_mlc = [&](int i) {
    const int q = a + i;
    const int m = ml[q];
    int add = 0;
    if (lane0 + i + m == ROW && next_cont_len > 0 && mo[q] == next_cont_off)
      add = next_cont_len;
    return m + add - MIN_MATCH;
  };
  auto enc_of = [&](int i, int mlc) { return (BLOCK - (a + i)) * 16 + min(mlc, 15); };

  // next match start after this span: suffix max over the spans' first heads
  const int first_enc = head ? enc_of(__ffsll((long long)head) - 1,
                                      head_mlc(__ffsll((long long)head) - 1)) : 0;
  int best = block_suffix_scan(first_enc, MaxOp(), 0, buf, wsum);

  // pass 3 (reverse): anchors, tokens, lengths; per-position byte counts
  int glen_sum = 0, gap_sum = 0;
  for (int i = SPAN - 1; i >= 0; --i) {
    const int q = a + i;
    const bool in_range = q < n;
    const bool hd = (head >> i) & 1;
    const bool cov = (covered >> i) & 1;
    const bool kept = in_range && !cov;
    const int mlc = hd ? head_mlc(i) : 0;
    if (hd) best = enc_of(i, mlc);
    const bool has_next = best > 0;
    const int next_start = min(has_next ? BLOCK - (best >> 4) : n, n);
    const int next_nib = has_next ? (best & 15) : 0;
    const bool prev_cov = i ? ((covered >> (i - 1)) & 1) : (t ? last_cov[t - 1] : 0);
    const bool anchor = in_range && (q == 0 || (prev_cov && (hd || !cov)));
    const int L = anchor ? next_start - q : 0;
    const bool has_ext = anchor && L >= 15;
    const int e = has_ext ? (L - 15) / 255 + 1 : 0;
    const int gap255 = max(e - 1, 0);
    const int litrem = has_ext ? (L - 15) % 255 : 0;
    const bool long_run = anchor && L >= LONG_LIT;
    const bool ml_ext = hd && mlc >= 15;
    const int token = anchor ? (min(L, 15) << 4) | next_nib : 0;
    const int inj_h = anchor ? 1 + min(e, 1) : 0;
    const int inj_t = hd ? 2 + (int)ml_ext : 0;
    const int glen = in_range ? (int)kept + inj_h + inj_t : 0;
    const int gap_here = long_run ? gap255 : 0;
    g[G_KEPT * BLOCK + q] = kept;
    g[G_ANCHOR * BLOCK + q] = anchor;
    g[G_MSTART * BLOCK + q] = hd;
    g[G_TOKEN * BLOCK + q] = token;
    g[G_LITREM * BLOCK + q] = litrem;
    g[G_E * BLOCK + q] = e;
    g[G_GAP255 * BLOCK + q] = gap255;
    g[G_LONG_RUN * BLOCK + q] = long_run;
    g[G_MLC * BLOCK + q] = mlc;
    g[G_ML_EXT * BLOCK + q] = ml_ext;
    g[G_GLEN * BLOCK + q] = glen;
    g[G_GAP_HERE * BLOCK + q] = gap_here;
    glen_sum += glen;
    gap_sum += gap_here;
  }

  // pass 4: exclusive prefix sums over the whole block
  int core_total = 0, gap_total = 0;
  int cp = block_exclusive_scan(glen_sum, SumOp(), 0, wsum, &core_total);
  int gb = block_exclusive_scan(gap_sum, SumOp(), 0, wsum, &gap_total);
  for (int i = 0; i < SPAN; ++i) {
    const int q = a + i;
    g[G_CORE_POS * BLOCK + q] = cp;
    g[G_GAP_BEFORE * BLOCK + q] = gb;
    cp += g[G_GLEN * BLOCK + q];
    gb += g[G_GAP_HERE * BLOCK + q];
  }
  if (t == 0) {
    core_used[b] = core_total;
    used[b] = core_total + gap_total;
  }
}

// ---------------------------------------------------------------------------
// lz4_emit_core: replaces tpu7z/ops/lz4_pallas.py:108 _kernel_b1 and
//   :120 _kernel_b2 (lz4_plane.phase5_core)
//
// Bound: bytes. Reads glen everywhere and, where a position emits bytes,
// the block, moff and up to nine more geometry planes (at most 2.8 MiB per
// block), and writes the core (84 KiB): at most 3.0 MB, 0.9 us per block
// at 3.35 TB/s. The TPU built the core with a 16-step merge pyramid because it
// could not scatter; here each position writes its own glen bytes at
// core_pos, so neighbouring threads write neighbouring bytes.
// ---------------------------------------------------------------------------

constexpr int POS_THREADS = 256;

__global__ void __launch_bounds__(POS_THREADS)
lz4_emit_core_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ moff,
                     const int32_t* __restrict__ geo, const int32_t* __restrict__ core_used,
                     uint8_t* __restrict__ core) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * POS_THREADS + threadIdx.x;
  const int32_t* g = geo + (size_t)b * G_NPLANES * BLOCK;
  uint8_t* dst = core + (size_t)b * CORE_CAP;
  for (int i = core_used[b] + p; i < CORE_CAP; i += BLOCK) dst[i] = 0;
  if (g[G_GLEN * BLOCK + p] == 0) return;
  int c = g[G_CORE_POS * BLOCK + p];
  if (g[G_ANCHOR * BLOCK + p]) {
    dst[c++] = (uint8_t)g[G_TOKEN * BLOCK + p];
    if (g[G_E * BLOCK + p] >= 1) dst[c++] = (uint8_t)g[G_LITREM * BLOCK + p];
  }
  if (g[G_KEPT * BLOCK + p]) dst[c++] = blocks[(size_t)b * BLOCK + p];
  if (g[G_MSTART * BLOCK + p]) {
    const int o = moff[(size_t)b * BLOCK + p];
    dst[c++] = (uint8_t)(o & 0xFF);
    dst[c++] = (uint8_t)(o >> 8);
    if (g[G_ML_EXT * BLOCK + p]) dst[c++] = (uint8_t)(g[G_MLC * BLOCK + p] - 15);
  }
}

// ---------------------------------------------------------------------------
// lz4_expand: replaces tpu7z/ops/lz4_pallas.py:127 _kernel_c
//   (lz4_plane.phase6_expand)
//
// Bound: bytes. Reads glen everywhere and, where a position emits bytes,
// four more geometry planes and its core bytes (at most 1.3 MiB per block),
// and writes out (85 KiB): at most 1.5 MB, 0.45 us per block at 3.35 TB/s. Each position copies its core bytes to core_pos + gap_before,
// bytes after a long run's token moving gap255 further, and writes that
// run's 255-bytes itself. A block with no long run is a plain copy; the
// TPU had to branch around a costly gather for it.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(POS_THREADS)
lz4_expand_kernel(const uint8_t* __restrict__ core, const int32_t* __restrict__ geo,
                  const int32_t* __restrict__ used, uint8_t* __restrict__ out) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * POS_THREADS + threadIdx.x;
  const int32_t* g = geo + (size_t)b * G_NPLANES * BLOCK;
  const uint8_t* src = core + (size_t)b * CORE_CAP;
  uint8_t* dst = out + (size_t)b * OUT_CAP;
  for (int i = used[b] + p; i < OUT_CAP; i += BLOCK) dst[i] = 0;
  const int glen = g[G_GLEN * BLOCK + p];
  if (glen == 0) return;
  const int cp = g[G_CORE_POS * BLOCK + p];
  const int o = cp + g[G_GAP_BEFORE * BLOCK + p];
  const int gap = g[G_LONG_RUN * BLOCK + p] ? g[G_GAP255 * BLOCK + p] : 0;
  dst[o] = src[cp];
  for (int j = 1; j <= gap; ++j) dst[o + j] = 255;
  for (int s = 1; s < glen; ++s) dst[o + gap + s] = src[cp + s];
}

}  // namespace

// ---------------------------------------------------------------------------
// C launchers
// ---------------------------------------------------------------------------

extern "C" {

int lz4_geo_planes() { return G_NPLANES; }

const char* lz4_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int lz4_match_launch(const uint8_t* blocks, const int32_t* ns, const int32_t* so8,
                     const int32_t* so4a, const int32_t* so4b, int32_t* mlen,
                     int32_t* moff, int B, int W, cudaStream_t stream) {
  const int smem = W > 0 ? BLOCK + 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      lz4_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK + 4);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    lz4_match_kernel<<<B, SCAN_THREADS, smem, stream>>>(blocks, ns, so8, so4a, so4b,
                                                        mlen, moff, W);
  return (int)cudaGetLastError();
}

int lz4_parse_launch(const int32_t* mlen, uint8_t* is_start, int B, cudaStream_t stream) {
  if (B > 0)
    lz4_parse_kernel<<<B * (NROWS / PARSE_ROWS), PARSE_ROWS, 0, stream>>>(mlen, is_start);
  return (int)cudaGetLastError();
}

int lz4_geometry_launch(const int32_t* mlen, const int32_t* moff, const uint8_t* is_start,
                        const int32_t* ns, int32_t* geo, int32_t* core_used,
                        int32_t* used, int B, cudaStream_t stream) {
  if (B > 0)
    lz4_geometry_kernel<<<B, SCAN_THREADS, 0, stream>>>(mlen, moff, is_start, ns, geo,
                                                        core_used, used);
  return (int)cudaGetLastError();
}

int lz4_emit_core_launch(const uint8_t* blocks, const int32_t* moff, const int32_t* geo,
                         const int32_t* core_used, uint8_t* core, int B,
                         cudaStream_t stream) {
  if (B > 0)
    lz4_emit_core_kernel<<<dim3(BLOCK / POS_THREADS, B), POS_THREADS, 0, stream>>>(
        blocks, moff, geo, core_used, core);
  return (int)cudaGetLastError();
}

int lz4_expand_launch(const uint8_t* core, const int32_t* geo, const int32_t* used,
                      uint8_t* out, int B, cudaStream_t stream) {
  if (B > 0)
    lz4_expand_kernel<<<dim3(BLOCK / POS_THREADS, B), POS_THREADS, 0, stream>>>(
        core, geo, used, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
