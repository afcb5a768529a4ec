// Hand-written Hopper row sort: each row of a (B, N) key array sorted
// stably by the key's bits [begin_bit, 32), with up to three 32-bit
// payloads carried along. Stable: keys equal in those bits keep their
// input order, so duplicate keys are allowed.
//
// Replaces tpu7z/ops/sort_pallas.py:76 _chunk_kernel, reached through
// bitonic_sort (:89-127): 34 launches of 4 compare-exchange stages each,
// 136 stages over a (512, 128) plane per row, every stage two full-plane
// shifts (a Mosaic workaround). None of that carries over. The plain
// PyTorch version is sort_rows_ref in tpu7z_torch/ops/sort_cuda.py.
//
// Built by tpu7z_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: the launcher has a plain C signature, takes raw
// device pointers, launches on the given stream without synchronising,
// allocates nothing, and returns the first cudaGetLastError() that is not
// cudaSuccess.
//
// Algorithm: a stable LSD radix sort with 8-bit digits, reduce-then-scan.
// A row of any length N is cut into tiles of TILE = 4096 keys. Every
// pass launches three kernels; count and scatter run over a flat grid of
// B * tiles CTAs (blockIdx.x = row * tiles + tile, so rows never sit in
// gridDim.y and its 65535 limit):
//   - count: each tile writes its 256 digit counts to
//     counts[row][tile][digit] (one shared-memory histogram a warp);
//   - scan: one CTA a row scans its table in digit-major order, in place,
//     into the row slot of each tile's first key of each digit: the row's
//     keys of smaller digits plus the keys of that digit in earlier tiles.
//     Each thread (digit) sweeps the row's tiles twice, for its total and
//     then for the running slots, so any number of tiles works; at
//     N = 1 << 22 that is 1024 tiles, one CTA walking 1 MiB a row.
//     A kernel of its own rather than folded into scatter: folded, every
//     scatter thread read its digit's count in all 16 tiles, and those
//     loads, live beside the tile's keys, pushed scatter to 110
//     registers, 2 CTAs per SM (PERF.md section 6);
//   - scatter: each tile ranks its keys stably (warp w owns 512
//     contiguous keys, 32 a step; lanes with the same digit find each
//     other with eight ballots, and a counter per (digit, warp) in shared
//     memory carries the rank from step to step), turns the (digit, warp)
//     counters into tile offsets with one block-wide scan, stages the
//     tile in digit order in shared memory, and writes each digit's run
//     to its row slot, so neighbouring threads write neighbouring
//     addresses. Payloads follow through the same staging slots and
//     destinations.
// Stability across tiles comes from the tile order in the scan; no atomic
// touches device memory. Passes ping-pong through one u32 scratch row per
// operand and `out` (used as u32 scratch on the way), so that the last
// pass lands in `out` for every begin_bit (4, 3, 2 or 1 passes).
//
// The key's carrier is read by the kernels themselves: the first pass
// reads 4- or 8-byte keys (an 8-byte key gives its low 32 bits) and the
// last pass writes the key's width back (zero-extended); the scratch rows
// between passes are u32. That is what the wrapper's int64 <-> int32
// conversions computed, without their five elementwise passes.
//
// Why tile-parallel: one CTA per row (the previous design) left 512 CTAs
// for 132 SMs, each walking its row in series between barriers; here the
// main path's 512 x 65536 sort has 8192 CTAs a pass, short ones, with
// every key load in flight at once.
//
// Bound: bytes. Every key and payload read once and written once: the
// main path's sort of 512 rows of 65536 int64 keys moves 16 B a key,
// 537 MB, 0.160 ms at 3.35 TB/s (int32 keys: 268 MB, 0.080 ms). This
// design reads each key twice a pass (count, scatter) and writes it once
// (the count table, 1 KiB a tile, adds 1 B a key a pass, read and written):
// at begin_bit = 16, read 8 + 8 and write 4 in the first pass, read 4 + 4
// and write 8 in the second, 36 B a key, 1.21 GB (24 B, 0.81 GB, with
// int32 keys); each payload is read and written once a pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KPT = 16;                 // keys a thread holds
constexpr int TILE = THREADS * KPT;     // 4096 keys a CTA
constexpr int WCHUNK = 32 * KPT;        // a warp's contiguous share of a tile
constexpr int RADIX = 256;
constexpr int WPAD = NWARPS + 1;        // (digit, warp) counters: a warp's distinct digits hit distinct banks
constexpr int MAX_PAYLOADS = 3;
constexpr unsigned FULL = 0xffffffffu;
static_assert(RADIX == THREADS, "one digit a thread in the scans");

struct Operands {
  const void* in[1 + MAX_PAYLOADS];   // key, then payloads
  void* out[1 + MAX_PAYLOADS];
  void* tmp[1 + MAX_PAYLOADS];        // u32 scratch rows (B, N) per operand
};

struct Pass {
  const void* key_src;
  void* key_dst;
  const uint32_t* pay_src[MAX_PAYLOADS];
  uint32_t* pay_dst[MAX_PAYLOADS];
};

__device__ __forceinline__ unsigned digit_of(uint32_t key, int shift) {
  return (key >> shift) & (RADIX - 1);
}

// The lanes among `valid` whose 8-bit digit equals this lane's d: eight
// ballots, a fixed cost whatever the number of distinct digits.
__device__ __forceinline__ unsigned match_digit(unsigned d, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(FULL, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Exclusive prefix sum over the block's values, one a thread. Every
// thread calls it; it begins and ends with a barrier's worth of ordering.
__device__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_sum(v);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int pre = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) pre += w < warp ? wsum[w] : 0;
  __syncthreads();
  return pre + inc - v;
}

// A tile's keys as u32, key i of a thread at element e0 + 32 i of the row
// (0 past its end); an 8-byte key gives its low word.
template <typename KIn>
__device__ __forceinline__ void load_keys(const KIn* __restrict__ src, size_t rowoff, int e0,
                                          int N, uint32_t (&key)[KPT]) {
#pragma unroll
  for (int i = 0; i < KPT; ++i)
    key[i] = e0 + 32 * i < N ? (uint32_t)src[rowoff + e0 + 32 * i] : 0u;
}

template <typename KIn>
__global__ void __launch_bounds__(THREADS, 8)
count_kernel(const KIn* __restrict__ src, uint32_t* __restrict__ counts, int N, int tiles,
             int shift) {
  __shared__ int hist[NWARPS * RADIX];   // one histogram a warp
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const int e0 = tile * TILE + warp * WCHUNK + lane;
  uint32_t key[KPT];
  load_keys(src, (size_t)row * N, e0, N, key);
  for (int i = t; i < NWARPS * RADIX; i += THREADS) hist[i] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < KPT; ++i)
    if (e0 + 32 * i < N) atomicAdd(&hist[warp * RADIX + digit_of(key[i], shift)], 1);
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) sum += hist[w * RADIX + t];
  counts[(size_t)blockIdx.x * RADIX + t] = (uint32_t)sum;
}

// One CTA a row: counts[row][tile][digit] become, in place, the row slot
// of the tile's first key of that digit. Thread t sweeps digit t's counts
// over the row's tiles twice: its total, then, after the scan over the
// digits, a running slot written back in place.
__global__ void __launch_bounds__(THREADS)
scan_kernel(uint32_t* __restrict__ counts, int tiles) {
  __shared__ int wsum[NWARPS];
  uint32_t* c = counts + (size_t)blockIdx.x * tiles * RADIX + threadIdx.x;
  int total = 0;
#pragma unroll 8
  for (int k = 0; k < tiles; ++k) total += (int)c[(size_t)k * RADIX];
  int run = block_exclusive_scan(total, wsum);
#pragma unroll 8
  for (int k = 0; k < tiles; ++k) {
    const int v = (int)c[(size_t)k * RADIX];
    c[(size_t)k * RADIX] = (uint32_t)run;
    run += v;
  }
}

// Three CTAs an SM for the key-only form: at four its 16 keys and 16
// slots a thread no longer fit the registers and spill.
template <int NPAY, typename KIn, typename KOut>
__global__ void __launch_bounds__(THREADS, NPAY == 0 ? 3 : 2)
scatter_kernel(Pass ps, const uint32_t* __restrict__ slots, int N, int tiles, int shift) {
  __shared__ uint32_t stage[TILE];
  __shared__ int wcnt[RADIX * WPAD];   // [digit][warp]
  __shared__ int gbase[RADIX];         // row slot of tile slot j of digit d: gbase[d] + j
  __shared__ int wsum[NWARPS];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int row = blockIdx.x / tiles, tile = blockIdx.x - row * tiles;
  const size_t rowoff = (size_t)row * N;
  const int n = min(TILE, N - tile * TILE);
  const int e0 = tile * TILE + warp * WCHUNK + lane;
  KOut* __restrict__ dst = static_cast<KOut*>(ps.key_dst);

  uint32_t key[KPT];
  load_keys(static_cast<const KIn*>(ps.key_src), rowoff, e0, N, key);
  for (int i = t; i < RADIX * WPAD; i += THREADS) wcnt[i] = 0;
  // the row slot of this tile's first key of digit t
  const int row_slot = (int)slots[(size_t)blockIdx.x * RADIX + t];
  __syncthreads();

  // 1. each key's rank among the keys of its digit that its warp saw in
  //    earlier steps or lower lanes
  int slot[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const bool valid = e0 + 32 * i < N;
    const unsigned d = digit_of(key[i], shift);
    const unsigned peers = match_digit(d, __ballot_sync(FULL, valid));
    int* ctr = &wcnt[d * WPAD + warp];
    const int old = valid ? *ctr : 0;
    __syncwarp();
    if (valid && lane == 31 - __clz(peers)) *ctr = old + __popc(peers);
    __syncwarp();
    slot[i] = old + __popc(peers & lt_mask);
  }
  __syncthreads();

  // 2. the (digit, warp) counters in digit-major order, scanned: each
  //    becomes the tile slot of its first key
  {
    int c[NWARPS], sum = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      c[w] = wcnt[t * WPAD + w];
      sum += c[w];
    }
    int run = block_exclusive_scan(sum, wsum);
    gbase[t] = row_slot - run;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      wcnt[t * WPAD + w] = run;
      run += c[w];
    }
  }
  __syncthreads();

  // 3. stage the tile in digit order
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (e0 + 32 * i < N) {
      slot[i] += wcnt[digit_of(key[i], shift) * WPAD + warp];
      stage[slot[i]] = key[i];
    }
  }
  __syncthreads();

  // 4. thread t writes tile slots t, t + 256, ...: neighbouring threads,
  //    neighbouring addresses within a digit's run
  int dpos[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int j = k * THREADS + t;
    if (j < n) {
      const uint32_t v = stage[j];
      dpos[k] = gbase[digit_of(v, shift)] + j;
      dst[rowoff + dpos[k]] = (KOut)v;
    }
  }

  // 5. payloads follow through the same slots and destinations
#pragma unroll
  for (int o = 0; o < NPAY; ++o) {
    uint32_t val[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      val[i] = e0 + 32 * i < N ? ps.pay_src[o][rowoff + e0 + 32 * i] : 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      if (e0 + 32 * i < N) stage[slot[i]] = val[i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int j = k * THREADS + t;
      if (j < n) ps.pay_dst[o][rowoff + dpos[k]] = stage[j];
    }
  }
}

template <int NPAY, typename KIn, typename KOut>
cudaError_t run_pass(const Pass& ps, uint32_t* counts, int B, int N, int tiles, int shift,
                     cudaStream_t stream) {
  const unsigned grid = (unsigned)B * (unsigned)tiles;
  count_kernel<KIn><<<grid, THREADS, 0, stream>>>(static_cast<const KIn*>(ps.key_src), counts,
                                                  N, tiles, shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<(unsigned)B, THREADS, 0, stream>>>(counts, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_kernel<NPAY, KIn, KOut><<<grid, THREADS, 0, stream>>>(ps, counts, N, tiles, shift);
  return cudaGetLastError();
}

template <int NPAY>
cudaError_t sort_passes(const Operands& ops, bool wide, uint32_t* counts, int B, int N,
                        int begin_bit, cudaStream_t stream) {
  const int npass = (32 - begin_bit) / 8, tiles = (N + TILE - 1) / TILE;
  for (int p = 0; p < npass; ++p) {
    // pass p reads what pass p-1 wrote; the last pass writes `out`
    const bool first = p == 0, last = p == npass - 1;
    const bool to_tmp = ((npass - 1 - p) & 1) != 0;
    Pass ps;
    ps.key_src = first ? ops.in[0] : (to_tmp ? ops.out[0] : ops.tmp[0]);
    ps.key_dst = to_tmp ? ops.tmp[0] : ops.out[0];
    for (int o = 0; o < MAX_PAYLOADS; ++o) {
      const void* src = first ? ops.in[1 + o] : (to_tmp ? ops.out[1 + o] : ops.tmp[1 + o]);
      ps.pay_src[o] = static_cast<const uint32_t*>(src);
      ps.pay_dst[o] = static_cast<uint32_t*>(to_tmp ? ops.tmp[1 + o] : ops.out[1 + o]);
    }
    const int shift = begin_bit + 8 * p;
    const bool in8 = wide && first, out8 = wide && last;
    cudaError_t err;
    if (in8 && out8)
      err = run_pass<NPAY, uint64_t, uint64_t>(ps, counts, B, N, tiles, shift, stream);
    else if (in8)
      err = run_pass<NPAY, uint64_t, uint32_t>(ps, counts, B, N, tiles, shift, stream);
    else if (out8)
      err = run_pass<NPAY, uint32_t, uint64_t>(ps, counts, B, N, tiles, shift, stream);
    else
      err = run_pass<NPAY, uint32_t, uint32_t>(ps, counts, B, N, tiles, shift, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// ---------------------------------------------------------------------------
// C launcher
// ---------------------------------------------------------------------------

extern "C" {

const char* sort_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sort_tile() { return TILE; }

// What the compiler and the card make of the kernels of the main path's
// sort (int64 keys, begin_bit 16, no payloads), in launch order: 0 count
// (8-byte keys in), 1 scan, 2 scatter (8-byte keys in, u32 out), 3 count
// (u32), 4 scatter (u32 in, 8-byte keys out). Registers and local (spill)
// bytes a thread, static shared bytes and threads a CTA, resident CTAs
// per SM.
int sort_kernel_info(int which, int* regs, int* local_bytes, int* shared_bytes, int* threads,
                     int* ctas_per_sm) {
  const void* fns[5] = {(const void*)count_kernel<uint64_t>, (const void*)scan_kernel,
                        (const void*)scatter_kernel<0, uint64_t, uint32_t>,
                        (const void*)count_kernel<uint32_t>,
                        (const void*)scatter_kernel<0, uint32_t, uint64_t>};
  if (which < 0 || which > 4) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fns[which]);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *shared_bytes = (int)a.sharedSizeBytes;
  *threads = THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fns[which], THREADS, 0);
}

// keys: (B, N) rows of key_bytes (4 or 8) each, contiguous; an 8-byte key
// is read as its low 32 bits and written back zero-extended. Payloads:
// (B, N) 32-bit rows. `in` operands are only read; `out` receives the
// sorted rows; `tmp` rows are u32 scratch, needed (non-null) when more
// than one pass runs. `counts` is scratch of B * ceil(N / sort_tile()) *
// 256 u32. Payload pointers past npay are ignored. begin_bit is 0, 8, 16
// or 24: the sort orders by bits [begin_bit, 32) and keeps the input order
// among equal bits. Launches 3 kernels a pass, none when B or N is 0.
// Refuses (cudaErrorInvalidValue, nothing launched) a grid of more than
// 2**31 - 1 CTAs (B * tiles) and rows too long for int positions.
int sort_rows_launch(const void* key_in, void* key_out, void* key_tmp, const void* p0_in,
                     void* p0_out, void* p0_tmp, const void* p1_in, void* p1_out, void* p1_tmp,
                     const void* p2_in, void* p2_out, void* p2_tmp, uint32_t* counts, int npay,
                     int key_bytes, int B, int N, int begin_bit, cudaStream_t stream) {
  if (npay < 0 || npay > MAX_PAYLOADS || (key_bytes != 4 && key_bytes != 8) || B < 0 || N < 0 ||
      N > 0x7fffffff - TILE || begin_bit < 0 || begin_bit > 24 || begin_bit % 8 != 0 ||
      (long long)B * ((N + TILE - 1) / TILE) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const Operands ops = {{key_in, p0_in, p1_in, p2_in},
                        {key_out, p0_out, p1_out, p2_out},
                        {key_tmp, p0_tmp, p1_tmp, p2_tmp}};
  const bool wide = key_bytes == 8;
  cudaError_t err;
  switch (npay) {
    case 0: err = sort_passes<0>(ops, wide, counts, B, N, begin_bit, stream); break;
    case 1: err = sort_passes<1>(ops, wide, counts, B, N, begin_bit, stream); break;
    case 2: err = sort_passes<2>(ops, wide, counts, B, N, begin_bit, stream); break;
    default: err = sort_passes<3>(ops, wide, counts, B, N, begin_bit, stream); break;
  }
  return (int)err;
}

}  // extern "C"
