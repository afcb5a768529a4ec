// Hand-written Hopper row sort: each row of a (B, N) uint32 key array
// sorted ascending, with up to three 32-bit payloads carried along.
//
// Replaces tpu7z/ops/sort_pallas.py:76 _chunk_kernel, reached through
// bitonic_sort (:88-127): 34 launches of 4 compare-exchange stages each,
// 136 stages over a (512, 128) plane per row, every stage two full-plane
// shifts (a Mosaic workaround). None of that carries over. The plain
// PyTorch version is sort_rows_ref in tpu7z_torch/ops/sort_cuda.py.
//
// Built by tpu7z_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: the launcher has a plain C signature, takes raw
// device pointers, launches on the given stream without synchronising,
// allocates nothing, and returns cudaGetLastError().
//
// Algorithm: a stable LSD radix sort with 8-bit digits over bits
// [begin_bit, 32), one CUDA block per row. A row of 65536 keys is 256 KiB,
// more than a block's shared memory, so the passes ping-pong through a
// scratch row in device memory that the wrapper allocates; the last pass
// lands in `out`. One sweep first counts every pass's digits (the counts
// of a digit do not depend on the order). Each pass then walks the row in
// tiles of TILE keys, in order:
//   - warp w ranks its contiguous 32*KPT keys of the tile stably: lanes
//     with the same digit find each other with __match_any_sync, and a
//     per-warp counter per digit in shared memory carries the rank from one
//     32-key step to the next;
//   - a column scan over the warps and a scan over the 256 digits give each
//     key its slot in the tile sorted by digit; the tile is staged there in
//     shared memory;
//   - thread j writes staged key j to base[digit] + (its rank in the
//     digit), so neighbouring threads write neighbouring addresses within a
//     digit's run; base[digit] then moves on by the tile's count.
// Payloads follow their key through the same staging and the same
// destinations.
//
// Bound: bytes. Every key and payload is read once and written once: for
// the main path's key-only sort of 512 rows of 65536 keys, 268 MB, 0.080 ms
// at 3.35 TB/s. This kernel reads the keys once for the count sweep and
// once a pass, writes them once a pass, and reads and writes each payload
// once a pass; the matcher's keys need only bits 16..31 (begin_bit = 16),
// so they are read three times and written twice. A row and its scratch
// row take 512 KiB; with a block or more on each of the 132 SMs that is
// at least 67 MB, more than the 50 MB L2 holds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int KPT = 16;                 // keys per thread per tile
constexpr int TILE = THREADS * KPT;     // 8192 keys per tile
constexpr int WCHUNK = 32 * KPT;        // a warp's contiguous share of a tile
constexpr int RADIX = 256;
constexpr int MAX_PASSES = 4;
constexpr int MAX_PAYLOADS = 3;

struct Operands {
  const uint32_t* in[1 + MAX_PAYLOADS];   // key, then payloads
  uint32_t* out[1 + MAX_PAYLOADS];
  uint32_t* tmp[1 + MAX_PAYLOADS];        // scratch rows (B, N) per operand
};

// shared memory, in 32-bit words
constexpr int SM_STAGE = 0;                          // TILE staged operand
constexpr int SM_WCNT = SM_STAGE + TILE;             // NWARPS x RADIX rank counters
constexpr int SM_HIST = SM_WCNT + NWARPS * RADIX;    // MAX_PASSES x RADIX digit counts
constexpr int SM_BASE = SM_HIST + MAX_PASSES * RADIX;  // RADIX running bases
constexpr int SM_TOFF = SM_BASE + RADIX;             // RADIX tile digit offsets
constexpr int SM_WTMP = SM_TOFF + RADIX;             // 32 for the digit scan
constexpr int SM_WORDS = SM_WTMP + 32;
constexpr int SMEM_BYTES = SM_WORDS * 4;

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Exclusive prefix sum over the first RADIX threads' values (the others
// pass 0 and get a value they ignore). Every thread of the block calls it.
__device__ int digit_exclusive_scan(int v, int* wtmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int inc = warp_inclusive_sum(v);
  if (lane == 31 && warp < RADIX / 32) wtmp[warp] = inc;
  __syncthreads();
  int pre = 0;
  for (int w = 0; w < warp && w < RADIX / 32; ++w) pre += wtmp[w];
  __syncthreads();
  return pre + inc - v;
}

__device__ __forceinline__ int digit_of(uint32_t key, int shift) {
  return (int)((key >> shift) & (RADIX - 1));
}

template <int NPAY>
__global__ void __launch_bounds__(THREADS)
sort_rows_kernel(Operands ops, int N, int begin_bit, int npass) {
  extern __shared__ int smem[];
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + SM_STAGE);
  int* wcnt = smem + SM_WCNT;
  int* hist = smem + SM_HIST;
  int* base = smem + SM_BASE;
  int* toff = smem + SM_TOFF;
  int* wtmp = smem + SM_WTMP;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const size_t row = (size_t)blockIdx.x * N;

  for (int i = t; i < NWARPS * RADIX + MAX_PASSES * RADIX; i += THREADS) wcnt[i] = 0;
  __syncthreads();

  // every pass's digit counts in one sweep; lanes of a warp with the same
  // digit add their count once
  for (int s = 0; s < N; s += THREADS) {
    const int e = s + t;
    const bool valid = e < N;
    const uint32_t key = valid ? ops.in[0][row + e] : 0u;
    for (int p = 0; p < npass; ++p) {
      const int d = valid ? digit_of(key, begin_bit + 8 * p) : RADIX + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (valid && (peers & lt_mask) == 0) atomicAdd(&hist[p * RADIX + d], __popc(peers));
    }
  }
  __syncthreads();

  for (int p = 0; p < npass; ++p) {
    const int shift = begin_bit + 8 * p;
    // pass p reads what pass p-1 wrote; the last pass writes `out`
    const bool to_tmp = ((npass - 1 - p) & 1) != 0;
    const uint32_t* src[1 + NPAY];
    uint32_t* dst[1 + NPAY];
#pragma unroll
    for (int o = 0; o <= NPAY; ++o) {
      src[o] = p == 0 ? ops.in[o] : (to_tmp ? ops.out[o] : ops.tmp[o]);
      dst[o] = to_tmp ? ops.tmp[o] : ops.out[o];
    }
    {
      const int c = t < RADIX ? hist[p * RADIX + t] : 0;
      const int ex = digit_exclusive_scan(c, wtmp);
      if (t < RADIX) base[t] = ex;
    }
    __syncthreads();

    for (int tb = 0; tb < N; tb += TILE) {
      // 1. stable rank of each key among the keys of the same digit that
      //    its warp saw earlier in this tile
      const int e0 = tb + warp * WCHUNK + lane;   // key i is element e0 + 32 i
      uint32_t key[KPT];
      int slot[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) key[i] = e0 + i * 32 < N ? src[0][row + e0 + i * 32] : 0u;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const bool valid = e0 + i * 32 < N;
        const int d = valid ? digit_of(key[i], shift) : RADIX + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int before = __popc(peers & lt_mask);
        const int old = valid ? wcnt[warp * RADIX + d] : 0;
        __syncwarp();
        if (valid && before == 0) wcnt[warp * RADIX + d] = old + __popc(peers);
        __syncwarp();
        slot[i] = valid ? old + before : -1;
      }
      __syncthreads();

      // 2. per digit: exclusive scan over the warps, the tile's count, and
      //    the digit's offset in the tile
      int tcount = 0;
      if (t < RADIX) {
        for (int w = 0; w < NWARPS; ++w) {
          const int c = wcnt[w * RADIX + t];
          wcnt[w * RADIX + t] = tcount;
          tcount += c;
        }
      }
      const int tile_off = digit_exclusive_scan(tcount, wtmp);
      if (t < RADIX) toff[t] = tile_off;
      __syncthreads();

      // 3. stage the keys in digit order
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        if (slot[i] >= 0) {
          const int d = digit_of(key[i], shift);
          slot[i] += toff[d] + wcnt[warp * RADIX + d];
          stage[slot[i]] = key[i];
        }
      }
      __syncthreads();

      // 4. write them out; payloads follow through the same slots
      const int nvalid = min(TILE, N - tb);
      int dpos[KPT];
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int j = k * THREADS + t;
        if (j < nvalid) {
          const uint32_t v = stage[j];
          const int d = digit_of(v, shift);
          dpos[k] = base[d] + j - toff[d];
          dst[0][row + dpos[k]] = v;
        }
      }
#pragma unroll
      for (int o = 1; o <= NPAY; ++o) {
        uint32_t val[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) val[i] = slot[i] >= 0 ? src[o][row + e0 + i * 32] : 0u;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < KPT; ++i)
          if (slot[i] >= 0) stage[slot[i]] = val[i];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          const int j = k * THREADS + t;
          if (j < nvalid) dst[o][row + dpos[k]] = stage[j];
        }
      }
      __syncthreads();
      if (t < RADIX) base[t] += tcount;
      for (int i = t; i < NWARPS * RADIX; i += THREADS) wcnt[i] = 0;
      __syncthreads();
    }
  }
}

template <int NPAY>
cudaError_t launch(const Operands& ops, int B, int N, int begin_bit, int npass,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kernel<NPAY>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  sort_rows_kernel<NPAY><<<B, THREADS, SMEM_BYTES, stream>>>(ops, N, begin_bit, npass);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C launcher
// ---------------------------------------------------------------------------

extern "C" {

const char* sort_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sort_max_n() { return 65536; }

// keys/payloads: (B, N) 32-bit rows, contiguous. `in` operands are only
// read; `out` receives the sorted rows; `tmp` rows are scratch, needed
// (non-null) when more than one pass runs. Payload pointers past npay are
// ignored. begin_bit is 0, 8, 16 or 24: the sort orders by bits
// [begin_bit, 32) and keeps the input order among equal bits.
int sort_rows_launch(const uint32_t* key_in, uint32_t* key_out, uint32_t* key_tmp,
                     const uint32_t* p0_in, uint32_t* p0_out, uint32_t* p0_tmp,
                     const uint32_t* p1_in, uint32_t* p1_out, uint32_t* p1_tmp,
                     const uint32_t* p2_in, uint32_t* p2_out, uint32_t* p2_tmp,
                     int npay, int B, int N, int begin_bit, cudaStream_t stream) {
  if (npay < 0 || npay > MAX_PAYLOADS || N < 0 || N > 65536 || begin_bit < 0 ||
      begin_bit > 24 || begin_bit % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  const int npass = (32 - begin_bit) / 8;
  Operands ops = {{key_in, p0_in, p1_in, p2_in},
                  {key_out, p0_out, p1_out, p2_out},
                  {key_tmp, p0_tmp, p1_tmp, p2_tmp}};
  cudaError_t err;
  switch (npay) {
    case 0: err = launch<0>(ops, B, N, begin_bit, npass, stream); break;
    case 1: err = launch<1>(ops, B, N, begin_bit, npass, stream); break;
    case 2: err = launch<2>(ops, B, N, begin_bit, npass, stream); break;
    default: err = launch<3>(ops, B, N, begin_bit, npass, stream); break;
  }
  return (int)err;
}

}  // extern "C"
