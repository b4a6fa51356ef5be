// Hamming <= 1 cell-barcode correction against a whitelist, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/whitelist.py::_pallas_kernel
// (:125-145, launched by _correct_pallas :148-184 through pl.pallas_call at
// :171). That kernel scores one-hot barcodes with f32 matmuls on the MXU,
// [256, 4L] x [4L, 2048] per grid step, and keeps a running max of the hit
// index in its output block. This kernel computes the same function, not the
// same blocks:
//
//   out[q] = max { i : hamming'(query[q], whitelist[i]) <= 1 }, or -1,
//
// where hamming' counts a position as a mismatch when the two bases differ
// OR either side is not an uppercase A/C/G/T (code 4). That is exactly the
// TPU kernel's "score >= L - 1", because the one-hot score counts the
// positions where both bases are ACGT and equal. For L == 1 every pair hits,
// N included, as in _correct_jnp. The largest hit index wins, so the last
// whitelist entry in file order wins, as in the reference's hash map.
//
// Design. Barcodes are packed 2 bits per base, 16 bases per 32-bit word
// (W = ceil(L / 16) words), with a second word per 16 bases holding one bit
// (at the even position 2k) per N base. For one word pair
//
//   x = q ^ w;  d = ((x | x >> 1) & 0x55555555) | qN | wN
//
// has one bit per mismatching base, and a hit is popc summed over the words
// <= 1. Positions past L are 0 in every word on both sides, so they never
// count. Each thread holds kQueriesPerThread queries in registers, the block
// stages whitelist tiles in shared memory (every thread reads the same entry
// at once: a broadcast, no bank conflict), and each query keeps a running
// best index. The ragged edges are masked by bounds, never by score.
//
// Grid. x walks query tiles; y splits the whitelist into ranges so the card
// has enough blocks at n_q = 65,536 (64 query tiles alone would leave most of
// 132 SMs idle). Ranges combine with atomicMax on the int32 output, which the
// launcher first sets to -1 (all bytes 0xFF). Max is commutative and
// associative, so the result does not depend on block order.
//
// Bound. Per pair the work is integer ALU: per word an xor, a shift and two
// 3-input logic ops (LOP3) make the mismatch mask and one POPC counts it;
// per pair a compare and a select keep the best index (6 INT32 ops and 1
// POPC at L <= 16). At the 10x v2 slice shape (65,536 queries x 737,280
// barcodes = 4.8e10 pairs) that is 2.9e11 INT32 ops at 64 per clock per SM
// and 4.8e10 POPC at 16 per clock per SM, so INT32 issue bounds it;
// chip_smoke.py works the time out from the card's SM count and clock. The
// packed whitelist is 737,280 x 8 bytes = 5.9 MB and stays in L2, so bytes
// do not bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueriesPerThread = 4;
constexpr int kTileW = 1024;          // whitelist entries per shared-memory tile
constexpr int kMinPerBlock = 8192;    // whitelist entries per block (y range)
constexpr uint32_t kEven = 0x55555555u;

template <int W>
__global__ void __launch_bounds__(kThreads)
whitelist_correct_kernel(const uint8_t* __restrict__ queries, int n_q, int length,
                         const uint32_t* __restrict__ table, int n_w,
                         int per_block, int32_t* __restrict__ out) {
  __shared__ uint32_t tile[kTileW * 2 * W];

  const int q_base = blockIdx.x * (kThreads * kQueriesPerThread);
  uint32_t q_bits[kQueriesPerThread][W];
  uint32_t q_n[kQueriesPerThread][W];
  int best[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    best[k] = -1;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      q_bits[k][w] = 0;
      q_n[k][w] = 0;
    }
    const int q = q_base + k * kThreads + threadIdx.x;
    if (q < n_q) {
      const uint8_t* codes = queries + static_cast<int64_t>(q) * length;
      for (int p = 0; p < length; ++p) {
        const uint32_t c = codes[p];
        const int w = p >> 4;
        const int shift = 2 * (p & 15);
        // code 4 (or anything else past T) is N: set its mismatch bit
#pragma unroll
        for (int ww = 0; ww < W; ++ww) {
          if (ww == w) {
            if (c < 4) q_bits[k][ww] |= c << shift;
            else q_n[k][ww] |= 1u << shift;
          }
        }
      }
    }
  }

  const int w_begin = blockIdx.y * per_block;
  const int w_end = min(n_w, w_begin + per_block);
  for (int t0 = w_begin; t0 < w_end; t0 += kTileW) {
    const int count = min(kTileW, w_end - t0);
    __syncthreads();  // the previous tile is no longer read
    const uint32_t* src = table + static_cast<int64_t>(t0) * 2 * W;
    for (int i = threadIdx.x; i < count * 2 * W; i += kThreads) tile[i] = src[i];
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      uint32_t w_bits[W], w_n[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        w_bits[w] = tile[j * 2 * W + w];
        w_n[w] = tile[j * 2 * W + W + w];
      }
      const int index = t0 + j;
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) {
        int mismatches = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t x = q_bits[k][w] ^ w_bits[w];
          const uint32_t d = ((x | (x >> 1)) & kEven) | q_n[k][w] | w_n[w];
          mismatches += __popc(d);
        }
        // indices rise within a block's range: the last hit is the largest
        best[k] = mismatches <= 1 ? index : best[k];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int q = q_base + k * kThreads + threadIdx.x;
    if (q < n_q && best[k] >= 0) atomicMax(out + q, best[k]);
  }
}

template <int W>
cudaError_t launch(const uint8_t* queries, int n_q, int length,
                   const uint32_t* table, int n_w, int32_t* out,
                   cudaStream_t stream) {
  const int per_query_tile = kThreads * kQueriesPerThread;
  // whitelist range per block: at least kMinPerBlock entries, and few enough
  // ranges to fit gridDim.y (65,535)
  int per_block = kMinPerBlock;
  while ((n_w + per_block - 1) / per_block > 65535) per_block *= 2;
  dim3 grid((n_q + per_query_tile - 1) / per_query_tile,
            (n_w + per_block - 1) / per_block);
  whitelist_correct_kernel<W><<<grid, kThreads, 0, stream>>>(
      queries, n_q, length, table, n_w, per_block, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries: uint8 codes [n_q, length] (A/C/G/T = 0-3, anything else N);
// table: the packed whitelist [n_w, 2 * ceil(length / 16)] uint32 words,
// each row W base words then W N-mask words; out: int32 [n_q]. Everything
// lies on the device; the work is queued on `stream` and not awaited.
// Returns cudaGetLastError() after the launch (0 on success); 1
// (cudaErrorInvalidValue) for a length the kernel is not built for.
int whitelist_correct(const void* queries, int n_q, int length, const void* table,
                      int n_w, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (length < 1 || length > 64 || n_w < 0) return cudaErrorInvalidValue;
  cudaError_t status = cudaMemsetAsync(out, 0xFF, sizeof(int32_t) * n_q, s);
  if (status != cudaSuccess) return status;
  if (n_w == 0) return cudaGetLastError();
  const uint8_t* q = static_cast<const uint8_t*>(queries);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  int32_t* o = static_cast<int32_t*>(out);
  switch ((length + 15) / 16) {
    case 1: return launch<1>(q, n_q, length, t, n_w, o, s);
    case 2: return launch<2>(q, n_q, length, t, n_w, o, s);
    case 3: return launch<3>(q, n_q, length, t, n_w, o, s);
    default: return launch<4>(q, n_q, length, t, n_w, o, s);
  }
}

}  // extern "C"
