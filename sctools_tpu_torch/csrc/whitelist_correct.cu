// Hamming <= 1 cell-barcode correction against a whitelist, for Hopper (sm_90a).
//
// Replaces the TPU kernel sctools_tpu/ops/whitelist.py::_pallas_kernel
// (:125-145, launched by _correct_pallas :148-184 through pl.pallas_call at
// :171) and computes its function:
//
//   out[q] = max { i : score(q, i) >= L - 1 }, or -1,
//
// where score is the one-hot product [n_q, 4L] x [4L, n_w]: the number of
// positions where both bases are A/C/G/T and equal (code 4, N or any other
// byte, is a zero group of four). For L == 1 every pair hits, N included.
// The largest hit index wins, so the last whitelist entry in file order
// wins, as in the reference's hash map.
//
// Operands. Both sides are int8 one-hot tables [rows, Kpad], K-major,
// Kpad = 32 * ceil(4L / 32) with zero pad columns: the whitelist's is built
// once (ops/whitelist.py make_table), the queries' per batch by the wrapper.
// Values are 0 and 1, so the product is exact in int8 with int32 sums, and it
// runs on the tensor cores: wgmma.mma_async m64n128k32 s32.s8.s8, Kpad / 32
// k-steps per tile.
//
// Tiling. Whitelist stationary, queries streamed. A CTA holds 512 whitelist
// rows in shared memory, 128 per consumer warpgroup (the wgmma N), and
// streams the whole query block through a ring of stages. All four
// consumers read every stage, so one query byte fetched from L2 feeds 512
// whitelist rows (what a 2-CTA cluster with TMA multicast would give at 256
// rows a CTA). One producer thread issues TMA loads (32-byte K blocks, 32B
// swizzle, one layout rule for every L) that complete on mbarriers; a stage
// is 512, 256 or 128 query rows, the most of which two stages fit.
// setmaxnreg moves registers from the producer to the consumers.
//
// Overlap. A consumer runs a 64-row job at a time: it issues the job's
// wgmmas, waits for them (wait_group 0), and reads its 64 accumulators out.
// Its tensor-core work stops while it does, so four consumers take turns:
// while some read out, the others' wgmmas keep the tensor cores busy. (Two
// accumulator sets in one consumer, reading one out while the other's wgmma
// runs, were slower: ptxas serializes wgmmas when a branch runs while one is
// in flight, and without the branch the wait exposes wgmma latency.)
//
// Epilogue. Per job a thread folds its 64 scores to one max (32 __vimax3_s32,
// one VIMNMX3 each); only when that max reaches L - 1 does it walk
// its fragment, keep per row the largest in-bounds column that hits, and
// atomicMax it into out (set to -1 first, by the memset in the entry point).
// Max is order-free, so the result is deterministic. TMA fills rows past n_q
// or n_w with zeros, which score 0 and so hit at L = 1: the walk masks by
// bounds (q < n_q, i < n_w), never by score.
//
// Bound. 2 * n_q * n_w * Kpad int8 operations: at 65,536 x 737,280 x 64 that
// is 6.2e12, 3.1 ms at the published 1,979 TOP/s. L2 feeds each CTA the query
// block once: n_q * Kpad * n_w / 512 bytes, 6.0 GB per such batch, which the
// tensor cores' 3.2 ms alone shows is not the limit. The gate costs about half
// a CUDA-core instruction per pair, 2.6 ms of integer work at that shape,
// and the two sides overlap only in part (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;                   // whitelist rows per consumer: the wgmma N
constexpr int kConsumers = 4;
constexpr int kSliceRows = kCols * kConsumers;  // whitelist rows per CTA
constexpr int kThreads = 128 * (1 + kConsumers);
// setmaxnreg draws on the CTA's own pool: the consumers share what the
// producer gives back, on top of what every thread got at launch
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = (kLaunchRegs + (kLaunchRegs - kProducerRegs) / kConsumers) / 8 * 8;
constexpr int kM = 64;                       // wgmma M
constexpr int kSmemLimit = 232448;           // per block, opt-in
constexpr int kMaxStages = 6;
static_assert(kLaunchRegs <= 255 && kConsumerRegs <= 256, "setmaxnreg range");

template <int KB>  // KB = Kpad / 32, the k-steps per tile
struct Shape {
  static constexpr int kKpad = 32 * KB;
  static constexpr int kWBytes = kSliceRows * kKpad;
  static constexpr int kRoom = kSmemLimit - 1024 - 256 - kWBytes;
  // query rows per pipeline stage: the largest of 512, 256 and 128 of which
  // two stages fit (fewer, larger stages measured faster), loaded in TMA
  // boxes of at most 256 rows
  static constexpr int kStageRows = kRoom / (512 * kKpad) >= 2   ? 512
                                    : kRoom / (256 * kKpad) >= 2 ? 256
                                                                 : 128;
  static constexpr int kBox = kStageRows < 256 ? kStageRows : 256;
  static constexpr int kStageBytes = kStageRows * kKpad;
  static constexpr int kFit = kRoom / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = 1024 + kWBytes + kStages * kStageBytes + 256;
  static_assert(kStages >= 2, "shared memory too small for the pipeline");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major 32B-swizzled tile: rows of
// 32 bytes (one k-step), 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kLeading = 1;          // unused for swizzled K-major
  constexpr uint64_t kStride = 256 >> 4;    // between 8-row groups
  constexpr uint64_t kSwizzle32B = 3;
  return ((addr & 0x3FFFF) >> 4) | (kLeading << 16) | (kStride << 32) | (kSwizzle32B << 62);
}

// a consumer's accumulators: one 64 x 128 wgmma tile, 64 int32 a thread
typedef int32_t Acc[kCols / 2];

// keeps the compiler from moving accumulator accesses across the wgmma fences
__device__ __forceinline__ void fence_acc(Acc& d) {
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define WG_D16(i) WG_D4(i), WG_D4(i + 4), WG_D4(i + 8), WG_D4(i + 12)

// d (+)= A[64 x 32] * B[128 x 32]^T; A and B are descriptors, accumulate != 0
// adds to d, 0 overwrites it.
__device__ __forceinline__ void wgmma_s8(Acc& d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The max of a thread's 64 scores in 32 three-way maxes: eight independent
// chains of three, so the folds overlap, then a tree over what is left.
__device__ __forceinline__ int fragment_max(const Acc& d) {
  static_assert(kCols / 2 == 64, "the fold is written for 64 scores");
  int part[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    part[k] = __vimax3_s32(d[k], d[8 + k], d[16 + k]);
    part[k] = __vimax3_s32(part[k], d[24 + k], d[32 + k]);
    part[k] = __vimax3_s32(part[k], d[40 + k], d[48 + k]);
  }
  const int a0 = __vimax3_s32(part[0], part[1], d[56]), a1 = __vimax3_s32(part[2], part[3], d[57]);
  const int a2 = __vimax3_s32(part[4], part[5], d[58]), a3 = __vimax3_s32(part[6], part[7], d[59]);
  const int b0 = __vimax3_s32(a0, a1, d[60]), b1 = __vimax3_s32(a2, a3, d[61]);
  return max(__vimax3_s32(b0, b1, d[62]), d[63]);
}

// The rare path. wgmma's accumulator layout (m64nN, 32-bit): the thread
// with lane l of warp w holds rows 16w + l/4 (d[4b], d[4b + 1]) and
// 16w + l/4 + 8 (d[4b + 2], d[4b + 3]) at columns 8b + 2(l % 4) + {0, 1}.
__device__ __forceinline__ void record_hits(const Acc& d, int threshold, int row, int col0,
                                            int n_q, int n_w, int32_t* out) {
  int best_lo = -1, best_hi = -1;
#pragma unroll
  for (int b = 0; b < kCols / 8; ++b) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * b + e;  // ascending: the last hit is the largest
      if (col < n_w) {
        if (d[4 * b + e] >= threshold) best_lo = col;
        if (d[4 * b + 2 + e] >= threshold) best_hi = col;
      }
    }
  }
  if (best_lo >= 0 && row < n_q) atomicMax(out + row, best_lo);
  if (best_hi >= 0 && row + 8 < n_q) atomicMax(out + row + 8, best_hi);
}

template <int KB>
__global__ void __launch_bounds__(kThreads, 1)
whitelist_correct_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap w_map, int n_q, int n_w,
                         int threshold, int32_t* __restrict__ out) {
  using S = Shape<KB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  // [consumer][k-step][128 rows][32 B], then [stage][k-step][stage rows][32 B]
  const uint32_t w_smem = base;
  const uint32_t q_smem = base + S::kWBytes;
  const uint32_t bars = q_smem + S::kStages * S::kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S::kStages + s); };
  const uint32_t w_full = bars + 16 * S::kStages;

  const int warpgroup = threadIdx.x / 128;
  const int n_tiles = (n_q + S::kStageRows - 1) / S::kStageRows;
  const int slice = blockIdx.x * kSliceRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // lane 0 of every consumer warp
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(w_full, S::kWBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int k = 0; k < KB; ++k)
          tma_load(w_smem + (c * KB + k) * kCols * 32, &w_map, w_full, 32 * k,
                   slice + c * kCols);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S::kStages;
        mbar_wait(empty(s), ((t / S::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), S::kStageBytes);
        for (int k = 0; k < KB; ++k)
          for (int r = 0; r < S::kStageRows; r += S::kBox)
            tma_load(q_smem + s * S::kStageBytes + (k * S::kStageRows + r) * 32, &q_map, full(s),
                     32 * k, t * S::kStageRows + r);
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int consumer = warpgroup - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const uint32_t b_smem = w_smem + consumer * KB * kCols * 32;
    const int col0 = slice + consumer * kCols + 2 * (lane % 4);
    Acc d;
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) d[i] = 0;
    mbar_wait(w_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S::kStages;
      mbar_wait(full(s), (t / S::kStages) & 1);
      const uint32_t a_smem = q_smem + s * S::kStageBytes;
#pragma unroll
      for (int h = 0; h < S::kStageRows / kM; ++h) {
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int k = 0; k < KB; ++k)
          wgmma_s8(d, smem_desc(a_smem + k * S::kStageRows * 32 + h * kM * 32),
                   smem_desc(b_smem + k * kCols * 32), k);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        // the stage's last reads are done: hand it back before the epilogue
        if (h == S::kStageRows / kM - 1 && lane == 0) mbar_arrive(empty(s));
        if (fragment_max(d) >= threshold)
          record_hits(d, threshold, t * S::kStageRows + h * kM + 16 * warp + lane / 4, col0, n_q,
                      n_w, out);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API: fetched through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [rows, kpad] int8 table read in boxes of 32 bytes x box_rows.
bool make_map(CUtensorMap* map, const void* data, int rows, int kpad, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kpad), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kpad)};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(data), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KB>
cudaError_t launch(const void* queries, int n_q, int length, const void* table, int n_w,
                   int32_t* out, cudaStream_t stream) {
  using S = Shape<KB>;
  CUtensorMap q_map, w_map;
  if (!make_map(&q_map, queries, n_q, S::kKpad, S::kBox) ||
      !make_map(&w_map, table, n_w, S::kKpad, kCols))
    return cudaErrorInvalidValue;
  cudaError_t status = cudaFuncSetAttribute(
      whitelist_correct_kernel<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (status != cudaSuccess) return status;
  const int grid = (n_w + kSliceRows - 1) / kSliceRows;
  whitelist_correct_kernel<KB><<<grid, kThreads, S::kSmem, stream>>>(q_map, w_map, n_q, n_w,
                                                                     length - 1, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// queries: int8 one-hot [n_q, Kpad]; table: int8 one-hot [n_w, Kpad], Kpad =
// 32 * ceil(4 * length / 32), both contiguous and 16-byte aligned; out:
// int32 [n_q]. Everything lies on the device; the work is queued on `stream`
// and not awaited. Returns cudaGetLastError() after the launch (0 on
// success); 1 (cudaErrorInvalidValue) for a length the kernel is not built
// for or a table TMA cannot describe.
int whitelist_correct(const void* queries, int n_q, int length, const void* table, int n_w,
                      void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_q <= 0) return 0;
  if (length < 1 || length > 64 || n_w < 0) return cudaErrorInvalidValue;
  cudaError_t status = cudaMemsetAsync(out, 0xFF, sizeof(int32_t) * n_q, s);
  if (status != cudaSuccess) return status;
  if (n_w == 0) return cudaGetLastError();
  int32_t* o = static_cast<int32_t*>(out);
  switch ((4 * length + 31) / 32) {
    case 1: return launch<1>(queries, n_q, length, table, n_w, o, s);
    case 2: return launch<2>(queries, n_q, length, table, n_w, o, s);
    case 3: return launch<3>(queries, n_q, length, table, n_w, o, s);
    case 4: return launch<4>(queries, n_q, length, table, n_w, o, s);
    case 5: return launch<5>(queries, n_q, length, table, n_w, o, s);
    case 6: return launch<6>(queries, n_q, length, table, n_w, o, s);
    case 7: return launch<7>(queries, n_q, length, table, n_w, o, s);
    default: return launch<8>(queries, n_q, length, table, n_w, o, s);
  }
}

}  // extern "C"
