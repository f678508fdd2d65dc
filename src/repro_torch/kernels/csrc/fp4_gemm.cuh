// The tensor-core GEMM core that K1 (fused_quant_matmul.cu) and K3
// (block_matmul.cu) share on Hopper (sm_90a):
//
//     out (M, N) = (A' (M, K) @ B' (N, K)^T) * ts_a[0] * ts_b[0]
//
// A' and B' are bf16 and K-major (row-major, K contiguous); out is f32 or
// bf16, row-major.  ts_a and ts_b are f32 device scalars (ts_b may be null)
// read in the epilogue, so no call waits on the host.  Each caller first
// writes code x block scale into A' and B' -- exact in bf16 wherever the
// data and scale formats' mantissa bits sum to <= 6 (E2M1 x E4M3, E2M1 x
// E8M0, E2M1 x E3M4) -- and the tensor scales stay out of the operands.
//
// What bounds it on an H100: operations (2*M*N*K at the 989 TFLOP/s bf16
// dense rate); at the training shapes its operand bytes lie ~100x below.
//
// Design, a pipelined tensor-core GEMM kept simple and right first:
//   * 128 x 256 output tiles, 64-deep K steps (128 bytes of bf16: one
//     128B-swizzle row), tiles ordered in groups of 8 tile rows so that a
//     wave of blocks shares its A and B tiles in L2;
//   * a ring of STAGES A and B tiles in shared memory, filled by TMA
//     (cp.async.bulk.tensor, 128B swizzle) from one producer warp, each
//     stage with a "full" mbarrier (TMA bytes arrived) and an "empty" one
//     (both consumer warpgroups done reading);
//   * two consumer warpgroups, 64 rows of the tile each, issuing
//     wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate) from shared
//     memory on both operands; one wgmma group stays in flight while the
//     previous stage is released;
//   * TMA zero-fills rows past M or N and columns past K, so ragged edges
//     need no special load path (K % 8 == 0 keeps the row pitch a multiple
//     of 16 bytes, as TMA requires); the epilogue scales the registers by
//     ts_a * ts_b and masks its stores at the M and N edges.
// The tensor maps are encoded on the host per launch with
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so that the
// library needs no -lcuda, and passed as __grid_constant__ parameters.
// Left for later: persistent tiles, clusters, TMA stores, setmaxnreg.
#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fp4gemm {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                      // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;     // + one producer warp
constexpr int GROUP_M = 8;                        // tile rows per L2 group
constexpr int TILE_A_BYTES = BM * BK * 2;
constexpr int TILE_B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = TILE_A_BYTES + TILE_B_BYTES;
// the ring, 1024-byte aligned for the 128B swizzle, then 2 * STAGES barriers
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait past ~2^34
// cycles (seconds; a real one takes microseconds) is a pipeline fault: trap,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of `map` into dst, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128B swizzle: rows
// of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused (16 bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, bf16) @ B (256 x 16, bf16)^T, both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const float* __restrict__ ts_a, const float* __restrict__ ts_b,
            void* __restrict__ out, int out_bf16, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  auto tile_a = [smem](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES);
  };
  auto tile_b = [smem](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE_BYTES +
                                            TILE_A_BYTES);
  };

  // grouped tile order: GROUP_M tile rows walk the tile columns together
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int t = blockIdx.x, per_group = GROUP_M * tiles_n;
  const int first_m = (t / per_group) * GROUP_M;
  const int rows_in_group = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (t % per_group) % rows_in_group) * BM;
  const int n0 = ((t % per_group) / rows_in_group) * BN;
  const int nk = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- producer warp: one lane keeps the ring full ----
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(tile_a(s), &map_a, &full[s], kt * BK, m0);
        tma_load_2d(tile_b(s), &map_b, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows wg * 64 .. wg * 64 + 63 of the tile ----
  const int wg = threadIdx.x / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const __nv_bfloat16* a = tile_a(s) + wg * 64 * BK;
    const __nv_bfloat16* b = tile_b(s);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n256k16(acc, smem_desc(a + k * 16), smem_desc(b + k * 16));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
    fence_acc(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // ---- epilogue: accumulator fragment -> out * ts_a * ts_b ----
  // acc[4j + 2h + e] holds row 16 * (warp % 4) + lane / 4 + 8h, column
  // 8j + 2 * (lane % 4) + e of the warpgroup's 64 x BN block.
  const float scale = ts_b ? __fmul_rn(ts_a[0], ts_b[0]) : ts_a[0];
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // (col, col + 1) stores stay aligned
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      const float v0 = acc[4 * j + 2 * h] * scale;
      const float v1 = acc[4 * j + 2 * h + 1] * scale;
      const size_t o = size_t(row) * N + col;
      if (out_bf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
        }
      } else {
        float* p = static_cast<float*>(out) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < N) p[1] = v1;
        }
      }
    }
  }
}

// ---- host side ----
// Each library that includes this header (K1's and K3's) has its own
// gemm_kernel registered with its own CUDA runtime, so the host helpers are
// `static` (internal linkage): an inline function's static local would be
// one symbol shared by every loaded library.

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major bf16 (rows, K) operand in boxes of box_rows x
// BK, 128B swizzle, zero fill past the edges.
static bool encode_operand(CUtensorMap* map, const __nv_bfloat16* p,
                           int rows, int K, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(K) * 2};
  const cuuint32_t box[2] = {cuuint32_t(BK), cuuint32_t(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<__nv_bfloat16*>(p), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out (M, N) = (a (M, K) @ b (N, K)^T) * ts_a[0] * (ts_b ? ts_b[0] : 1) on
// `stream`; a and b bf16 K-major with K % 8 == 0 and 16-byte aligned bases.
// Returns a cudaError_t (cudaErrorInvalidValue if a tensor map is refused).
static int launch_gemm(const __nv_bfloat16* a, const __nv_bfloat16* b,
                       int M, int N, int K, const float* ts_a,
                       const float* ts_b, void* out, int out_bf16,
                       cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!encode_operand(&map_a, a, M, K, BM) ||
      !encode_operand(&map_b, b, N, K, BN))
    return int(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return int(attr);
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  gemm_kernel<<<tiles, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_b, ts_a, ts_b, out, out_bf16, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace fp4gemm
