// K3: block_matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/fp4_matmul.py::block_matmul
// (_block_matmul_kernel, pl.pallas_call at fp4_matmul.py:71): the product of
// two pre-quantized operands, A codes (M, K) with f32 block scales (M, K/B)
// and B codes (K, N) with f32 block scales (K/B, N), both blocked along K,
// codes in f32 or bf16 (K2's output dtype):
//
//     out = ((A codes * A scales) @ (B codes * B scales)) * tscale
//
// in f32 with f32 accumulation; tscale (tsA * tsB) is a device scalar read
// in the epilogue, so no call waits on the host.
//
// What bounds it on an H100: operations.  At 4096^3 it does 137.4 GFLOP:
// 0.139 ms at the 989 TFLOP/s bf16 tensor-core rate, against 0.063 ms for
// its bytes (f32 codes, scales and output, ~210 MB at 3.35 TB/s).
//
// What the design does about it:
//   * a dequantization pre-pass writes A' = codes * scales as bf16 (M, K)
//     and B' as bf16 (N, K), the transpose of B's codes * scales (through
//     32 x 32 shared-memory tiles, so reads and writes stay coalesced): no
//     division by the block size, dtype branch or scale gather is left in
//     the GEMM.  It moves ~200 MB at 4096^3 on f32 codes.
//   * the tensor-core core of fp4_gemm.cuh (TMA ring + wgmma on bf16, f32
//     accumulation), the same core and order as K1, times tscale in its
//     epilogue; so the unfused chain K2 -> K2 -> K3 gives K1's bits.
// Domain: code * scale is exact in bf16 for every operand K2 writes under
// a spec whose data and scale mantissa bits sum to <= 6 (every spec in the
// repository); there the result equals the f32 reference up to summation
// order.  For codes off that grid K3 rounds code * scale to bf16.
#include "fp4_common.cuh"
#include "fp4_gemm.cuh"

namespace {

constexpr int T = 32;  // transpose tile

// dst (M, K) bf16 = codes (M, K) * scales (M, K/block), one value a thread.
__global__ void dequant_rows_kernel(const void* __restrict__ codes,
                                    int c_bf16,
                                    const float* __restrict__ scales,
                                    size_t n, int K, int block,
                                    __nv_bfloat16* __restrict__ dst) {
  const int kb = K / block;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t m = i / K;
    const int k = int(i % K);
    dst[i] = __float2bfloat16_rn(__fmul_rn(fp4::load_f(codes, i, c_bf16),
                                           scales[m * kb + k / block]));
  }
}

// dst (N, K) bf16 = (codes (K, N) * scales (K/block, N))^T in T x T tiles.
__global__ void dequant_t_kernel(const void* __restrict__ codes, int c_bf16,
                                 const float* __restrict__ scales, int K,
                                 int N, int block,
                                 __nv_bfloat16* __restrict__ dst) {
  __shared__ float tile[T][T + 1];
  const int n0 = blockIdx.x * T, k0 = blockIdx.y * T;
  for (int i = threadIdx.y; i < T; i += blockDim.y) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    if (k < K && n < N)
      tile[i][threadIdx.x] =
          __fmul_rn(fp4::load_f(codes, size_t(k) * N + n, c_bf16),
                    scales[size_t(k / block) * N + n]);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < T; i += blockDim.y) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < N && k < K)
      dst[size_t(n) * K + k] = __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

}  // namespace

// a_codes (M, K), b_codes (K, N): f32 or bf16; a_scales (M, K/block),
// b_scales (K/block, N), tscale (1): f32; a_ws (M, K), b_ws (N, K): bf16
// workspaces; out (M, N) f32.  K % 8 == 0.
extern "C" int fp4_block_matmul(const void* a_codes, int a_bf16,
                                const float* a_scales, const void* b_codes,
                                int b_bf16, const float* b_scales,
                                const float* tscale, int M, int N, int K,
                                int block, __nv_bfloat16* a_ws,
                                __nv_bfloat16* b_ws, float* out,
                                cudaStream_t stream) {
  const size_t n = size_t(M) * K;
  const size_t want = (n + 255) / 256;
  dequant_rows_kernel<<<unsigned(want < 8192 ? want : 8192), 256, 0,
                        stream>>>(a_codes, a_bf16, a_scales, n, K, block,
                                  a_ws);
  dequant_t_kernel<<<dim3((N + T - 1) / T, (K + T - 1) / T), dim3(T, 8), 0,
                     stream>>>(b_codes, b_bf16, b_scales, K, N, block, b_ws);
  return fp4gemm::launch_gemm(a_ws, b_ws, M, N, K, tscale, nullptr, out, 0,
                              stream);
}
