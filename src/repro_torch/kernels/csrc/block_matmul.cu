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
// What the design does about it, kept simple and right first:
//   * K1's f32 CUDA-core tile loop (64 x 64 output tiles, 32-deep K steps,
//     a 4 x 4 register micro-tile per thread, ragged M, N and K edges
//     masked), with the dequantization done in the tile load: each code is
//     multiplied by its block scale on its way into shared memory, so no
//     dequantized operand is written to device memory.  Code x E4M3 scale
//     is exact in f32 (and in bf16), so the tiles hold exactly what K1's
//     quantizer writes to its workspace and the sums run in K1's order.
//   * no tensor cores, TMA or pipelining yet: wgmma on bf16 tiles (exact for
//     E2M1 x E4M3) with f32 accumulation is the next step.
#include "fp4_common.cuh"

namespace {

template <int BM, int BN, int BK, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
block_matmul_kernel(const void* __restrict__ ac, int a_bf16,
                    const float* __restrict__ as,
                    const void* __restrict__ bc, int b_bf16,
                    const float* __restrict__ bs,
                    const float* __restrict__ tscale,
                    float* __restrict__ out, int M, int N, int K,
                    int block) {
  constexpr int TX = BN / RN, TY = BM / RM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = K / block;
  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      int mm = i / BK, kk = i % BK;
      int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K)
                       ? __fmul_rn(fp4::load_f(ac, size_t(m) * K + k, a_bf16),
                                   as[size_t(m) * kb + k / block])
                       : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk = i / BN, nn = i % BN;
      int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N)
                       ? __fmul_rn(fp4::load_f(bc, size_t(k) * N + n, b_bf16),
                                   bs[size_t(k / block) * N + n])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[RM], bv[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) av[r] = As[kk][ty * RM + r];
#pragma unroll
      for (int c = 0; c < RN; ++c) bv[c] = Bs[kk][tx * RN + c];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  const float s = *tscale;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    int m = m0 + ty * RM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      int n = n0 + tx * RN + c;
      if (n < N) out[size_t(m) * N + n] = acc[r][c] * s;
    }
  }
}

}  // namespace

// a_codes (M, K), b_codes (K, N): f32 or bf16; a_scales (M, K/block),
// b_scales (K/block, N), tscale (1): f32; out (M, N) f32.
extern "C" int fp4_block_matmul(const void* a_codes, int a_bf16,
                                const float* a_scales, const void* b_codes,
                                int b_bf16, const float* b_scales,
                                const float* tscale, int M, int N, int K,
                                int block, float* out, cudaStream_t stream) {
  constexpr int BM = 64, BN = 64, BK = 32;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  block_matmul_kernel<BM, BN, BK, 4, 4><<<grid, (BM / 4) * (BN / 4), 0,
                                          stream>>>(
      a_codes, a_bf16, a_scales, b_codes, b_bf16, b_scales, tscale, out, M, N,
      K, block);
  return int(cudaGetLastError());
}
