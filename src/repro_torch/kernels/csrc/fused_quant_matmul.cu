// K1: fused_quant_matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/fp4_matmul.py::fused_quant_matmul
// (_fused_kernel, pl.pallas_call at fp4_matmul.py:208), the FQT hot path:
// every training GEMM whose two operands are both quantized (forward,
// backward dX and update dW, core/fqt.py).  A (M, K) and B (K, N), bf16 or
// f32, are block-quantized on the fly with blocks along K (A along its
// rows, B along its columns), RtN or SR from given uint32 bits, with E4M3
// (x a power-of-two tensor scale) or E8M0 block scales, and
//
//     out = (Q(A) @ Q(B)) * tsA * tsB      (f32 accumulation)
//
// in f32 or bf16.  The data and scale formats arrive as runtime constants
// (fp4::QuantParams), so the kernel takes every BlockQuantSpec the TPU
// kernel takes.
//
// What bounds it on an H100: at the training shapes (M = 4096 tokens, K and
// N in {4096, 11008, 32000}) the operations, 2*M*N*K (4096^3: 0.139 ms at
// the 989 TFLOP/s bf16 tensor-core rate); the operand bytes are ~100x below
// that line.
//
// What the design does about it, kept simple and right first:
//   * per operand, one |x| max reduction (atomicMax on the float bits) whose
//     power-of-two tensor scale stays on the device -- no host sync -- and
//     one quantizer launch (fp4::quantize_operand, shared with K4), one
//     thread per block of `block` values, in the TPU kernel's order of
//     operations: raw = amax / (data_max * ts), scale = RtN onto the scale
//     format or 1, codes = RtN/SR(x / (scale * ts)).  It writes code *
//     scale (exact in f32) to a workspace.  B's blocks run down a column,
//     so neighbouring threads read neighbouring addresses.
//   * a tiled f32 GEMM over the two workspaces: 64 x 64 output tiles, a
//     4 x 4 register micro-tile per thread, ragged M, N and K edges masked,
//     and the sum scaled by tsA * tsB at the end.  The products of two
//     dequantized operands (a few significant bits each) sum exactly in f32
//     in almost any order, so the result matches the plain version.
//   * no tensor cores, TMA or pipelining yet: code * scale is exact in bf16
//     for E2M1 data, so a wgmma on bf16 operands with f32 accumulation is
//     the next step.
#include "fp4_common.cuh"

namespace {

// out (M, N) = (aq (M, K) @ bq (K, N)) * ts[0] * ts[1], row-major f32 in.
template <int BM, int BN, int BK, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
gemm_f32_kernel(const float* __restrict__ aq, const float* __restrict__ bq,
                const float* __restrict__ ts, void* __restrict__ out,
                int out_bf16, int M, int N, int K) {
  constexpr int TX = BN / RN, TY = BM / RM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      int mm = i / BK, kk = i % BK;
      int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? aq[size_t(m) * K + k] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      int kk = i / BN, nn = i % BN;
      int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? bq[size_t(k) * N + n] : 0.f;
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
  const float s = __fmul_rn(ts[0], ts[1]);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    int m = m0 + ty * RM + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      int n = n0 + tx * RN + c;
      if (n >= N) continue;
      float v = acc[r][c] * s;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[size_t(m) * N + n] =
            __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[size_t(m) * N + n] = v;
    }
  }
}

}  // namespace

// ws_amax: 2 uint32, ws_ts: 2 f32 (tsA, tsB), aq_ws: M*K f32, bq_ws: K*N f32.
extern "C" int fp4_fused_quant_matmul(
    const void* a, int a_bf16, const void* b, int b_bf16,
    const uint32_t* a_rbits, const uint32_t* b_rbits, int M, int N, int K,
    int block, const fp4::QuantParams* qa, const fp4::QuantParams* qb,
    unsigned int* ws_amax, float* ws_ts, float* aq_ws, float* bq_ws,
    void* out, int out_bf16, cudaStream_t stream) {
  fp4::quantize_operand(a, a_bf16, a_rbits, size_t(M), size_t(K), block, 0,
                        *qa, ws_amax, ws_ts, aq_ws, stream);
  fp4::quantize_operand(b, b_bf16, b_rbits, size_t(K), size_t(N), block, 1,
                        *qb, ws_amax + 1, ws_ts + 1, bq_ws, stream);
  constexpr int BM = 64, BN = 64, BK = 32;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<BM, BN, BK, 4, 4><<<grid, (BM / 4) * (BN / 4), 0, stream>>>(
      aq_ws, bq_ws, ws_ts, out, out_bf16, M, N, K);
  return int(cudaGetLastError());
}
