// K1: fused_quant_matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/fp4_matmul.py::fused_quant_matmul
// (_fused_kernel, pl.pallas_call at fp4_matmul.py:208), the FQT hot path:
// every training GEMM whose two operands are both quantized (forward,
// backward dX and update dW, core/fqt.py).  A (M, K) and B (K, N), bf16 or
// f32, are block-quantized on the fly with blocks along K (A along its
// rows, B along its columns), RtN or SR, with E4M3 (x a power-of-two tensor
// scale) or E8M0 block scales, and
//
//     out = (Q(A) @ Q(B)) * tsA * tsB      (f32 accumulation)
//
// in f32 or bf16.  The data and scale formats arrive as runtime constants
// (fp4::QuantParams), so the kernel takes every BlockQuantSpec the TPU
// kernel takes.  SR bits come from a uint32 tensor of the operand's shape,
// or (counter mode, what core/fqt.py passes) are hashed inside the
// quantizer from the site seed: counter_bits(seed)[r * row_stride + c *
// col_stride], the reference's splitmix32, bit for bit, so no bits tensor
// is drawn or read.
//
// What bounds it on an H100: at the training shapes (M = 4096 tokens, K and
// N in {4096, 11008, 32000}) the operations, 2*M*N*K (4096^3: 0.139 ms at
// the 989 TFLOP/s bf16 tensor-core rate); the operand bytes are ~100x below
// that line.
//
// What the design does about it:
//   * per operand, one |x| max reduction (atomicMax on the float bits) whose
//     power-of-two tensor scale stays on the device -- no host sync -- or,
//     for an operand that is one rank's shard of a larger tensor, the
//     given global |max| (a_amax / b_amax: a device f32 the caller
//     all-reduced) read in its place, so the shard quantizes as the whole
//     tensor does (the tensor-parallel GEMMs of core/fqt.py); and
//     one quantizer launch (fp4::quantize_operand_to), one thread per block
//     of `block` values in the TPU kernel's order of operations (the body
//     K2 and K4 run): raw = amax / (data_max * ts), scale = RtN onto the
//     scale format or 1, codes = RtN/SR(x / (scale * ts)).  It writes code
//     * scale to a workspace, each thread its block of 16 or 32 values in
//     16-byte stores; B's blocks run down a column, so neighbouring threads
//     read neighbouring addresses, and land transposed, contiguous.
//   * the route is chosen on the host from the two specs: where both
//     operands' data and scale mantissa bits sum to <= 6 (every preset:
//     E2M1 x E4M3 / E8M0) code * scale is exact in bf16, the workspaces are
//     bf16 A' (M, K) and B' transposed to (N, K), and the tensor-core core
//     of fp4_gemm.cuh (TMA ring + wgmma, f32 accumulation) computes the
//     product, times tsA * tsB in its epilogue.  Any other pair (e.g. E3M4
//     data under E4M3 scales) keeps f32 workspaces and the f32 CUDA-core
//     tile loop below: a route chosen by format, not a fallback.
#include "fp4_common.cuh"
#include "fp4_gemm.cuh"

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

// A given |max| is read as the bits the absmax pass would have written (a
// non-negative float orders like its bit pattern); null: the operand's own.
static unsigned int* amax_source(const float* given, unsigned int* ws) {
  return given ? reinterpret_cast<unsigned int*>(const_cast<float*>(given))
               : ws;
}

// ws_amax: 2 uint32, ws_ts: 2 f32 (tsA, tsB).  a_amax / b_amax: null, or a
// device f32 holding that operand's global |max| (its absmax pass is then
// skipped).  bf16_core = 1: aq_ws (M, K) and bq_ws (N, K) bf16, the
// tensor-core core; 0: aq_ws (M, K) and bq_ws (K, N) f32, the f32 tile
// loop.  sr_a / sr_b: each operand's SR source.
extern "C" int fp4_fused_quant_matmul(
    const void* a, int a_bf16, const void* b, int b_bf16,
    const fp4::SrBits* sr_a, const fp4::SrBits* sr_b, int M, int N, int K,
    int block, const fp4::QuantParams* qa, const fp4::QuantParams* qb,
    int bf16_core, unsigned int* ws_amax, float* ws_ts, const float* a_amax,
    const float* b_amax, void* aq_ws, void* bq_ws, void* out, int out_bf16,
    cudaStream_t stream) {
  unsigned int* am_a = amax_source(a_amax, ws_amax);
  unsigned int* am_b = amax_source(b_amax, ws_amax + 1);
  if (bf16_core) {
    auto* aq = static_cast<__nv_bfloat16*>(aq_ws);
    auto* bq = static_cast<__nv_bfloat16*>(bq_ws);
    fp4::quantize_operand_to(a, a_bf16, *sr_a, size_t(M), size_t(K), block,
                             0, 0, *qa, am_a, ws_ts, aq, stream,
                             a_amax != nullptr);
    fp4::quantize_operand_to(b, b_bf16, *sr_b, size_t(K), size_t(N), block,
                             1, 1, *qb, am_b, ws_ts + 1, bq, stream,
                             b_amax != nullptr);
    return fp4gemm::launch_gemm(aq, bq, M, N, K, ws_ts, ws_ts + 1, out,
                                out_bf16, stream);
  }
  auto* aq = static_cast<float*>(aq_ws);
  auto* bq = static_cast<float*>(bq_ws);
  fp4::quantize_operand_to(a, a_bf16, *sr_a, size_t(M), size_t(K), block, 0,
                           0, *qa, am_a, ws_ts, aq, stream,
                           a_amax != nullptr);
  fp4::quantize_operand_to(b, b_bf16, *sr_b, size_t(K), size_t(N), block, 1,
                           0, *qb, am_b, ws_ts + 1, bq, stream,
                           b_amax != nullptr);
  constexpr int BM = 64, BN = 64, BK = 32;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<BM, BN, BK, 4, 4><<<grid, (BM / 4) * (BN / 4), 0, stream>>>(
      aq, bq, ws_ts, out, out_bf16, M, N, K);
  return int(cudaGetLastError());
}
