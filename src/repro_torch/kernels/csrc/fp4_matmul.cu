// K4: packed_block_matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/fp4_matmul.py::packed_block_matmul
// (_packed_kernel, pl.pallas_call at fp4_matmul.py:309): A (M,K) bf16/f32
// is quantized on the fly (NVFP4 RtN on the serving path; SR from given
// uint32 bits and E8M0 block scales are also taken), B arrives as (K, N/2)
// uint8 E2M1 nibble pairs + (K/block_b, N) float8_e4m3fn block scales + a
// pow2 f32 tensor scale, and out = (Q(A) @ dequant(B)) * tsA * tsB with f32
// accumulation.
//
// What bounds it on an H100: at decode (M = 4) the product is a GEMV-like
// stream of the packed weight, 0.5625 B/param, so device-memory bytes bound
// it (4096 x 4096: 9.4 MB, 2.8 us at 3.35 TB/s).  At prefill (M = 256)
// the operations bound it (2*M*N*K; tensor cores would make it ~10 us per
// 4096 x 4096, the f32 CUDA-core path used here is ~15x slower).
//
// What the design does about it, kept simple and right first:
//   * three launches on the caller's stream: (1) an |A| max reduction
//     (atomicMax on the float bits) for the tensor scale, which stays on
//     the device -- no host sync; (2) a quantizer, one thread per A block,
//     writing codes*scale in f32 (exact) to a workspace -- the same order of
//     operations as the TPU kernel: raw = amax/(6*tsa), scale =
//     RtN_e4m3(raw) or 1, codes = RtN_e2m1(x/(scale*tsa)); (1) and (2) are
//     fp4::quantize_operand, shared with K1, so any A spec is taken; (3) a
//     tiled
//     f32 GEMM that reads each packed B tile once per output tile,
//     unpacks nibbles and decodes the E4M3 scale bytes in shared memory,
//     and scales the sum by tsA*tsB at the end.
//   * decode tiles are 8 x 16 outputs (N/16 blocks: 256 for N = 4096) so
//     M = 4 still spreads the weight stream over every SM; prefill tiles
//     are 64 x 64 with a 4 x 4 register micro-tile.
//   * no tensor cores, TMA or pipelining yet: wgmma on bf16 operands is
//     exact (E2M1 x E4M3 fits in bf16) and is later work.
#include "fp4_common.cuh"

namespace {

template <int BM, int BN, int BK, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN))
packed_gemm_kernel(const float* __restrict__ aq,
                   const uint8_t* __restrict__ bp,
                   const uint8_t* __restrict__ bs,
                   const float* __restrict__ tsa,
                   const float* __restrict__ tsb, void* __restrict__ out,
                   int out_bf16, int M, int N, int K, int block_b) {
  constexpr int TX = BN / RN, TY = BM / RM, NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half_n = N / 2;
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
    for (int i = tid; i < BK * (BN / 2); i += NT) {
      int kk = i / (BN / 2), j = i % (BN / 2);
      int k = k0 + kk, n = n0 + 2 * j;
      float lo = 0.f, hi = 0.f;
      if (k < K && n < N) {
        uint32_t byte = bp[size_t(k) * half_n + (n >> 1)];
        const uint8_t* srow = bs + size_t(k / block_b) * N;
        // column 2j is the LOW nibble of byte j
        lo = fp4::decode_e2m1(byte & 0xFu) * fp4::decode_e4m3(srow[n]);
        hi = fp4::decode_e2m1(byte >> 4) * fp4::decode_e4m3(srow[n + 1]);
      }
      Bs[kk][2 * j] = lo;
      Bs[kk][2 * j + 1] = hi;
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
  const float s = __fmul_rn(*tsa, *tsb);
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

extern "C" int fp4_packed_matmul(const void* a, int a_bf16,
                                 const uint8_t* b_packed,
                                 const uint8_t* b_scales, const float* tsb,
                                 const uint32_t* a_rbits, int M, int N, int K,
                                 int block_a, int block_b,
                                 const fp4::QuantParams* qa,
                                 unsigned int* amax_ws, float* tsa_ws,
                                 float* aq_ws, void* out, int out_bf16,
                                 cudaStream_t stream) {
  fp4::quantize_operand(a, a_bf16, a_rbits, size_t(M), size_t(K), block_a, 0,
                        *qa, amax_ws, tsa_ws, aq_ws, stream);
  if (M <= 8) {
    constexpr int BM = 8, BN = 16, BK = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    packed_gemm_kernel<BM, BN, BK, 1, 1><<<grid, (BM / 1) * (BN / 1), 0,
                                            stream>>>(
        aq_ws, b_packed, b_scales, tsa_ws, tsb, out, out_bf16, M, N, K,
        block_b);
  } else {
    constexpr int BM = 64, BN = 64, BK = 32;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    packed_gemm_kernel<BM, BN, BK, 4, 4><<<grid, (BM / 4) * (BN / 4), 0,
                                            stream>>>(
        aq_ws, b_packed, b_scales, tsa_ws, tsb, out, out_bf16, M, N, K,
        block_b);
  }
  return int(cudaGetLastError());
}
