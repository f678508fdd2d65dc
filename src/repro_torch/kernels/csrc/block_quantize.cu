// K2: block_quantize for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/nvfp4_quant.py::block_quantize_pallas
// (_quant_kernel, pl.pallas_call at nvfp4_quant.py:101): a (M, K) tensor,
// bf16 or f32, is quantized along its last axis in blocks of `block`
// values -- per block the absmax, a block scale (E4M3/E3M4 RtN of
// amax / (data_max * ts), or E8M0), and E2M1 codes (RtN, or SR from given
// uint32 bits) -- and written as codes in x's dtype (grid values, exact in
// bf16) and f32 block scales (M, K/block).  The tensor scale ts is the
// caller's (a device scalar), or 2^ceil(log2(amax / (data_max *
// scale_max))) for a two-level spec, or 1.
//
// What bounds it on an H100: bytes.  At (4096, 4096) f32 it reads x once
// (67.1 MB) and writes the codes (67.1 MB) and scales (4.2 MB): 0.041 ms at
// 3.35 TB/s (bf16: 0.021 ms); the arithmetic is a few dozen operations a
// value, far below the card's rate.
//
// What the design does about it, kept simple and right first:
//   * the tensor scale never reaches the host: a computed one comes from
//     fp4::launch_absmax (atomicMax on the float bits) into a device word
//     that the quantizer reads;
//   * one thread per block reads its `block` contiguous values (64 bytes in
//     f32) and runs fp4::quant_block, the body K1 and K4 quantize their
//     operands with, so the three kernels compute the same bits;
//   * neighbouring threads are 64 bytes apart, so a warp's loads are not
//     coalesced into full lines per instruction; a warp per row with
//     16-byte vector loads is the next step.
#include "fp4_common.cuh"

namespace {

// One thread per block: row-major x (n_blocks * block values), codes in
// x's dtype at the same indices, one f32 scale per block.
__global__ void block_quantize_kernel(const void* __restrict__ x, int x_bf16,
                                      const uint32_t* __restrict__ rbits,
                                      size_t n_blocks, int block,
                                      fp4::QuantParams qp,
                                      const float* __restrict__ ts_given,
                                      const unsigned int* __restrict__ amax,
                                      void* __restrict__ codes,
                                      float* __restrict__ scales) {
  size_t idx = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
  if (idx >= n_blocks) return;
  float ts = ts_given ? *ts_given
             : qp.two_level
                 ? fp4::tensor_scale_pow2(__uint_as_float(*amax), qp.ts_denom)
                 : 1.0f;
  scales[idx] = fp4::quant_block(
      x, x_bf16, rbits, idx * block, 1, block, qp, ts,
      [codes, x_bf16](size_t j, float code, float) {
        if (x_bf16)
          static_cast<__nv_bfloat16*>(codes)[j] = __float2bfloat16_rn(code);
        else
          static_cast<float*>(codes)[j] = code;
      });
}

}  // namespace

// ts_given: the caller's f32 tensor scale on the device, or null to compute
// it (two-level specs: an absmax launch into amax_ws, 1 uint32; else 1).
// rbits: M*K uint32 for SR, else null.  codes: M*K in x's dtype; scales:
// M*(K/block) f32.
extern "C" int fp4_block_quantize(const void* x, int x_bf16,
                                  const uint32_t* rbits, int M, int K,
                                  int block, const fp4::QuantParams* qp,
                                  const float* ts_given,
                                  unsigned int* amax_ws, void* codes,
                                  float* scales, cudaStream_t stream) {
  size_t n = size_t(M) * K;
  if (!ts_given && qp->two_level)
    fp4::launch_absmax(x, x_bf16, n, amax_ws, stream);
  size_t n_blocks = n / block;
  block_quantize_kernel<<<unsigned((n_blocks + 255) / 256), 256, 0,
                          stream>>>(x, x_bf16, rbits, n_blocks, block, *qp,
                                    ts_given, amax_ws, codes, scales);
  return int(cudaGetLastError());
}
