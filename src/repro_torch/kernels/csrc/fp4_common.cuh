// Minifloat helpers shared by the port's CUDA kernels: the __device__
// versions of the K0 helpers in repro/kernels/common.py (plain PyTorch
// versions: repro_torch/kernels/common.py), and the block quantizer that
// K1, K2 and K4 share (absmax -> tensor scale -> block scales -> codes, in
// the TPU kernels' order of operations).
//
// Bit-exactness rules, held by chip_smoke.py against the plain versions:
//   * built without --use_fast_math: IEEE division (__fdiv_rn), no
//     flush-to-zero, so subnormal scales and codes survive;
//   * jnp.round is half-to-even -> rintf, never roundf;
//   * jnp.sign(0) is 0 and keeps -0.0 -> copysignf(q, x);
//   * every mul that feeds an add is spelled __fmul_rn/__fadd_rn where the
//     reference rounds twice, so nvcc cannot contract it into an FMA;
//   * float8_e4m3fn bytes are decoded arithmetically (no __half/__nv_fp8
//     operators), which also keeps the file free of the -D__CUDA_NO_HALF_*
//     pitfalls.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fp4 {

struct FmtParams {
  int man_bits;
  int emin;
  int emax;
  float max;
};

__device__ __forceinline__ float ulp_from_bits(float a, FmtParams p) {
  int e = int((__float_as_uint(a) >> 23) & 0xFF) - 127;  // floor(log2 a)
  e = min(max(e, p.emin), p.emax);
  return __uint_as_float(uint32_t(e - p.man_bits + 127) << 23);
}

__device__ __forceinline__ float quantize_rtn(float x, FmtParams p) {
  float a = fminf(fabsf(x), p.max);
  float ulp = ulp_from_bits(a, p);
  float q = __fmul_rn(rintf(__fdiv_rn(a, ulp)), ulp);
  return copysignf(fminf(q, p.max), x);
}

__device__ __forceinline__ float quantize_sr(float x, FmtParams p, float u) {
  float a = fminf(fabsf(x), p.max);
  float ulp = ulp_from_bits(a, p);
  float q = __fmul_rn(floorf(__fadd_rn(__fdiv_rn(a, ulp), u)), ulp);
  return copysignf(fminf(q, p.max), x);
}

__device__ __forceinline__ float uniform_from_bits(uint32_t rbits) {
  return float(rbits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// 4-bit E2M1 code (s eem) -> grid value
__device__ __forceinline__ float decode_e2m1(uint32_t nib) {
  uint32_t e = (nib >> 1) & 0x3u, m = nib & 0x1u;
  float mag = (e == 0) ? float(m) * 0.5f
                       : __uint_as_float(((e + 126u) << 23) | (m << 22));
  return (nib & 0x8u) ? -mag : mag;
}

// float8_e4m3fn bit pattern -> float (0x7F/0xFF are NaN)
__device__ __forceinline__ float decode_e4m3(uint32_t b) {
  uint32_t e = (b >> 3) & 0xFu, m = b & 0x7u;
  float mag;
  if ((b & 0x7Fu) == 0x7Fu) {
    mag = __uint_as_float(0x7FC00000u);
  } else if (e == 0) {
    mag = float(m) * 0.001953125f;  // 2^-9
  } else {
    mag = __uint_as_float(((e + 120u) << 23) | (m << 20));
  }
  return (b & 0x80u) ? -mag : mag;
}

// OCP MX rule: 2^(floor(log2 amax) - data_emax); 1 for amax == 0
__device__ __forceinline__ float e8m0_block_scale(float absmax,
                                                  int data_emax) {
  int e = int((__float_as_uint(absmax) >> 23) & 0xFF) - 127;
  e = min(max(e, -127), 127);
  float p2 = __uint_as_float(uint32_t(e + 127) << 23);
  float scale = __fdiv_rn(p2, float(1 << data_emax));
  return absmax > 0.f ? scale : 1.0f;
}

// RtN block scale: Q_rtn(amax / (data_max * tscale)); 1 where it is 0
__device__ __forceinline__ float generic_block_scale(float absmax,
                                                     float data_max,
                                                     FmtParams scale_p,
                                                     float tscale) {
  float raw = __fdiv_rn(absmax, __fmul_rn(data_max, tscale));
  float scale = quantize_rtn(raw, scale_p);
  return scale > 0.f ? scale : 1.0f;
}

// Power-of-two tensor scale 2^k with amax/denom = m * 2^k, m in [.5, 1),
// denom = data max * scale max (6 * 448 = 2688 for NVFP4)
// (repro/core/quantize.py:_tensor_scale); 1 for amax == 0.
__device__ __forceinline__ float tensor_scale_pow2(float amax, float denom) {
  if (!(amax > 0.f)) return 1.0f;
  int k;
  frexpf(__fdiv_rn(amax, denom), &k);
  return ldexpf(1.0f, k);
}

// Element i of a bf16 or f32 array, as float.
__device__ __forceinline__ float load_f(const void* a, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i])
              : static_cast<const float*>(a)[i];
}

// max |a| over n elements into *out (float bits; 0 before the launch):
// grid-stride loop, warp shuffles, one atomicMax per block.
__global__ void absmax_kernel(const void* __restrict__ a, int a_bf16,
                              size_t n, unsigned int* __restrict__ out) {
  float m = 0.f;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    m = fmaxf(m, fabsf(load_f(a, i, a_bf16)));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    int nw = blockDim.x >> 5;
    m = lane < nw ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // non-negative floats order like their bit patterns
    if (lane == 0) atomicMax(out, __float_as_uint(m));
  }
}

// Launch absmax_kernel over n elements on stream (out zeroed first).
inline void launch_absmax(const void* a, int a_bf16, size_t n,
                          unsigned int* out, cudaStream_t stream) {
  cudaMemsetAsync(out, 0, sizeof(unsigned int), stream);
  size_t want = (n + 1023) / 1024;
  int blocks = want < 1024 ? (want > 0 ? int(want) : 1) : 1024;
  absmax_kernel<<<blocks, 256, 0, stream>>>(a, a_bf16, n, out);
}

// One operand's BlockQuantSpec as runtime constants (the data and scale
// formats and the tensor-scale rule), so a kernel takes every spec.
struct QuantParams {
  int data_man_bits, data_emin, data_emax;
  float data_max;
  int scale_man_bits, scale_emin, scale_emax;
  float scale_max;
  int e8m0;        // E8M0 block scales (else RtN onto the scale format)
  int two_level;   // power-of-two tensor scale (else 1)
  float ts_denom;  // data_max * scale_max
};

// Quantize one block of `block` values x[base + i * stride] (RtN, or SR
// from rbits at the same indices) in the TPU kernels' order of operations:
// absmax, the block scale (E8M0, or RtN onto the scale format of
// amax / (data_max * ts)), codes = Q(x / (scale * ts)).  Calls
// store(j, code, scale) for each value and returns the block scale.
template <class Store>
__device__ __forceinline__ float quant_block(
    const void* __restrict__ x, int x_bf16, const uint32_t* __restrict__ rbits,
    size_t base, size_t stride, int block, const QuantParams& qp, float ts,
    Store store) {
  float absmax = 0.f;
  for (int i = 0; i < block; ++i)
    absmax = fmaxf(absmax, fabsf(load_f(x, base + i * stride, x_bf16)));
  const FmtParams dp{qp.data_man_bits, qp.data_emin, qp.data_emax,
                     qp.data_max};
  const FmtParams sp{qp.scale_man_bits, qp.scale_emin, qp.scale_emax,
                     qp.scale_max};
  float scale = qp.e8m0 ? e8m0_block_scale(absmax, dp.emax)
                        : generic_block_scale(absmax, dp.max, sp, ts);
  float denom = __fmul_rn(scale, ts);
  for (int i = 0; i < block; ++i) {
    size_t j = base + i * stride;
    float scaled = __fdiv_rn(load_f(x, j, x_bf16), denom);
    float code = rbits ? quantize_sr(scaled, dp, uniform_from_bits(rbits[j]))
                       : quantize_rtn(scaled, dp);
    store(j, code, scale);
  }
  return scale;
}

// One thread per block of `block` values.  along_rows = 0: x is (R, C)
// blocked along C (A); along_rows = 1: blocked along R (B), so
// neighbouring threads read neighbouring addresses.  Writes code * scale
// (exact in f32) to xq.
__global__ void quant_blocks_kernel(const void* __restrict__ x, int x_bf16,
                                    const uint32_t* __restrict__ rbits,
                                    size_t n_blocks, int block, int cols,
                                    int along_rows, QuantParams qp,
                                    const unsigned int* __restrict__ amax_bits,
                                    float* __restrict__ ts_out,
                                    float* __restrict__ xq) {
  size_t idx = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
  if (idx >= n_blocks) return;
  float ts = qp.two_level
                 ? tensor_scale_pow2(__uint_as_float(*amax_bits), qp.ts_denom)
                 : 1.0f;
  if (idx == 0) *ts_out = ts;
  size_t base = idx * block, stride = 1;
  if (along_rows) {
    base = (idx / cols) * block * size_t(cols) + idx % cols;
    stride = cols;
  }
  quant_block(x, x_bf16, rbits, base, stride, block, qp, ts,
              [xq](size_t j, float code, float scale) {
                xq[j] = __fmul_rn(code, scale);
              });
}

// Quantize a (rows, cols) operand in blocks of `block` along its columns
// (along_rows = 0) or rows (1) on `stream`: the tensor scale from an
// absmax launch (two-level specs; it stays on the device in *ts_ws), then
// quant_blocks_kernel writing code * scale (exact in f32) to xq.
inline void quantize_operand(const void* x, int x_bf16, const uint32_t* rbits,
                             size_t rows, size_t cols, int block,
                             int along_rows, const QuantParams& qp,
                             unsigned int* amax_ws, float* ts_ws, float* xq,
                             cudaStream_t stream) {
  if (qp.two_level) launch_absmax(x, x_bf16, rows * cols, amax_ws, stream);
  size_t n_blocks = rows * cols / block;
  quant_blocks_kernel<<<unsigned((n_blocks + 255) / 256), 256, 0, stream>>>(
      x, x_bf16, rbits, n_blocks, block, int(cols), along_rows, qp, amax_ws,
      ts_ws, xq);
}

}  // namespace fp4
