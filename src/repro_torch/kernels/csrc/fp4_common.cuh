// Minifloat helpers shared by the port's CUDA kernels: the __device__
// versions of the K0 helpers in repro/kernels/common.py (plain PyTorch
// versions: repro_torch/kernels/common.py).
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

// E2M1: data format of NVFP4/MXFP4.  E4M3: the NVFP4 block scale.
__device__ __forceinline__ FmtParams e2m1_params() {
  return FmtParams{1, 0, 2, 6.0f};
}
__device__ __forceinline__ FmtParams e4m3_params() {
  return FmtParams{3, -6, 8, 448.0f};
}

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

// Power-of-two tensor scale 2^k with amax/(6*448) = m * 2^k, m in [.5, 1)
// (repro/core/quantize.py:_tensor_scale); 1 for amax == 0.
__device__ __forceinline__ float tensor_scale_from_amax(float amax) {
  if (!(amax > 0.f)) return 1.0f;
  int k;
  frexpf(__fdiv_rn(amax, 2688.0f), &k);
  return ldexpf(1.0f, k);
}

}  // namespace fp4
