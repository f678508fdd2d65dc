// Minifloat helpers shared by the port's CUDA kernels: the __device__
// versions of the K0 helpers in repro/kernels/common.py (plain PyTorch
// versions: repro_torch/kernels/common.py), the block quantizer that K1,
// K2 and K4 share (absmax -> tensor scale -> block scales -> codes, in the
// TPU kernels' order of operations), with its SR bits read from a tensor
// or hashed in the kernel from a seed (counter_hash, K1), and the cp.async
// copies K4's GEMV and K5 stream their tiles with.
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
#include <cstring>
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

// Asynchronous copies global -> shared (cp.async, sm_80+): 16 or 4 bytes,
// both addresses aligned to the size; complete for the issuing thread at
// cp_async_wait<N>() (all but the N most recent committed groups), and for
// the block after a __syncthreads() that follows it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// The splitmix32 hash of (seed, index) of repro/core/formats.py:
// counter_bits (the SR stream of the training GEMMs), in uint32 arithmetic.
__device__ __forceinline__ uint32_t counter_hash(uint32_t seed, uint32_t idx) {
  uint32_t z = idx * 0x9E3779B9u + seed;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  z ^= z >> 16;
  z += 0x9E3779B9u;
  z = (z ^ (z >> 15)) * 0x2C1B3C6Du;
  z = (z ^ (z >> 12)) * 0x297A2D39u;
  return z ^ (z >> 15);
}

// Where an operand's SR bits come from: a uint32 tensor of the operand's
// shape (rbits), or, in counter mode, counter_hash(seed, r * row_stride +
// c * col_stride) for element (r, c), in uint32 arithmetic.  Neither: RtN.
struct SrBits {
  const uint32_t* rbits;
  uint32_t seed, row_stride, col_stride;
  int counter;
};

// The SR bits of one block's values i = 0 .. block-1: rbits[base + i *
// stride], or counter_hash(seed, idx0 + i * step); sr() false for RtN.
struct BlockBits {
  const uint32_t* rbits;
  size_t base, stride;
  uint32_t seed, idx0, step;
  int counter;
  __device__ __forceinline__ bool sr() const { return counter || rbits; }
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return counter ? counter_hash(seed, idx0 + uint32_t(i) * step)
                   : rbits[base + i * stride];
  }
};

// f(i) for i = 0 .. n-1: unrolled where N, the count known at compile
// time, is given (N > 0), a plain loop over the runtime n otherwise.
template <int N, class F>
__device__ __forceinline__ void each_index(int n, F f) {
  if constexpr (N > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) f(i);
  } else {
    for (int i = 0; i < n; ++i) f(i);
  }
}

// Quantize one block of `block` values x[base + i * stride] (RtN, or SR
// from bits(i)) in the TPU kernels' order of operations: absmax, the block
// scale (E8M0, or RtN onto the scale format of amax / (data_max * ts)),
// codes = Q(x / (scale * ts)).  Calls store(i, code, scale) for each value
// and returns the block scale.  BLK > 0 names the block size at compile
// time (== block), so the loops unroll and store may fill a register array.
template <int BLK = 0, class Bits, class Store>
__device__ __forceinline__ float quant_block_bits(
    const void* __restrict__ x, int x_bf16, const Bits& bits, size_t base,
    size_t stride, int block, const QuantParams& qp, float ts, Store store) {
  float absmax = 0.f;
  each_index<BLK>(block, [&](int i) {
    absmax = fmaxf(absmax, fabsf(load_f(x, base + i * stride, x_bf16)));
  });
  const FmtParams dp{qp.data_man_bits, qp.data_emin, qp.data_emax,
                     qp.data_max};
  const FmtParams sp{qp.scale_man_bits, qp.scale_emin, qp.scale_emax,
                     qp.scale_max};
  float scale = qp.e8m0 ? e8m0_block_scale(absmax, dp.emax)
                        : generic_block_scale(absmax, dp.max, sp, ts);
  float denom = __fmul_rn(scale, ts);
  const bool sr = bits.sr();
  each_index<BLK>(block, [&](int i) {
    float scaled = __fdiv_rn(load_f(x, base + i * stride, x_bf16), denom);
    float code = sr ? quantize_sr(scaled, dp, uniform_from_bits(bits(i)))
                    : quantize_rtn(scaled, dp);
    store(i, code, scale);
  });
  return scale;
}

// quant_block_bits with SR bits rbits[j] (null: RtN) at the values' own
// indices j = base + i * stride, calling store(j, code, scale).
template <class Store>
__device__ __forceinline__ float quant_block(
    const void* __restrict__ x, int x_bf16, const uint32_t* __restrict__ rbits,
    size_t base, size_t stride, int block, const QuantParams& qp, float ts,
    Store store) {
  const BlockBits bits{rbits, base, stride, 0u, 0u, 0u, 0};
  return quant_block_bits(x, x_bf16, bits, base, stride, block, qp, ts,
                          [&](int i, float code, float scale) {
                            store(base + i * stride, code, scale);
                          });
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
// amax_given: *amax_ws already holds the |x| max to take (the f32 bits of a
// caller's value, e.g. a row-parallel GEMM's global max), so no absmax pass.
inline void quantize_operand(const void* x, int x_bf16, const uint32_t* rbits,
                             size_t rows, size_t cols, int block,
                             int along_rows, const QuantParams& qp,
                             unsigned int* amax_ws, float* ts_ws, float* xq,
                             cudaStream_t stream, bool amax_given = false) {
  if (qp.two_level && !amax_given)
    launch_absmax(x, x_bf16, rows * cols, amax_ws, stream);
  size_t n_blocks = rows * cols / block;
  quant_blocks_kernel<<<unsigned((n_blocks + 255) / 256), 256, 0, stream>>>(
      x, x_bf16, rbits, n_blocks, block, int(cols), along_rows, qp, amax_ws,
      ts_ws, xq);
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// q[0 .. BLK-1] to p in 16-byte stores (p 16-byte aligned).
template <int BLK>
__device__ __forceinline__ void store_block(float* p, const float (&q)[BLK]) {
#pragma unroll
  for (int j = 0; j < BLK; j += 4)
    *reinterpret_cast<float4*>(p + j) =
        make_float4(q[j], q[j + 1], q[j + 2], q[j + 3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}
template <int BLK>
__device__ __forceinline__ void store_block(__nv_bfloat16* p,
                                            const float (&q)[BLK]) {
#pragma unroll
  for (int j = 0; j < BLK; j += 8)
    *reinterpret_cast<uint4*>(p + j) = make_uint4(
        pack_bf16x2(q[j], q[j + 1]), pack_bf16x2(q[j + 2], q[j + 3]),
        pack_bf16x2(q[j + 4], q[j + 5]), pack_bf16x2(q[j + 6], q[j + 7]));
}

// One thread per block of `block` values of a (rows, cols) operand blocked
// along its columns (along_rows = 0, A) or its rows (1, B), SR bits from
// `sr`, writing code * scale as T: in place, or for B with transpose = 1
// as the (cols, rows) transpose, so that each block lands contiguous.
// code * scale is exact in f32, and in bf16 when the data and scale
// formats' mantissa bits sum to <= 6.  BLK > 0 (== block, a contiguous
// destination block, 16-byte aligned): the block's values are gathered in
// registers and written in 16-byte stores, not one scalar store each.
template <typename T, int BLK>
__global__ void quant_operand_kernel(const void* __restrict__ x, int x_bf16,
                                     SrBits sr, size_t n_blocks, int block,
                                     int rows, int cols, int along_rows,
                                     int transpose, QuantParams qp,
                                     const unsigned int* __restrict__ amax_bits,
                                     float* __restrict__ ts_out,
                                     T* __restrict__ dst) {
  size_t idx = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
  if (idx >= n_blocks) return;
  float ts = qp.two_level
                 ? tensor_scale_pow2(__uint_as_float(*amax_bits), qp.ts_denom)
                 : 1.0f;
  if (idx == 0) *ts_out = ts;
  size_t r0, c0, stride;
  if (along_rows) {
    r0 = (idx / cols) * block;
    c0 = idx % cols;
    stride = cols;
  } else {
    r0 = idx / (cols / block);
    c0 = (idx % (cols / block)) * block;
    stride = 1;
  }
  const size_t base = r0 * cols + c0;
  const BlockBits bits{
      sr.rbits, base, stride, sr.seed,
      uint32_t(r0) * sr.row_stride + uint32_t(c0) * sr.col_stride,
      along_rows ? sr.row_stride : sr.col_stride, sr.counter};
  const size_t d0 = transpose ? c0 * rows + r0 : base;
  if constexpr (BLK > 0) {
    float q[BLK];
    quant_block_bits<BLK>(x, x_bf16, bits, base, stride, block, qp, ts,
                          [&](int i, float code, float scale) {
                            q[i] = __fmul_rn(code, scale);
                          });
    store_block(dst + d0, q);
  } else {
    const size_t dstep = transpose ? 1 : stride;
    quant_block_bits(x, x_bf16, bits, base, stride, block, qp, ts,
                     [&](int i, float code, float scale) {
                       store_as(dst + d0 + i * dstep, __fmul_rn(code, scale));
                     });
  }
}

// Quantize a (rows, cols) operand with quant_operand_kernel on `stream`,
// after an absmax launch for a two-level spec's tensor scale (it stays on
// the device in *ts_ws).  A contiguous destination block of 16 or 32
// values (A in place, or B transposed) takes the vector-store kernel; dst
// is 16-byte aligned and, transposed, rows * sizeof(T) % 16 == 0.
// amax_given as in quantize_operand.
template <typename T>
inline void quantize_operand_to(const void* x, int x_bf16, const SrBits& sr,
                                size_t rows, size_t cols, int block,
                                int along_rows, int transpose,
                                const QuantParams& qp, unsigned int* amax_ws,
                                float* ts_ws, T* dst, cudaStream_t stream,
                                bool amax_given = false) {
  if (qp.two_level && !amax_given)
    launch_absmax(x, x_bf16, rows * cols, amax_ws, stream);
  size_t n_blocks = rows * cols / block;
  const bool contiguous = !along_rows || transpose;
  auto kernel = contiguous && block == 16   ? quant_operand_kernel<T, 16>
                : contiguous && block == 32 ? quant_operand_kernel<T, 32>
                                            : quant_operand_kernel<T, 0>;
  kernel<<<unsigned((n_blocks + 255) / 256), 256, 0, stream>>>(
      x, x_bf16, sr, n_blocks, block, int(rows), int(cols), along_rows,
      transpose, qp, amax_ws, ts_ws, dst);
}

}  // namespace fp4
