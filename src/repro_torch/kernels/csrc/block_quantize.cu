// K2: block_quantize for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/nvfp4_quant.py::block_quantize_pallas
// (_quant_kernel, pl.pallas_call at nvfp4_quant.py:101): a (M, K) tensor,
// bf16 or f32, is quantized along its last axis in blocks of `block`
// values -- per block the absmax, a block scale (E4M3/E3M4 RtN of
// amax / (data_max * ts), or E8M0), and E2M1 codes (RtN, or SR) -- and
// written as codes in x's dtype (grid values, exact in bf16) and f32 block
// scales (M, K/block).  The tensor scale ts is the caller's (a device
// scalar), or 2^ceil(log2(amax / (data_max * scale_max))) for a two-level
// spec, or 1.  SR bits come from a uint32 tensor of x's shape or, in
// counter mode, from counter_hash(seed, r * row_stride + c * col_stride),
// the stream K1 hashes (fp4::SrBits), so no bits tensor is drawn at all.
//
// What bounds it on an H100: bytes.  At (4096, 4096) f32 it reads x once
// (67.1 MB) and writes the codes (67.1 MB) and scales (4.2 MB): 0.0413 ms
// at 3.35 TB/s (bf16: 0.0213 ms); a computed tensor scale reads x once
// more.  The arithmetic is a few dozen operations a value (an IEEE
// division, the rounding, in counter mode the hash), below the byte time.
//
// What the design does about it ("vec", block_quantize_vec_kernel):
//   * every lane owns 16 contiguous bytes -- 4 f32 or 8 bf16 values --
//     loaded with one read-only 16-byte load and stored, as codes, with one
//     streaming 16-byte store, so a warp moves 512 contiguous bytes per
//     instruction;
//   * a quantization block spans g = block * elt / 16 lanes (f32 blocks
//     8 / 16 / 32: 2 / 4 / 8 lanes; bf16: 1 / 2 / 4); its absmax is
//     reduced with __shfl_xor_sync inside the group, every lane computes
//     the same block scale by the same arithmetic, and the group's first
//     lane stores it;
//   * the tensor is walked as one flat array (rows are contiguous and
//     K % block == 0, so no block straddles a row) by a grid-stride loop
//     over enough 256-thread blocks to fill the SMs;
//   * a computed tensor scale comes from K2's own vectorized absmax
//     pre-pass (16-byte loads, shuffles, one atomicMax a block) into a
//     device word that this call zeroes first; it never reaches the host;
//   * codes follow fp4::quant_block_bits' order of operations
//     (__fdiv_rn(x, __fmul_rn(scale, ts)), rintf / copysignf, or SR), so
//     the bits equal K1's and K4's quantizers and the plain version; the
//     division by the format's ulp, a power of two, is an exact multiply
//     by its reciprocal (same bits, one IEEE division a value fewer);
//   * each trip of a thread's loop loads its next lane before computing
//     the current one, so the arithmetic overlaps a load in flight.
// The host picks "vec" (nvfp4_quant.k2_route) where g is a power of two up
// to 32 and x, the codes and the bits are 16-byte aligned; anything else
// takes "scalar" (block_quantize_scalar_kernel, one thread per block
// through fp4::quant_block_bits, neighbouring threads a block apart).
// Both launch on the caller's stream, allocate nothing and never sync.
#include "fp4_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLaneBytes = 16;

// SR source of a launch, fixed at compile time: none (RtN), a uint32
// tensor of x's shape, or counter_hash.
enum BitsMode { kRtn = 0, kTensor = 1, kCounter = 2 };

// One lane's 16 bytes of T as floats, and E floats back as T.
template <typename T>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p,
                                               const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Lane<__nv_bfloat16> {
  static constexpr int E = 8;
  // a 32-bit word holds element 2j in its low half, 2j + 1 in its high one
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(fp4::pack_bf16x2(v[0], v[1]),
                      fp4::pack_bf16x2(v[2], v[3]),
                      fp4::pack_bf16x2(v[4], v[5]),
                      fp4::pack_bf16x2(v[6], v[7])));
  }
};

// The SR bits of the E values at flat indices f0 .. f0 + E - 1 (one row).
template <int MODE, int E>
__device__ __forceinline__ void lane_bits(const fp4::SrBits& sr, size_t f0,
                                          int K, uint32_t (&b)[E]) {
  if constexpr (MODE == kTensor) {
    const uint4* p = reinterpret_cast<const uint4*>(sr.rbits + f0);
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const uint4 q = __ldg(p + k);
      b[4 * k] = q.x;
      b[4 * k + 1] = q.y;
      b[4 * k + 2] = q.z;
      b[4 * k + 3] = q.w;
    }
  } else if constexpr (MODE == kCounter) {
    // hash index r * row_stride + c * col_stride, wrapping mod 2^32
    const size_t r = (f0 >> 32) ? f0 / size_t(K)
                                : size_t(uint32_t(f0) / uint32_t(K));
    const uint32_t c0 = uint32_t(f0 - r * size_t(K));
    const uint32_t idx = uint32_t(r) * sr.row_stride + c0 * sr.col_stride;
#pragma unroll
    for (int j = 0; j < E; ++j)
      b[j] = fp4::counter_hash(sr.seed, idx + uint32_t(j) * sr.col_stride);
  }
}

// Q(x) onto a data format as fp4::quantize_rtn / quantize_sr compute it
// (named apart from them: fp4::FmtParams brings those into overload sets),
// with a / ulp taken as a * 2^-E for ulp = 2^E: both are the correctly
// rounded value of the same real number, so the bits are the same, and a
// multiply takes the place of an IEEE division per value.
__device__ __forceinline__ float inv_ulp_from_bits(float a, fp4::FmtParams p) {
  int e = int((__float_as_uint(a) >> 23) & 0xFF) - 127;
  e = min(max(e, p.emin), p.emax);
  return __uint_as_float(uint32_t(p.man_bits - e + 127) << 23);
}

__device__ __forceinline__ float code_rtn(float x, fp4::FmtParams p) {
  const float a = fminf(fabsf(x), p.max);
  const float q = __fmul_rn(rintf(__fmul_rn(a, inv_ulp_from_bits(a, p))),
                            fp4::ulp_from_bits(a, p));
  return copysignf(fminf(q, p.max), x);
}

__device__ __forceinline__ float code_sr(float x, fp4::FmtParams p, float u) {
  const float a = fminf(fabsf(x), p.max);
  const float q = __fmul_rn(
      floorf(__fadd_rn(__fmul_rn(a, inv_ulp_from_bits(a, p)), u)),
      fp4::ulp_from_bits(a, p));
  return copysignf(fminf(q, p.max), x);
}

__device__ __forceinline__ float launch_tscale(
    const fp4::QuantParams& qp, const float* __restrict__ ts_given,
    const unsigned int* __restrict__ amax) {
  return ts_given ? *ts_given
         : qp.two_level
             ? fp4::tensor_scale_pow2(__uint_as_float(*amax), qp.ts_denom)
             : 1.0f;
}

// max |x| over n_lanes 16-byte lanes into *out (float bits, zeroed before
// the launch): four independent loads in flight a thread, warp shuffles,
// one atomicMax a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_vec_kernel(const T* __restrict__ x, size_t n_lanes,
                      unsigned int* __restrict__ out) {
  using L = Lane<T>;
  constexpr int E = L::E;
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
  float m = 0.f;
  for (; i + 3 * stride < n_lanes; i += 4 * stride) {
    float v[4][E];
#pragma unroll
    for (int u = 0; u < 4; ++u) L::load(x + (i + u * stride) * E, v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < E; ++j) m = fmaxf(m, fabsf(v[u][j]));
  }
  for (; i < n_lanes; i += stride) {
    float v[E];
    L::load(x + i * E, v);
#pragma unroll
    for (int j = 0; j < E; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    // non-negative floats order like their bit patterns
    if (lane == 0) atomicMax(out, __float_as_uint(m));
  }
}

// Lane i's 16 bytes of x, or zeros for a lane past the end.
template <typename T>
__device__ __forceinline__ void load_lane(const T* __restrict__ x, size_t i,
                                          size_t n_lanes,
                                          float (&v)[Lane<T>::E]) {
  if (i < n_lanes) {
    Lane<T>::load(x + i * Lane<T>::E, v);
  } else {
#pragma unroll
    for (int j = 0; j < Lane<T>::E; ++j) v[j] = 0.f;
  }
}

// The "vec" quantizer: lane i owns x[i * E .. i * E + E - 1] of the flat
// tensor; a block is the 2^lg_g lanes of an aligned group.  The loop runs
// per warp (every lane of a warp takes the same trips), so the shuffles
// always see the whole warp; lanes past the end carry zeros and store
// nothing.  Groups never straddle a warp (2^lg_g divides 32) nor the end
// (n_lanes is a multiple of 2^lg_g).  Each trip loads the next trip's lane
// before its own arithmetic, so a load is in flight meanwhile.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) block_quantize_vec_kernel(
    const T* __restrict__ x, fp4::SrBits sr, size_t n_lanes, int K,
    int lg_g, fp4::QuantParams qp, const float* __restrict__ ts_given,
    const unsigned int* __restrict__ amax, T* __restrict__ codes,
    float* __restrict__ scales) {
  constexpr int E = Lane<T>::E;
  const float ts = launch_tscale(qp, ts_given, amax);
  const fp4::FmtParams dp{qp.data_man_bits, qp.data_emin, qp.data_emax,
                          qp.data_max};
  const fp4::FmtParams sp{qp.scale_man_bits, qp.scale_emin, qp.scale_emax,
                          qp.scale_max};
  const int lane = threadIdx.x & 31;
  const int g = 1 << lg_g;
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  size_t base = blockIdx.x * size_t(blockDim.x) + threadIdx.x - lane;
  float v[E];
  load_lane(x, base + lane, n_lanes, v);
  for (; base < n_lanes; base += stride) {
    const size_t i = base + lane;
    float next[E];
    load_lane(x, i + stride, n_lanes, next);
    float absmax = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) absmax = fmaxf(absmax, fabsf(v[j]));
    for (int off = 1; off < g; off <<= 1)
      absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
    if (i < n_lanes) {
      const float scale =
          qp.e8m0 ? fp4::e8m0_block_scale(absmax, dp.emax)
                  : fp4::generic_block_scale(absmax, dp.max, sp, ts);
      const float denom = __fmul_rn(scale, ts);
      const size_t f0 = i * E;
      uint32_t bits[E] = {};
      lane_bits<MODE, E>(sr, f0, K, bits);
      float q[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float scaled = __fdiv_rn(v[j], denom);
        if constexpr (MODE == kRtn)
          q[j] = code_rtn(scaled, dp);
        else
          q[j] = code_sr(scaled, dp, fp4::uniform_from_bits(bits[j]));
      }
      Lane<T>::store(codes + f0, q);
      if ((lane & (g - 1)) == 0) __stcs(scales + (i >> lg_g), scale);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = next[j];
  }
}

// The "scalar" quantizer: one thread per block of x (n_blocks * block
// values, row-major, rows of K), codes in x's dtype at the same indices,
// one f32 scale per block.
__global__ void block_quantize_scalar_kernel(
    const void* __restrict__ x, int x_bf16, fp4::SrBits sr, size_t n_blocks,
    int block, int K, fp4::QuantParams qp, const float* __restrict__ ts_given,
    const unsigned int* __restrict__ amax, void* __restrict__ codes,
    float* __restrict__ scales) {
  size_t idx = blockIdx.x * size_t(blockDim.x) + threadIdx.x;
  if (idx >= n_blocks) return;
  const float ts = launch_tscale(qp, ts_given, amax);
  const size_t base = idx * block;
  const size_t r = sr.counter ? base / size_t(K) : 0;
  const uint32_t c0 = uint32_t(base - r * size_t(K));
  const fp4::BlockBits bits{
      sr.rbits, base, 1, sr.seed,
      uint32_t(r) * sr.row_stride + c0 * sr.col_stride, sr.col_stride,
      sr.counter};
  scales[idx] = fp4::quant_block_bits(
      x, x_bf16, bits, base, 1, block, qp, ts,
      [codes, x_bf16, base](int i, float code, float) {
        if (x_bf16)
          static_cast<__nv_bfloat16*>(codes)[base + i] =
              __float2bfloat16_rn(code);
        else
          static_cast<float*>(codes)[base + i] = code;
      });
}

// Blocks of kThreads for a grid-stride launch over `work` threads' worth:
// as many as fit on the card at once, fewer where the work is smaller.
template <class Kernel>
unsigned grid_for(Kernel kernel, size_t work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const size_t full = size_t(sms) * size_t(per_sm > 0 ? per_sm : 1);
  const size_t want = (work + kThreads - 1) / kThreads;
  return unsigned(want < full ? want : full);
}

template <typename T>
void launch_vec(const void* x, const fp4::SrBits& sr, size_t n, int K,
                int block, const fp4::QuantParams& qp, const float* ts_given,
                unsigned int* amax_ws, void* codes, float* scales,
                cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const size_t n_lanes = n * sizeof(T) / kLaneBytes;
  if (!ts_given && qp.two_level) {
    cudaMemsetAsync(amax_ws, 0, sizeof(unsigned int), stream);
    absmax_vec_kernel<T><<<grid_for(absmax_vec_kernel<T>, n_lanes), kThreads,
                           0, stream>>>(xt, n_lanes, amax_ws);
  }
  int lg_g = 0;
  while ((Lane<T>::E << lg_g) < block) ++lg_g;
  auto kernel = sr.counter ? block_quantize_vec_kernel<T, kCounter>
                : sr.rbits ? block_quantize_vec_kernel<T, kTensor>
                           : block_quantize_vec_kernel<T, kRtn>;
  kernel<<<grid_for(kernel, n_lanes), kThreads, 0, stream>>>(
      xt, sr, n_lanes, K, lg_g, qp, ts_given, amax_ws, static_cast<T*>(codes),
      scales);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kLaneBytes == 0;
}

}  // namespace

// sr: the SR source (RtN: rbits null and counter 0; a uint32 tensor of
// M*K; or counter mode).  ts_given: the caller's f32 tensor scale on the
// device, or null to compute it (two-level specs: an absmax pre-pass into
// amax_ws, 1 uint32; else 1).  codes: M*K in x's dtype; scales:
// M*(K/block) f32.  vec: the route nvfp4_quant.k2_route picked (1 "vec",
// 0 "scalar"); a "vec" call that breaks the route's rules is refused with
// cudaErrorInvalidValue before any launch.
extern "C" int fp4_block_quantize(const void* x, int x_bf16,
                                  const fp4::SrBits* sr, int M, int K,
                                  int block, const fp4::QuantParams* qp,
                                  const float* ts_given,
                                  unsigned int* amax_ws, void* codes,
                                  float* scales, int vec,
                                  cudaStream_t stream) {
  const size_t n = size_t(M) * K;
  if (n == 0) return int(cudaSuccess);
  if (vec) {
    const int bytes = block * (x_bf16 ? 2 : 4);
    const int g = bytes / kLaneBytes;
    if (bytes % kLaneBytes || g < 1 || g > 32 || (g & (g - 1)) ||
        !aligned16(x) || !aligned16(codes) ||
        (sr->rbits && !aligned16(sr->rbits)))
      return int(cudaErrorInvalidValue);
    if (x_bf16)
      launch_vec<__nv_bfloat16>(x, *sr, n, K, block, *qp, ts_given, amax_ws,
                                codes, scales, stream);
    else
      launch_vec<float>(x, *sr, n, K, block, *qp, ts_given, amax_ws, codes,
                        scales, stream);
    return int(cudaGetLastError());
  }
  if (!ts_given && qp->two_level)
    fp4::launch_absmax(x, x_bf16, n, amax_ws, stream);
  const size_t n_blocks = n / block;
  block_quantize_scalar_kernel<<<unsigned((n_blocks + kThreads - 1) /
                                          kThreads),
                                 kThreads, 0, stream>>>(
      x, x_bf16, *sr, n_blocks, block, K, *qp, ts_given, amax_ws, codes,
      scales);
  return int(cudaGetLastError());
}
