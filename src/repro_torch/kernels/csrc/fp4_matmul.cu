// K4: packed_block_matmul for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel repro/kernels/fp4_matmul.py::packed_block_matmul
// (_packed_kernel, pl.pallas_call at fp4_matmul.py:309), every serving GEMM:
// A (M, K) bf16/f32 is quantized on the fly (NVFP4 RtN on the serving path;
// SR from given uint32 bits and E8M0 block scales are also taken), B
// arrives as (K, N/2) uint8 E2M1 nibble pairs (column 2j in the low nibble
// of byte j) + (K/block_b, N) float8_e4m3fn block scales + an f32 tensor
// scale, and out = (Q(A) @ dequant(B)) * tsA * tsB, f32 accumulation.
//
// What bounds it on an H100 depends on M:
//   * decode (M 1-8): the packed weight stream, 0.5625 B/param -- 9.4 MB at
//     4096 x 4096 (2.8 us at 3.35 TB/s), 73.7 MB at the 4096 x 32000
//     lm_head; the 2*M*N*K operations lie far below that line;
//   * verify and prefill (M 32-256): the operations, 2*M*N*K at the 989
//     TFLOP/s bf16 tensor-core rate (4096^2 at M 256: 8.6 GFLOP, 8.7 us).
//
// What the design does about it -- three routes, chosen on the host from
// M and A's spec (fp4_matmul.py: k4_route), none a fallback of another;
// code x scale of A must be exact in bf16 for the first two:
//   * "gemv" (M <= K4_GEMV_MAX_M = 32): a split-K GEMV on mma.sync
//     (m16n8k16, bf16 operands, f32 accumulation), two launches.  A
//     64-block prologue writes partial maxima of |A| for A's power-of-two
//     tensor scale (it stays on the device: no host sync) and zeroes the
//     arrival counters.  Given a_amax (a row-parallel shard's global |A|
//     max, a device f32) the scale comes from it and the prologue only
//     zeroes the counters; a column-parallel shard passes the full N's
//     split plan, so its columns sum in the 1-device order.  Then a block owns 256 output columns, 8 or 16 rows
//     of A and one K range: a 4-stage cp.async ring streams the packed rows
//     and their scale rows in 16-byte copies, neighbouring threads on
//     neighbouring bytes, while the block quantizes its slice of A into
//     shared memory as bf16 (one value per thread, each block of A on
//     neighbouring lanes; the steps and bits of fp4::quant_block_bits,
//     which K1 and K2 run).  Each warp owns 32 columns as the even and the
//     odd columns of two 16-column slices, so a lane builds its B fragment
//     from one packed byte per k row: a byte -> E2M1 pair table, times the
//     two columns' E4M3 scales (bf16 products, exact).  The K splits (2
//     blocks per SM at N 4096) write f32 partials, and the last block of a
//     column tile to arrive (an integer counter, no float atomics) sums
//     them in split order and applies tsA * tsB, so repeated calls give the
//     same bits.  The decode rows are bound by the packed weight's bytes;
//     the tensor cores keep the products off the CUDA cores.
//   * "core" (M above that): A' in bf16 from fp4::quantize_operand_to (an
//     |A| max or the given a_amax, then one thread per block of A in the
//     TPU kernel's order of operations), B' (N, K) bf16 from a
//     dequantization pre-pass (nibble x E4M3 is exact in bf16: 16-byte
//     reads, 64 x 128 shared-memory tiles, 16-byte stores of 8 consecutive
//     k), then the tensor-core GEMM core of fp4_gemm.cuh (TMA ring + wgmma
//     m64n256k16, f32 accumulation), tsA * tsB in its epilogue: exact
//     products summed in another order.
//   * "f32" (an A spec whose code x scale is not exact in bf16, any M):
//     fp4::quantize_operand to f32, then the f32 CUDA-core tile loop below,
//     64 x 64 tiles.
// Every launch is on the caller's stream; workspaces come from the wrapper.
#include "fp4_common.cuh"
#include "fp4_gemm.cuh"

namespace {

// ---- route "f32": tiled f32 GEMM, B decoded in the tile load ----

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

// ---- route "gemv": split-K packed GEMV on mma.sync ----

constexpr int GV_NT = 256;       // output columns per block, 32 per warp
constexpr int GV_THREADS = 256;  // 8 warps
constexpr int GV_KT = 32;        // weight rows per stage: 2 mma k-steps
constexpr int GV_STAGES = 4;
constexpr int GV_CSTRIDE = GV_NT / 2 + 16;  // packed row in shared memory
constexpr int GV_SROWS = GV_KT / 2 + 1;     // scale rows a stage spans
constexpr int GV_STAGE_BYTES = GV_KT * GV_CSTRIDE + GV_SROWS * GV_NT;
constexpr int GV_LUT_BYTES = 256 * 4 + 256 * 2;
constexpr int GV_PARTS = 64;     // prologue blocks: partial maxima of |A|

// Dynamic shared memory of k4_gemv_kernel<MR> for a K range of ks rows.
static size_t gemv_smem(int mr, int ks) {
  return GV_LUT_BYTES + size_t(mr) * (ks + 8) * 2 +
         size_t(GV_STAGES) * GV_STAGE_BYTES;
}

// GV_PARTS blocks: partial maxima of |A| (two-level specs without a given
// amax) into parts[], and block 0 zeroes the GEMV's arrival counters.
__global__ void __launch_bounds__(256)
k4_gemv_prologue_kernel(const void* __restrict__ a, int a_bf16, size_t n,
                        int two_level, float* __restrict__ parts,
                        int* __restrict__ counters, int n_counters) {
  const int tid = threadIdx.x;
  if (blockIdx.x == 0)
    for (int i = tid; i < n_counters; i += blockDim.x) counters[i] = 0;
  if (!two_level) return;
  const size_t stride = size_t(gridDim.x) * blockDim.x;
  float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + tid; i < n;
       i += 4 * stride) {
    m0 = fmaxf(m0, fabsf(fp4::load_f(a, i, a_bf16)));
    if (i + stride < n)
      m1 = fmaxf(m1, fabsf(fp4::load_f(a, i + stride, a_bf16)));
    if (i + 2 * stride < n)
      m2 = fmaxf(m2, fabsf(fp4::load_f(a, i + 2 * stride, a_bf16)));
    if (i + 3 * stride < n)
      m3 = fmaxf(m3, fabsf(fp4::load_f(a, i + 3 * stride, a_bf16)));
  }
  float m = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[8];
  if (tid % 32 == 0) warp_max[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < 8; ++w) m = fmaxf(m, warp_max[w]);
    parts[blockIdx.x] = m;
  }
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t hmul2_bf16(uint32_t a, uint32_t b) {
  __nv_bfloat162 x, y;
  memcpy(&x, &a, 4);
  memcpy(&y, &b, 4);
  const __nv_bfloat162 z = __hmul2(x, y);
  uint32_t r;
  memcpy(&r, &z, 4);
  return r;
}

// Q(A) of one block of `block` values into shared memory as bf16 (exact
// for a bf16-exact spec), in the TPU kernel's order of operations: one
// thread per block.
template <int BLK>
__device__ __forceinline__ void quant_a_block(
    const void* __restrict__ a, int a_bf16, const uint32_t* __restrict__ rbits,
    size_t base, int block, const fp4::QuantParams& qa, float ts,
    __nv_bfloat16* dst) {
  const fp4::BlockBits bits{rbits, base, 1, 0u, 0u, 0u, 0};
  fp4::quant_block_bits<BLK>(a, a_bf16, bits, base, 1, block, qa, ts,
                             [&](int e, float code, float scale) {
                               dst[e] = __float2bfloat16_rn(
                                   __fmul_rn(code, scale));
                             });
}

// The same quantizer with one thread per value: a block of `block` values
// (a power of two <= 32) lives on `block` neighbouring lanes, which share
// its |max| by shuffles; then each lane quantizes its value by the steps of
// fp4::quant_block_bits (scale from absmax, code = Q(x / (scale * ts)),
// code * scale), so the bits are the same and the chain is one value long.
// Every lane of the warp calls it (x = 0 on lanes with in = false).
__device__ __forceinline__ float quant_a_value(float x, bool in, bool sr,
                                               uint32_t bits, int block,
                                               const fp4::QuantParams& qa,
                                               float ts) {
  float absmax = in ? fabsf(x) : 0.f;
  for (int off = block / 2; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
  const fp4::FmtParams dp{qa.data_man_bits, qa.data_emin, qa.data_emax,
                          qa.data_max};
  const fp4::FmtParams sp{qa.scale_man_bits, qa.scale_emin, qa.scale_emax,
                          qa.scale_max};
  const float scale = qa.e8m0 ? fp4::e8m0_block_scale(absmax, dp.emax)
                              : fp4::generic_block_scale(absmax, dp.max, sp, ts);
  const float scaled = __fdiv_rn(x, __fmul_rn(scale, ts));
  const float code =
      sr ? fp4::quantize_sr(scaled, dp, fp4::uniform_from_bits(bits))
         : fp4::quantize_rtn(scaled, dp);
  return __fmul_rn(code, scale);
}

// out (M, N) = (Q(A) @ B') * tsA * tsB, split over K.  grid (N / 256
// tiles, splits, M chunks of MR), 8 warps; warp w owns columns n0 + 32w ..
// + 31 as two 16-column slices, each one mma of its even and one of its odd
// columns, so a lane's B fragment comes from one packed byte per k row.
// Each block quantizes its own slice of A (rows m0 .., columns [k_begin,
// k_end)) into shared memory, streams B through the ring, writes its f32
// partial, and the last block of a (tile, M chunk) to arrive (an integer
// counter) sums the splits' partials in split order and writes out.  vec:
// N % 32 == 0 and both B bases 16-byte aligned.  K % 16 == 0.
template <int MR>
__global__ void __launch_bounds__(GV_THREADS)
k4_gemv_kernel(const void* __restrict__ a, int a_bf16,
               const uint32_t* __restrict__ a_rbits, fp4::QuantParams qa,
               int block_a, const float* __restrict__ parts,
               const float* __restrict__ a_amax,
               const float* __restrict__ tsb, const uint8_t* __restrict__ bp,
               const uint8_t* __restrict__ bs, float* __restrict__ part,
               int* __restrict__ counters, void* __restrict__ out,
               int out_bf16, int M, int N, int K, int block_b, int ks,
               int vec) {
  static_assert(MR == 8 || MR == 16, "A fragments of 8 or 16 rows");
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lutp = reinterpret_cast<uint32_t*>(smem);  // byte -> 2 x E2M1
  uint16_t* luts = reinterpret_cast<uint16_t*>(smem + 1024);  // E4M3 byte
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem + GV_LUT_BYTES);
  const int astride = ks + 8;  // bf16 elements; keeps A's fragments apart
  uint8_t* ring = smem + GV_LUT_BYTES + size_t(MR) * astride * 2;
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = blockIdx.x * GV_NT, split = blockIdx.y;
  const int m0 = blockIdx.z * MR, rows_m = min(MR, M - m0);
  const int k_begin = split * ks, k_end = min(K, k_begin + ks);
  const int kn = k_end - k_begin;
  const size_t half_n = size_t(N) / 2;

  // stage st: packed rows k0 .. k0 + GV_KT - 1 (8 chunks of 16 bytes = 32
  // columns each) and the scale rows they use (16 chunks of 16 columns)
  auto fetch = [&](int st) {
    uint8_t* codes = ring + (st % GV_STAGES) * GV_STAGE_BYTES;
    uint8_t* scl = codes + GV_KT * GV_CSTRIDE;
    const int k0 = k_begin + st * GV_KT;
    const int rows = min(GV_KT, k_end - k0);
    for (int c = tid; c < rows * 8; c += GV_THREADS) {
      const int r = c / 8, u = c % 8;
      uint8_t* dst = codes + r * GV_CSTRIDE + u * 16;
      const uint8_t* src = bp + size_t(k0 + r) * half_n + n0 / 2 + u * 16;
      const int ncol = N - (n0 + 32 * u);
      if (vec && ncol >= 32) {
        fp4::cp_async16(dst, src);
      } else {
        for (int j = 0; j < 16; ++j) dst[j] = (2 * j < ncol) ? src[j] : 0;
      }
    }
    const int sr0 = k0 / block_b;
    const int nsr = (k0 + rows - 1) / block_b - sr0 + 1;
    for (int c = tid; c < nsr * 16; c += GV_THREADS) {
      const int r = c / 16, u = c % 16;
      uint8_t* dst = scl + r * GV_NT + u * 16;
      const uint8_t* src = bs + size_t(sr0 + r) * N + n0 + u * 16;
      const int ncol = N - (n0 + 16 * u);
      if (vec && ncol >= 16) {
        fp4::cp_async16(dst, src);
      } else {
        for (int j = 0; j < 16; ++j) dst[j] = (j < ncol) ? src[j] : 0;
      }
    }
  };

  // the weight stream starts first; Q(A) is computed while it flies
  const int nst = (kn + GV_KT - 1) / GV_KT;
#pragma unroll
  for (int s = 0; s < GV_STAGES - 1; ++s) {
    if (s < nst) fetch(s);
    fp4::cp_async_commit();
  }
  for (int i = tid; i < 256; i += GV_THREADS) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(
        fp4::decode_e2m1(i & 0xF), fp4::decode_e2m1(i >> 4));
    memcpy(&lutp[i], &v, 4);
    const __nv_bfloat16 sv = __float2bfloat16_rn(fp4::decode_e4m3(i));
    memcpy(&luts[i], &sv, 2);
  }
  // A's tensor scale from the given |A| max, or from the prologue's
  // partial maxima (each warp alike)
  float ts = 1.0f;
  if (qa.two_level) {
    float m;
    if (a_amax) {
      m = *a_amax;
    } else {
      m = fmaxf(parts[lane], parts[lane + 32]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    ts = fp4::tensor_scale_pow2(m, qa.ts_denom);
  }
  {
    if (block_a <= 32 && (block_a & (block_a - 1)) == 0) {
      // one value per thread: blocks of A on neighbouring lanes; the loads
      // of QB values go out together, then their chains run side by side
      constexpr int QB = 8;
      const int nv = rows_m * kn;
      for (int v0 = 0; v0 < nv; v0 += QB * GV_THREADS) {
        float x[QB];
        uint32_t rb[QB];
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const int v = v0 + j * GV_THREADS + tid;
          const size_t i = size_t(m0 + v / kn) * K + k_begin + v % kn;
          x[j] = v < nv ? fp4::load_f(a, i, a_bf16) : 0.f;
          rb[j] = v < nv && a_rbits ? a_rbits[i] : 0u;
        }
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const int v = v0 + j * GV_THREADS + tid;
          if (v0 + j * GV_THREADS >= nv) break;  // uniform
          const float y = quant_a_value(x[j], v < nv, a_rbits != nullptr,
                                        rb[j], block_a, qa, ts);
          if (v < nv) as[(v / kn) * astride + v % kn] = __float2bfloat16_rn(y);
        }
      }
    } else {
      const int nb = kn / block_a;  // A blocks per row of the slice
      for (int i = tid; i < rows_m * nb; i += GV_THREADS) {
        const int m = i / nb, jb = i % nb;
        const size_t base = size_t(m0 + m) * K + k_begin + jb * block_a;
        quant_a_block<0>(a, a_bf16, a_rbits, base, block_a, qa, ts,
                         as + m * astride + jb * block_a);
      }
    }
  }

  float acc[2][2][4];  // [slice][even, odd columns][mma fragment]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][h][j] = 0.f;

  for (int st = 0; st < nst; ++st) {
    if (st + GV_STAGES - 1 < nst) fetch(st + GV_STAGES - 1);
    fp4::cp_async_commit();
    fp4::cp_async_wait<GV_STAGES - 1>();
    __syncthreads();
    const uint8_t* codes = ring + (st % GV_STAGES) * GV_STAGE_BYTES;
    const uint8_t* scl = codes + GV_KT * GV_CSTRIDE;
    const int k0 = k_begin + st * GV_KT;
    const int sr0 = k0 / block_b;
    const int steps = min(GV_KT, k_end - k0) / 16;
#pragma unroll
    for (int ks16 = 0; ks16 < GV_KT; ks16 += 16) {
      if (ks16 >= steps * 16) break;
      // A fragment: rows g (and g + 8), k = 2q, 2q + 1 (and + 8)
      const __nv_bfloat16* ar = as + g * astride + (k0 - k_begin) + ks16 + 2 * q;
      uint32_t af[4];
      af[0] = *reinterpret_cast<const uint32_t*>(ar);
      af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      if (MR == 16) {
        af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * astride);
        af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * astride + 8);
      } else {
        af[1] = af[3] = 0u;
      }
      const int ra = ks16 + 2 * q, rb = ra + 8;  // this lane's k rows
      const int sa = (k0 + ra) / block_b - sr0, sb = (k0 + rb) / block_b - sr0;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int cb = warp * 16 + s * 8 + g;  // packed byte: columns 2cb, 2cb + 1
        const uint32_t c0 = codes[ra * GV_CSTRIDE + cb];
        const uint32_t c1 = codes[(ra + 1) * GV_CSTRIDE + cb];
        const uint32_t c2 = codes[rb * GV_CSTRIDE + cb];
        const uint32_t c3 = codes[(rb + 1) * GV_CSTRIDE + cb];
        const uint16_t ba = *reinterpret_cast<const uint16_t*>(
            scl + sa * GV_NT + 2 * cb);
        const uint32_t pa = luts[ba & 0xFF] | (uint32_t(luts[ba >> 8]) << 16);
        uint32_t pb = pa;
        if (sb != sa) {
          const uint16_t bb = *reinterpret_cast<const uint16_t*>(
              scl + sb * GV_NT + 2 * cb);
          pb = luts[bb & 0xFF] | (uint32_t(luts[bb >> 8]) << 16);
        }
        // (even, odd) column values of each row, code x scale exact in bf16
        const uint32_t v0 = hmul2_bf16(lutp[c0], pa);
        const uint32_t v1 = hmul2_bf16(lutp[c1], pa);
        const uint32_t v2 = hmul2_bf16(lutp[c2], pb);
        const uint32_t v3 = hmul2_bf16(lutp[c3], pb);
        mma_bf16_16816(acc[s][0], af, prmt(v0, v1, 0x5410),
                       prmt(v2, v3, 0x5410));
        mma_bf16_16816(acc[s][1], af, prmt(v0, v1, 0x7632),
                       prmt(v2, v3, 0x7632));
      }
    }
    __syncthreads();
  }
  fp4::cp_async_wait<0>();

  // the split's partial: rows g and g + 8, columns 4q .. 4q + 3 of each
  // slice (even mma column j is column 2j, odd is 2j + 1)
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int n = n0 + warp * 32 + s * 16 + 4 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = g + 8 * h;
      if (m >= rows_m || (MR == 8 && h == 1)) continue;
      const float v[4] = {acc[s][0][2 * h], acc[s][1][2 * h],
                          acc[s][0][2 * h + 1], acc[s][1][2 * h + 1]};
      float* dst = part + (size_t(split) * M + m0 + m) * N + n;
      if (n + 3 < N && (N % 4) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) dst[j] = v[j];
      }
    }
  }

  // the last block of this (tile, M chunk) to arrive reduces the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev =
        atomicAdd(&counters[blockIdx.z * gridDim.x + blockIdx.x], 1);
    is_last = prev == int(gridDim.y) - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each thread 4 neighbouring columns of one row, the splits' partials
  // added in split order with 8 loads in flight
  const float sc = __fmul_rn(ts, *tsb);
  const size_t mn = size_t(M) * N;
  const int S = gridDim.y;
  for (int e = tid; e < rows_m * (GV_NT / 4); e += GV_THREADS) {
    const int m = e / (GV_NT / 4), n = n0 + 4 * (e % (GV_NT / 4));
    if (n >= N) continue;
    const size_t i = size_t(m0 + m) * N + n;
    const bool vec4 = (N % 4) == 0 && n + 4 <= N;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    int sp = 0;
    if (vec4) {
      for (; sp < S; sp += 8) {
        float4 t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (sp + j < S)
            t[j] = __ldcg(reinterpret_cast<const float4*>(part + (sp + j) * mn + i));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (sp + j < S) {
            v[0] += t[j].x;
            v[1] += t[j].y;
            v[2] += t[j].z;
            v[3] += t[j].w;
          }
      }
    } else {
      for (; sp < S; ++sp)
        for (int c = 0; c < 4 && n + c < N; ++c)
          v[c] += __ldcg(part + sp * mn + i + c);
    }
    for (int c = 0; c < 4 && n + c < N; ++c) {
      const float o = v[c] * sc;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[i + c] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(out)[i + c] = o;
    }
  }
}

template <int MR>
int launch_gemv(const void* a, int a_bf16, const uint32_t* a_rbits,
                const fp4::QuantParams& qa, int block_a, float* parts,
                const float* a_amax, const float* tsb, const uint8_t* bp,
                const uint8_t* bs,
                float* part, int* counters, void* out, int out_bf16, int M,
                int N, int K, int block_b, int splits, int ks,
                cudaStream_t stream) {
  const size_t smem = gemv_smem(MR, ks);
  const cudaError_t attr = cudaFuncSetAttribute(
      k4_gemv_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return int(attr);
  const int vec = N % 32 == 0 && ((reinterpret_cast<uintptr_t>(bp) |
                                   reinterpret_cast<uintptr_t>(bs)) & 15) == 0;
  const dim3 grid((N + GV_NT - 1) / GV_NT, splits, (M + MR - 1) / MR);
  k4_gemv_prologue_kernel<<<GV_PARTS, 256, 0, stream>>>(
      a, a_bf16, size_t(M) * K, qa.two_level && !a_amax, parts, counters,
      int(grid.x * grid.z));
  k4_gemv_kernel<MR><<<grid, GV_THREADS, smem, stream>>>(
      a, a_bf16, a_rbits, qa, block_a, parts, a_amax, tsb, bp, bs, part,
      counters,
      out, out_bf16, M, N, K, block_b, ks, vec);
  return int(cudaGetLastError());
}

// ---- route "core": B' (N, K) bf16 pre-pass for the tensor-core core ----

// dst (N, K) bf16 = (E2M1(codes) x E4M3(scales))^T in 64 (k) x 128 (n)
// tiles: each thread reads 16 packed bytes (32 columns of one row) and
// their 32 scale bytes, decodes them through shared-memory tables into the
// tile, and writes 8 consecutive k of one column in one 16-byte store.
// K % 8 == 0; vec as in k4_gemv_kernel.
__global__ void __launch_bounds__(256)
k4_dequant_t_kernel(const uint8_t* __restrict__ bp,
                    const uint8_t* __restrict__ bs, int N, int K, int block_b,
                    int vec, __nv_bfloat16* __restrict__ dst) {
  __shared__ float tile[64][129];
  __shared__ float lut16[16], lut8[256];
  const int tid = threadIdx.x;
  if (tid < 16) lut16[tid] = fp4::decode_e2m1(tid);
  lut8[tid] = fp4::decode_e4m3(tid);
  __syncthreads();
  const int n0 = blockIdx.x * 128, k0 = blockIdx.y * 64;
  const size_t half_n = size_t(N) / 2;
  {
    const int r = tid / 4, c0 = (tid % 4) * 32, k = k0 + r, n = n0 + c0;
    union {
      uint4 v;
      uint8_t b[16];
    } codes;
    union {
      uint4 v[2];
      uint8_t b[32];
    } scales;
    if (k < K && vec && n + 32 <= N) {
      codes.v =
          *reinterpret_cast<const uint4*>(bp + size_t(k) * half_n + n / 2);
      const uint4* sp = reinterpret_cast<const uint4*>(
          bs + size_t(k / block_b) * N + n);
      scales.v[0] = sp[0];
      scales.v[1] = sp[1];
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const bool in = k < K && n + j < N;
        if (j % 2 == 0)
          codes.b[j / 2] = in ? bp[size_t(k) * half_n + (n + j) / 2] : 0;
        scales.b[j] = in ? bs[size_t(k / block_b) * N + n + j] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      tile[r][c0 + 2 * j] =
          lut16[codes.b[j] & 0xF] * lut8[scales.b[2 * j]];
      tile[r][c0 + 2 * j + 1] =
          lut16[codes.b[j] >> 4] * lut8[scales.b[2 * j + 1]];
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int i = tid + 256 * it, nl = i / 8, kg = (i % 8) * 8;
    if (n0 + nl < N && k0 + kg < K) {
      float q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = tile[kg + j][nl];
      fp4::store_block(dst + size_t(n0 + nl) * K + k0 + kg, q);
    }
  }
}

}  // namespace

// route 0 "gemv": ws_a f32 (64): partial maxima of |A|; ws_b int32
//   counters (one per 256-column tile and chunk of 16 rows of A), ws_c f32
//   (splits, M, N) partials; K % 16 == 0, split in ranges of ks rows (a
//   multiple of 32 and of block_a).
// route 1 "core": ws_a uint32 (1) + f32 (1): |A| max and tensor scale;
//   ws_b bf16 (M, K) A'; ws_c bf16 (N, K) B'; K % 8 == 0, 16-byte aligned.
// route 2 "f32": ws_a as "core"; ws_b f32 (M, K) A'.
// a_amax: null, or a device f32 holding the |A| max to derive A's tensor
// scale from (a row-parallel shard's global max), in place of every
// route's own absmax pass.  The GEMV's split plan (splits, ks) comes from
// the caller (fp4_matmul.py: k4_gemv_plan).
// Returns a cudaError_t.
extern "C" int fp4_packed_matmul(const void* a, int a_bf16,
                                 const uint8_t* b_packed,
                                 const uint8_t* b_scales, const float* tsb,
                                 const uint32_t* a_rbits,
                                 const float* a_amax, int M, int N, int K,
                                 int block_a, int block_b,
                                 const fp4::QuantParams* qa, int route,
                                 int splits, int ks, void* ws_a, void* ws_b,
                                 void* ws_c, void* out, int out_bf16,
                                 cudaStream_t stream) {
  if (route == 0) {
    auto* parts = static_cast<float*>(ws_a);
    auto* ctr = static_cast<int*>(ws_b);
    auto* part = static_cast<float*>(ws_c);
    return M <= 8 ? launch_gemv<8>(a, a_bf16, a_rbits, *qa, block_a, parts,
                                   a_amax, tsb, b_packed, b_scales, part, ctr,
                                   out, out_bf16, M, N, K, block_b, splits,
                                   ks, stream)
                  : launch_gemv<16>(a, a_bf16, a_rbits, *qa, block_a, parts,
                                    a_amax, tsb, b_packed, b_scales, part,
                                    ctr, out, out_bf16, M, N, K, block_b,
                                    splits, ks, stream);
  }
  // a given |A| max is read as the bits the absmax pass would have written
  // (a non-negative float orders like its bit pattern)
  auto* amax = a_amax ? reinterpret_cast<unsigned int*>(
                            const_cast<float*>(a_amax))
                      : static_cast<unsigned int*>(ws_a);
  float* tsa = static_cast<float*>(ws_a) + 1;
  if (route == 1) {
    auto* aq = static_cast<__nv_bfloat16*>(ws_b);
    auto* bq = static_cast<__nv_bfloat16*>(ws_c);
    const fp4::SrBits sr{a_rbits, 0u, 0u, 0u, 0};
    fp4::quantize_operand_to(a, a_bf16, sr, size_t(M), size_t(K), block_a, 0,
                             0, *qa, amax, tsa, aq, stream, a_amax != nullptr);
    const int vec = N % 32 == 0 &&
                    ((reinterpret_cast<uintptr_t>(b_packed) |
                      reinterpret_cast<uintptr_t>(b_scales)) & 15) == 0;
    k4_dequant_t_kernel<<<dim3((N + 127) / 128, (K + 63) / 64), 256, 0,
                          stream>>>(b_packed, b_scales, N, K, block_b, vec,
                                    bq);
    return fp4gemm::launch_gemm(aq, bq, M, N, K, tsa, tsb, out, out_bf16,
                                stream);
  }
  auto* aq = static_cast<float*>(ws_b);
  fp4::quantize_operand(a, a_bf16, a_rbits, size_t(M), size_t(K), block_a, 0,
                        *qa, amax, tsa, aq, stream, a_amax != nullptr);
  constexpr int BM = 64, BN = 64, BK = 32;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  packed_gemm_kernel<BM, BN, BK, 4, 4><<<grid, (BM / 4) * (BN / 4), 0,
                                          stream>>>(
      aq, b_packed, b_scales, tsa, tsb, out, out_bf16, M, N, K, block_b);
  return int(cudaGetLastError());
}
