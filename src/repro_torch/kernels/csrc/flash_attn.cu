// K7 flash_attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces repro/kernels/flash_attn.py::flash_attention (_flash_kernel,
// pl.pallas_call at flash_attn.py:454): attention of q (B, Sq, H, D) over
// k, v (B, Sk, KVH, D), bf16 or f32, GQA, causal or not, an optional
// sliding window, any Sq and Sk, with p rounded to V's dtype before the pv
// product (flash_attn.py:80-82).  K6 (flash_attention_packed) runs on K5's
// split-KV body in flash_attn_paged.cu.
//
// What bounds it on an H100: bytes, and in practice latency.  The serving
// prefill (B 4, S 64, H 32, D 128, f32 operands that are exact upcasts of
// bf16) moves 16.8 MB, 5.0 us at 3.35 TB/s, for 0.14 GFLOP of causal
// work, under 1 us on the TF32 tensor cores even tripled; run B's cold
// prefill (1, 192, 32) moves 6.3 MB.  A block sees only a few key tiles,
// so what costs time is how early its copies are in flight and whether its
// dots run as serial chains.
//
// What the design does about it:
//   * a block holds a q tile of 16 x NW = 64 rows (4 warps share each K/V
//     tile most widely; on an H100 they measured fastest of 1, 2 and 4 at
//     every serving shape), a warp for 16 rows that keeps its scores and
//     output in mma.sync accumulator fragments.  With f32 operands two such warp
//     groups take alternate key tiles and merge (m, l, O) at the end: a
//     q tile's key tiles run one after another, and the last q tile of a
//     causal prefill has the most of them, so this halves the critical
//     path (p is not rounded in f32, so the split moves only f32 rounding;
//     bf16 keeps one group and the tile order).  f32 operands (the main path) run S = q k^T and O += p V
//     as TF32 m16n8k8 in the 3xTF32 split (x = big + small, both TF32;
//     small*big + big*small + big*big), which keeps f32 accuracy to ~2^-22
//     per product.  Where every q, K and V value of a tile is a TF32 value
//     (the main path's bf16 upcasts: small = 0; one check a tile, block-
//     wide), S takes one mma a k step and p V two (p's split), the products
//     the 3xTF32 route would add, in a third of the instructions.  bf16
//     operands run O += p V as bf16 m16n8k16 (p rounded to
//     bf16 first, the TPU kernel's rule, so its products are exact) and S
//     as each score's sequential FMA chain over d on the CUDA cores: the
//     plain version's f32 GEMM sums in that order, and a score an f32 ulp
//     away flips p's bf16 rounding now and then (on an H100, S on the
//     tensor cores left outputs 2 bf16 ulps off the plain version's);
//   * the tensor cores add into an accumulator with truncation, so every
//     k step goes into a zero accumulator and is added in f32 (on an H100,
//     48 mma chained into one accumulator left f32 outputs 5.2e-6 off the
//     plain version's, this way 1.9e-6);
//   * key tiles are 32 wide, the plain version's TILE_KV, so p is rounded
//     against the same running max; the online softmax runs on the
//     accumulator fragments (a row lies on a 4-lane quad: 2 shuffles per
//     reduction) and S's fragments are pv's A operand without a shuffle
//     (for TF32 the pv k order is permuted to the accumulator's: lane c's
//     keys 2c and 2c + 1 are k rows c and c + 4, and V's rows follow);
//   * the block's q rows and the K/V tiles arrive by 16-byte cp.async,
//     K/V double-buffered, into padded rows that make the fragment loads
//     bank-conflict free (ldmatrix for bf16 V; for f32 16-byte K and q
//     loads, whose d order the A fragment follows, and 4-byte V loads);
//     rows past Sq or Sk are zero-filled, and keys past Sk take p = 0, as
//     the plain version's shorter last tile has no such keys;
//   * a warp skips the tiles past its causal frontier or before its
//     window (exact: such a tile adds 0 after a valid key, and one before
//     every valid key is wiped by the next tile's max, as in the
//     reference); the longest q tiles launch first;
//   * masked scores are NEG_INF = -1e30 as in the TPU kernel; a row that
//     sees no valid key at all writes 0 (the reference averages V there).
#include <type_traits>

#include "fp4_common.cuh"

namespace {

constexpr int TK = 32;  // keys per tile: the plain version's TILE_KV
constexpr int NW = 4;   // warps (16 query rows each) per q tile
constexpr float NEG_INF = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int Sq, Sk, H, KVH, causal, window;
  float sm_scale;
};

// 16 bytes global -> shared, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

// x = big + small, both rounded to TF32 (x - big is exact in f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) @ b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor cores add into their accumulator with truncation, so a chain
// of mma into one accumulator drifts by an f32 ulp of the running sum per
// step; each k step below goes into a zero accumulator and is added to the
// sum in f32 with rounding to nearest, as an FMA chain would be.
__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// d += a b in 3xTF32, a given split (big ab, small as), b as two f32
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t* ab,
                                           const uint32_t* as, float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb0, bb1);
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
  add4(d, t);
}

// Bits 0-12 of every element of rows x cols floats (row stride ld) ORed:
// 0 where each is a TF32 value (big = x, small = 0), as the main path's
// bf16 upcasts are.  Each thread takes 16-byte pieces from tid on.
__device__ __forceinline__ uint32_t low_bits(const float* t, int rows,
                                             int cols, int ld) {
  uint32_t acc = 0;
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const uint4 u = *reinterpret_cast<const uint4*>(t + (i / per_row) * ld +
                                                    4 * (i % per_row));
    acc |= u.x | u.y | u.z | u.w;
  }
  return acc & 0x1fffu;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, bf16 m16n8k16, through a zero accumulator
__device__ __forceinline__ void mma_bf16_add(float (&d)[4], const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b0, b1);
  add4(d, t);
}

// the B fragments of two n8 tiles from 16 rows of a row-major bf16 tile,
// transposed (B's k = the tile's rows)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

template <int D, bool BF16>
struct Layout {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  // shared row strides (elements) that keep each warp-wide load free of
  // bank conflicts: bf16 rows of D + 8 (ldmatrix's 8 rows; the score
  // loop's 16-byte loads of 8 q rows and of 4 K rows); f32 K and q rows of
  // D + 16 (16-byte loads of 2 rows x 4 lanes), V rows of D + 4 (4-byte
  // loads of keys 2c, 2c + 1 by 32 lanes)
  static constexpr int KS = BF16 ? D + 8 : D + 16;
  static constexpr int VS = BF16 ? D + 8 : D + 4;
  // warp groups that share the key tiles of one q tile: f32 p is not
  // rounded, so two groups can run alternate tiles and merge (m, l, O) at
  // the end (f32 rounding only); bf16 rounds p against the running max of
  // every tile before it, so its tiles run in order
  static constexpr int KSPLIT = BF16 ? 1 : 2;
  // 2 stages of KSPLIT K tiles [TK][KS] and V tiles [TK][VS], then the
  // block's q rows [16 NW][KS]
  static constexpr size_t smem =
      sizeof(T) * (2 * KSPLIT * TK * (KS + VS) + 16 * NW * KS);
};

// 8 bf16 (16 bytes) -> 8 floats, exactly
__device__ __forceinline__ void unpack8(const void* p, float (&f)[8]) {
  const uint4 u = *static_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// grid (H, B, q tiles), 32 * NW * KSPLIT threads: NW warps of 16 query
// rows in each of KSPLIT groups, group g taking tiles t_first + g,
// t_first + g + KSPLIT, ...; q tile z holds rows [16 NW z, 16 NW (z + 1)).
// Dynamic shared memory as Layout::smem.
template <int D, bool BF16>
__global__ void __launch_bounds__(256) flash_mma_kernel(const FlashArgs a) {
  using L = Layout<D, BF16>;
  using T = typename L::T;
  constexpr int KS = L::KS, VS = L::VS, KSPLIT = L::KSPLIT;
  constexpr int NT = D / 8;                        // n8 tiles of O
  constexpr int CPR = D * int(sizeof(T)) / 16;     // 16-byte chunks a row
  constexpr int EPC = 16 / int(sizeof(T));         // elements a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  T* kst = reinterpret_cast<T*>(smem);
  T* vst = kst + 2 * KSPLIT * TK * KS;
  T* qst = vst + 2 * KSPLIT * TK * VS;

  const int grp = (threadIdx.x >> 5) / NW, warp = (threadIdx.x >> 5) % NW;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest q tiles first
  const int kvh = h / (a.H / a.KVH);
  const int Sq = a.Sq, Sk = a.Sk;
  const int q0 = qt * 16 * NW, r0 = q0 + 16 * warp;

  // keys [beg, end) that rows first_row .. last_row can see
  auto key_end = [&](int last_row) {
    return a.causal ? min(Sk, last_row + 1) : Sk;
  };
  auto key_beg = [&](int first_row) {
    return a.window > 0 ? max(0, first_row - a.window + 1) : 0;
  };
  const int kb_beg = key_beg(q0);
  const int kb_end = key_end(min(q0 + 16 * NW, Sq) - 1);
  const bool live = r0 < Sq;
  const int w_beg = key_beg(r0);
  const int w_end = live ? key_end(min(r0 + 16, Sq) - 1) : 0;
  const int t_first = kb_beg / TK;
  const int n_tiles = kb_end > kb_beg ? (kb_end - 1) / TK - t_first + 1 : 0;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // buffer bi (stage * KSPLIT + slot) <- the K and V rows of tile t (zero
  // past Sk)
  auto fetch = [&](int t, int bi) {
    T* kd = kst + bi * TK * KS;
    T* vd = vst + bi * TK * VS;
    for (int i = threadIdx.x; i < 2 * TK * CPR; i += blockDim.x) {
      const bool isv = i >= TK * CPR;
      const int r = isv ? i - TK * CPR : i;
      const int j = r / CPR, u = r % CPR, key = t * TK + j;
      const bool in = key < Sk;
      const T* src = static_cast<const T*>(isv ? a.v : a.k) +
                     ((size_t(b) * Sk + (in ? key : 0)) * a.KVH + kvh) * D +
                     u * EPC;
      cp_async16_zfill((isv ? vd + j * VS : kd + j * KS) + u * EPC, src, in);
    }
  };

  uint32_t q_bits = 0;  // f32: low_bits of this thread's share of q
  if (n_tiles > 0) {
    // the block's q rows (zero past Sq), with the first tile
    for (int i = threadIdx.x; i < 16 * NW * CPR; i += blockDim.x) {
      const int j = i / CPR, u = i % CPR, row = q0 + j;
      const bool in = row < Sq;
      cp_async16_zfill(qst + j * KS + u * EPC,
                       static_cast<const T*>(a.q) +
                           ((size_t(b) * Sq + (in ? row : 0)) * a.H + h) * D +
                           u * EPC,
                       in);
    }
    for (int i = 0; i < KSPLIT && i < n_tiles; ++i) fetch(t_first + i, i);
  }
  fp4::cp_async_commit();
  for (int it = 0; it < n_tiles; it += KSPLIT) {
    const int st = (it / KSPLIT) & 1;
    for (int i = 0; i < KSPLIT && it + KSPLIT + i < n_tiles; ++i)
      fetch(t_first + it + KSPLIT + i, (st ^ 1) * KSPLIT + i);
    fp4::cp_async_commit();
    fp4::cp_async_wait<1>();
    const int t = t_first + it + grp, key0 = t * TK;
    const T* kt = kst + (st * KSPLIT + grp) * TK * KS;
    const T* vt = vst + (st * KSPLIT + grp) * TK * VS;
    bool exact = false;  // f32: q, K and V all TF32 values (small parts 0)
    if constexpr (BF16) {
      __syncthreads();
    } else {
      __syncthreads();
      if (it == 0) q_bits = low_bits(qst, 16 * NW, D, KS);
      uint32_t bits = q_bits;
      for (int i = 0; i < KSPLIT && it + i < n_tiles; ++i)
        bits |= low_bits(kst + (st * KSPLIT + i) * TK * KS, TK, D, KS) |
                low_bits(vst + (st * KSPLIT + i) * TK * VS, TK, D, VS);
      exact = !__syncthreads_or(bits);
    }
    if (live && it + grp < n_tiles && key0 < w_end && key0 + TK > w_beg) {
      // S = q k^T: n8 tile j holds keys key0 + 8j + 2c + {0, 1} of rows
      // g (s[j][0..1]) and g + 8 (s[j][2..3])
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const T* qa = qst + (16 * warp + g) * KS;  // row r0 + g; + 8 KS: + 8
      if constexpr (BF16) {
        // each score a sequential FMA chain over d = 0 .. D - 1, the order
        // of the plain version's f32 GEMM: p is rounded to bf16 before pv,
        // and a tensor-core sum an f32 ulp away from the plain version's
        // flips that rounding now and then, which moves a row of few keys
        // by more than a bf16 ulp
#pragma unroll 2
        for (int d0 = 0; d0 < D; d0 += 8) {
          float q8[2][8];
          unpack8(qa + d0, q8[0]);
          unpack8(qa + 8 * KS + d0, q8[1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float k8[8];
              unpack8(kt + (8 * j + 2 * c + e) * KS + d0, k8);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                s[j][e] = fmaf(q8[0][i], k8[i], s[j][e]);
                s[j][e + 2] = fmaf(q8[1][i], k8[i], s[j][e + 2]);
              }
            }
        }
      } else {
        // A of k8 steps 2u (dims 16u + 4c, + 1) and 2u + 1 (16u + 4c + 2,
        // + 3): {a0, a1, a2, a3} = {row g, row g + 8} x the two dims; K's
        // 16-byte loads give B in the same d order
        const float* qf = reinterpret_cast<const float*>(qa);
        if (exact) {
          // one TF32 mma per k step on the raw bits; the 2 k steps of 16
          // dims go into one zero accumulator
#pragma unroll
          for (int u = 0; u < D / 16; ++u) {
            const uint4 x =
                *reinterpret_cast<const uint4*>(qf + 16 * u + 4 * c);
            const uint4 y =
                *reinterpret_cast<const uint4*>(qf + 8 * KS + 16 * u + 4 * c);
            const uint32_t a0[4] = {x.x, y.x, x.y, y.y};
            const uint32_t a1[4] = {x.z, y.z, x.w, y.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint4 kv = *reinterpret_cast<const uint4*>(
                  reinterpret_cast<const float*>(kt) + (8 * j + g) * KS +
                  16 * u + 4 * c);
              float t[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(t, a0, kv.x, kv.y);
              mma_tf32(t, a1, kv.z, kv.w);
              add4(s[j], t);
            }
          }
        } else {
#pragma unroll
        for (int u = 0; u < D / 16; ++u) {
          const float4 x = *reinterpret_cast<const float4*>(qf + 16 * u + 4 * c);
          const float4 y =
              *reinterpret_cast<const float4*>(qf + 8 * KS + 16 * u + 4 * c);
          const float f[8] = {x.x, y.x, x.y, y.y, x.z, y.z, x.w, y.w};
          uint32_t qbig[8], qsml[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) split_tf32(f[i], qbig[i], qsml[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(kt) + (8 * j + g) * KS +
                16 * u + 4 * c);
            mma_3xtf32(s[j], qbig, qsml, kv.x, kv.y);
            mma_3xtf32(s[j], qbig + 4, qsml + 4, kv.z, kv.w);
          }
        }
        }
      }
      // scale and mask, then the online softmax per row (a 4-lane quad)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * j + 2 * c + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          bool ok = !a.causal || key <= row;
          if (a.window > 0) ok = ok && key > row - a.window;
          s[j][e] = key >= Sk ? -INFINITY : ok ? s[j][e] * a.sm_scale
                                               : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          rs[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * corr[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // O += p V
      if constexpr (BF16) {
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {  // keys 16 ks .. 16 ks + 15
          const uint32_t pa[4] = {
              fp4::pack_bf16x2(s[2 * ks][0], s[2 * ks][1]),
              fp4::pack_bf16x2(s[2 * ks][2], s[2 * ks][3]),
              fp4::pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
              fp4::pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r[4];
            ldmatrix_x4_trans(
                r, vt + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * VS +
                       16 * np + ((lane >> 4) << 3));
            mma_bf16_add(o[2 * np], pa, r[0], r[1]);
            mma_bf16_add(o[2 * np + 1], pa, r[2], r[3]);
          }
        }
      } else {
        const float* vf = reinterpret_cast<const float*>(vt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // k rows c, c + 4 = keys 8j + 2c, + 1
          uint32_t pbig[4], psml[4];
          split_tf32(s[j][0], pbig[0], psml[0]);
          split_tf32(s[j][2], pbig[1], psml[1]);
          split_tf32(s[j][1], pbig[2], psml[2]);
          split_tf32(s[j][3], pbig[3], psml[3]);
          const float* v0 = vf + (8 * j + 2 * c) * VS + g;
          if (exact) {  // V's small part is 0: p_small V + p_big V
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const uint32_t b0 = __float_as_uint(v0[8 * n]);
              const uint32_t b1 = __float_as_uint(v0[VS + 8 * n]);
              float t[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32(t, psml, b0, b1);
              mma_tf32(t, pbig, b0, b1);
              add4(o[n], t);
            }
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_3xtf32(o[n], pbig, psml, v0[8 * n], v0[VS + 8 * n]);
          }
        }
      }
    }
    __syncthreads();
  }
  fp4::cp_async_wait<0>();

  if constexpr (KSPLIT == 2) {
    // group 1 hands its (m, l, O) through the free K/V stages; group 0
    // merges: M = max, each side scaled by exp(m - M)
    constexpr int NF = 4 + 4 * NT;
    float* mrg = reinterpret_cast<float*>(smem) + warp * NF * 32 + lane;
    __syncthreads();
    if (grp == 1 && live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mrg[r * 32] = m[r];
        mrg[(2 + r) * 32] = l[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mrg[(4 + 4 * n + e) * 32] = o[n][e];
    }
    __syncthreads();
    if (grp == 1 || !live) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mb = mrg[r * 32], lb = mrg[(2 + r) * 32];
      const float mx = fmaxf(m[r], mb);
      const float ca = expf(m[r] - mx), cb = expf(mb - mx);
      l[r] = l[r] * ca + lb * cb;
      m[r] = mx;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          o[n][e] = o[n][e] * ca + mrg[(4 + 4 * n + e) * 32] * cb;
    }
  }

  // out = acc / max(l, 1e-30) in q's dtype; 0 for a row that saw no valid
  // key (its running max is still NEG_INF), as K5 and K6 write for kv_len 0
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Sq) continue;
    const float den = m[r] > NEG_INF ? fmaxf(l[r], 1e-30f) : INFINITY;
    T* orow = static_cast<T*>(a.out) + ((size_t(b) * Sq + row) * a.H + h) * D +
              2 * c;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float x0 = o[n][2 * r] / den, x1 = o[n][2 * r + 1] / den;
      if constexpr (BF16)
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = fp4::pack_bf16x2(x0, x1);
      else
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
    }
  }
}

template <int D, bool BF16>
int launch_flash(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, BF16>::smem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_mma_kernel<D, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (attr != cudaSuccess) return int(attr);
  dim3 grid(a.H, B, (a.Sq + 16 * NW - 1) / (16 * NW));
  flash_mma_kernel<D, BF16>
      <<<grid, 32 * NW * Layout<D, BF16>::KSPLIT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool BF16>
int launch_d(const FlashArgs& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_flash<32, BF16>(a, B, stream);
    case 64: return launch_flash<64, BF16>(a, B, stream);
    case 96: return launch_flash<96, BF16>(a, B, stream);
    case 128: return launch_flash<128, BF16>(a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, int bf16, void* out, int B,
                                   int Sq, int Sk, int H, int KVH, int D,
                                   int causal, int window, float sm_scale,
                                   cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return int(cudaSuccess);
  FlashArgs a{q, k, v, out, Sq, Sk, H, KVH, causal, window, sm_scale};
  return bf16 ? launch_d<true>(a, B, D, stream)
              : launch_d<false>(a, B, D, stream);
}
