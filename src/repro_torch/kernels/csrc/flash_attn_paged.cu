// K5 flash_attention_paged and K6 flash_attention_packed for Hopper
// (sm_90a), one split-KV kernel body, bound with ctypes.
//
// K5 replaces repro/kernels/flash_attn.py::flash_attention_paged
// (_flash_paged_kernel, pl.pallas_call at flash_attn.py:417): attention of
// q (B, Sq, H, D) over the PAGED block-quantized KV pool of continuous
// batching.  Pools are (P, page, KVH, Dc): nvfp4 uint8 nibble pairs +
// float8_e4m3fn scales (P, page, KVH, D/block); fp8 float8_e4m3fn codes +
// bf16 scales; bf16 codes (scales ignored).  Each slot b reads its logical
// page ki from physical page page_table[b, ki] and carries its own
// (q_offset, kv_len) -- three int32 device operands, read inside the
// kernels, so the host never syncs on a length.  GQA, causal, and a sliding
// window over a ROLLING buffer (slot j holds the latest pos with pos % buf
// == j).
//
// K6 replaces flash_attn.py::flash_attention_packed (_flash_packed_kernel,
// pl.pallas_call at flash_attn.py:255): the same attention over the
// lockstep engine's CONTIGUOUS cache (B, Sk, KVH, Dc) in the nvfp4 or fp8
// layout above.  That cache is a pool of one Sk-row page per slot, so K6 is
// this body with three rules swapped (the PackedRows tag): a row's address
// is (b * Sk + key) * KVH + kvh, one device int32 pair (q_offset, kv_len)
// serves every slot, and the window runs over linear positions (kpos = the
// row index, as the TPU kernel's _tile_mask), so a block starts at its
// window's first key and stops at its causal frontier.  Where the host
// passes rolling = 1 (the lockstep cache of a sliding-window model, written
// at row pos % Sk) K6 takes K5's rolling rule instead: every row below
// kv_len is read, and row j holds the latest position with pos % Sk == j,
// relative to the last query row -- the reference's _attn_decode_packed
// over swa_kpos.
//
// What bounds them on an H100: bytes, and in practice latency.  At
// continuous-batching decode (8 slots, one query row, 256 cached tokens of
// llama2-7b, nvfp4) a K5 call reads 9.4 MB of packed K/V (2.9 us at 3.35
// TB/s) and does 0.07 GFLOP; a lockstep K6 decode (4 x 32 heads over ~80
// tokens) reads 1.5 MB.  The cache is streamed at its packed width and
// never gathered or dequantized into device memory.
//
// What the design does about it (flash-decoding on f32 CUDA cores: the
// reference keeps p in f32, and fp8 x bf16 is not exact in bf16):
//   * split-KV (K5): each slot's logical key range (n_pages * page_size, a
//     static shape) is cut into fixed splits (flash_attn.py: k5_plan).  A
//     block owns (split, kv head, a group of query vectors, slot) and
//     writes its (m, l, acc) partial; a combine launch merges the splits in
//     split order -- no atomics.  Blocks past a slot's kv_len, or past the
//     causal frontier of their rows, exit at once and the combine skips
//     them, so the split count never depends on a length.  Where the plan
//     gives one split, the split kernel writes out itself and no combine is
//     launched.  K6 always runs one split of all Sk keys (flash_attn.py:
//     k6_plan): at the lockstep decode B * KVH blocks already cover the SMs
//     and the combine alone costs more than the kernel's byte bound, and no
//     workload has a cache long enough to measure where splitting it pays;
//   * a block serves up to 8 query vectors -- the G heads of the group
//     times the rows of verify (Sq 4) or chunked prefill (Sq 64) -- from
//     one read of each K/V tile;
//   * a tile is 128 keys, one per lane of the 4 warps, so every warp works
//     when G = 1: a lane scores its own key against every query vector
//     (the row's code bytes in 16-byte shared-memory loads, each value
//     decoded once, q broadcast from shared memory), the warp runs the
//     online softmax over its 32 keys at once, and acc += p V runs with
//     each lane on D/32 dims; the 4 warps' partials merge at the end;
//   * the tile's K/V rows (64 code bytes + 8 scale bytes per nvfp4 row and
//     head) arrive by cp.async in 16-byte (codes) and 4-byte (scales)
//     copies, a ring of 2 tiles where a split has more than one, into rows
//     padded so that the rows a warp reads at once sit in different banks;
//     values are decoded through E2M1 and E4M3 tables in shared memory
//     (code x scale, exact in f32);
//   * the reference's rules: a K5 page runs only below kv_len (and, for a
//     linear cache under the causal mask, at or before the rows' last
//     position), so exactly the reference's pages are read; masked scores
//     are NEG_INF = -1e30 (not -inf) and l is clamped at 1e-30, so a slot
//     with kv_len == 0 (or, in K6, no key in its window) writes 0; rolling
//     kpos = last - (((last % buf - j) % buf + buf) % buf): Python's floor
//     modulo written out for C's %.
#include <climits>

#include "fp4_common.cuh"

namespace {

constexpr int NWARP = 4;         // warps per block
constexpr int TK = 32 * NWARP;   // keys per tile: one per lane
constexpr float NEG_INF = -1e30f;

enum PoolFmt { kNvfp4 = 0, kFp8 = 1, kBf16 = 2 };

// How a slot's rows, its (q_offset, kv_len) and the window are read: K5's
// page table, per-slot vectors and rolling buffer, or K6's contiguous cache
// (one page of psz = Sk rows per slot, no page table), one pair for every
// slot and a window over linear positions.
struct PagedRows {
  static constexpr bool kPaged = true;
};
struct PackedRows {
  static constexpr bool kPaged = false;
};

struct PagedArgs {
  const void* q;
  const uint8_t* kc;
  const uint8_t* ks;
  const uint8_t* vc;
  const uint8_t* vs;
  const int* page_table;  // PackedRows: unused
  const int* lengths;     // PackedRows: &pos[1], read for every slot
  const int* q_offsets;   // PackedRows: &pos[0]
  float* ws_ml;   // (B, Sq, H, n_splits, 2): m, l of each split (K5)
  float* ws_acc;  // (B, Sq, H, n_splits, D)
  void* out;
  int q_bf16, Sq, H, KVH, D, psz, n_pages, fmt, block, causal, window;
  int rolling;  // the window runs over a rolling buffer (K5: window > 0)
  int cb, sb;  // code and scale bytes of one row of one head (sb 0: bf16)
  int cstride, sstride;  // their row strides in shared memory
  float sm_scale;
  int qv, keys_per_split, n_splits;  // the split plan
  int stages;                        // ring stages: 2 where a split has >1 tile
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  return ((x % m) + m) % m;
}

__device__ __forceinline__ float bf16_bits(uint32_t u) {
  return __uint_as_float(u << 16);
}

// Keys [0, kproc) of slot b that a group of query vectors whose last row is
// last_row reads.  K5: the reference's pages (ki * psz < kv_len, and ki *
// psz <= that row's position for a linear cache under the causal mask),
// whole.  K6: the keys below kv_len and, for a linear cache, the causal
// frontier.
template <class Rows>
__device__ __forceinline__ int block_kproc(const PagedArgs& p, int b,
                                           int last_row) {
  const int sl = Rows::kPaged ? b : 0;
  const int buf = p.n_pages * p.psz;
  int kend = min(max(p.lengths[sl], 0), buf);
  if (p.causal && !p.rolling)
    kend = min(kend, max(p.q_offsets[sl] + last_row + 1, 0));
  return Rows::kPaged ? (kend + p.psz - 1) / p.psz * p.psz : kend;
}

// The first key a group of query vectors whose first row is first_row
// reads: K6's window over linear positions starts there; K5 and a rolling
// K6 start at 0 (a rolling buffer holds any position in any row).
template <class Rows>
__device__ __forceinline__ int block_kbeg(const PagedArgs& p, int first_row) {
  if (Rows::kPaged || p.window <= 0 || p.rolling) return 0;
  return max(0, p.q_offsets[0] + first_row - p.window + 1);
}

// out[row, head, :] of query vector i (in the group of kv head kvh) of
// slot b
__device__ __forceinline__ size_t out_index(const PagedArgs& p, int b,
                                            int kvh, int i) {
  const int G = p.H / p.KVH;
  return ((size_t(b) * p.Sq + i / G) * p.H + kvh * G + i % G) * p.D;
}

__device__ __forceinline__ void store_out(const PagedArgs& p, size_t oi,
                                          float v) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.out)[oi] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.out)[oi] = v;
}

// This lane's DL dims d0 .. d0 + DL - 1 of one cached row, dequantized
// through the E2M1 (16) and E4M3 (256) tables: code x scale, exact in f32.
template <int DL>
__device__ __forceinline__ void decode_row(
    int fmt, const uint8_t* __restrict__ codes,
    const uint8_t* __restrict__ scales, int d0, const int (&sidx)[DL],
    bool one_scale, const float* __restrict__ lut16,
    const float* __restrict__ lut8, float (&v)[DL]) {
  if (fmt == kNvfp4) {
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = d0 + i;
      const uint32_t byte = codes[d >> 1];
      v[i] = lut16[(d & 1) ? byte >> 4 : byte & 0xFu];
    }
    if (one_scale) {
      const float s = lut8[scales[sidx[0]]];
#pragma unroll
      for (int i = 0; i < DL; ++i) v[i] *= s;
    } else {
#pragma unroll
      for (int i = 0; i < DL; ++i) v[i] *= lut8[scales[sidx[i]]];
    }
  } else if (fmt == kFp8) {
    const float s0 = bf16_bits(scales[2 * sidx[0]] |
                               (uint32_t(scales[2 * sidx[0] + 1]) << 8));
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const float s = one_scale ? s0
                                : bf16_bits(scales[2 * sidx[i]] |
                                            (uint32_t(scales[2 * sidx[i] + 1])
                                             << 8));
      v[i] = lut8[codes[d0 + i]] * s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < DL; ++i)
      v[i] = bf16_bits(codes[2 * (d0 + i)] |
                       (uint32_t(codes[2 * (d0 + i) + 1]) << 8));
  }
}

// Dynamic shared memory of kv_split_kernel<Rows, DL, QM>.
static size_t split_smem(int DL, int QM, const PagedArgs& p) {
  const int D = 32 * DL;
  return sizeof(float) * (16 + 256 + QM * D + NWARP * QM * (D + 2)) +
         size_t(p.stages) * 2 * TK * (p.cstride + p.sstride) +
         sizeof(int) * (p.keys_per_split / p.psz + 2);
}

// This lane's score contributions q . k for its own key's row: the code
// bytes in 16-byte loads, each value decoded (code x scale, exact in f32)
// once and multiplied into every query vector.
template <int QM, int D>
__device__ __forceinline__ void score_row(
    int fmt, int cb, int block, const uint8_t* __restrict__ crow,
    const uint8_t* __restrict__ srow, const float* __restrict__ qs, int nq,
    const float* __restrict__ lut16, const float* __restrict__ lut8,
    float (&s)[QM]) {
  int next = fmt == kBf16 ? INT_MAX : block, sidx = 0;  // bf16: no scales
  auto scale_at = [&](int i) {
    return fmt == kNvfp4 ? lut8[srow[i]]
                         : bf16_bits(srow[2 * i] |
                                     (uint32_t(srow[2 * i + 1]) << 8));
  };
  float sc = fmt == kBf16 ? 1.0f : scale_at(0);
  float s2[QM];  // odd dims: two accumulation chains instead of one
#pragma unroll
  for (int j = 0; j < QM; ++j) s2[j] = 0.f;
  auto dot = [&](int d, float k, float(&acc)[QM]) {
    if (d == next) {  // the same d on every lane: uniform
      ++sidx;
      next += block;
      sc = scale_at(sidx);
    }
    const float kv = k * sc;
#pragma unroll
    for (int j = 0; j < QM; ++j)
      if (j < nq) acc[j] = fmaf(qs[j * D + d], kv, acc[j]);
  };
  for (int u = 0; u < cb / 16; ++u) {
    union {
      uint4 v;
      uint8_t b[16];
    } raw;
    raw.v = *reinterpret_cast<const uint4*>(crow + 16 * u);
    if (fmt == kNvfp4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dot(32 * u + 2 * i, lut16[raw.b[i] & 0xF], s);
        dot(32 * u + 2 * i + 1, lut16[raw.b[i] >> 4], s2);
      }
    } else if (fmt == kFp8) {
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        dot(16 * u + i, lut8[raw.b[i]], s);
        dot(16 * u + i + 1, lut8[raw.b[i + 1]], s2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        dot(8 * u + i, bf16_bits(raw.b[2 * i] |
                                 (uint32_t(raw.b[2 * i + 1]) << 8)), s);
        dot(8 * u + i + 1, bf16_bits(raw.b[2 * i + 2] |
                                     (uint32_t(raw.b[2 * i + 3]) << 8)), s2);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < QM; ++j) s[j] += s2[j];
}

// grid (n_splits, n_qblocks * KVH, B), NWARP * 32 threads.  QM: query
// vectors a block holds (>= p.qv).  Dynamic shared memory: E2M1 and E4M3
// tables | q [QM][D] | per-warp partials [NWARP][QM][D + 2] | p.stages
// ring stages of K codes, V codes, K scales, V scales (TK rows each) | the
// physical first row of each page of the split (K5).  With one split the
// block writes out (acc / max(l, 1e-30), in q's dtype) itself.
template <class Rows, int DL, int QM>
__global__ void __launch_bounds__(NWARP * 32, QM == 1 ? 4 : 2)
kv_split_kernel(const PagedArgs p) {
  constexpr int D = 32 * DL;
  extern __shared__ __align__(16) uint8_t smem[];
  float* lut16 = reinterpret_cast<float*>(smem);
  float* lut8 = lut16 + 16;
  float* qs = lut8 + 256;
  float* mrg = qs + QM * D;
  uint8_t* ring = reinterpret_cast<uint8_t*>(mrg + NWARP * QM * (D + 2));
  const int stage_bytes = 2 * TK * (p.cstride + p.sstride);
  int* prow = reinterpret_cast<int*>(ring + p.stages * stage_bytes);

  const int split = blockIdx.x, kvh = blockIdx.y % p.KVH;
  const int qb = blockIdx.y / p.KVH, b = blockIdx.z;
  const int G = p.H / p.KVH, nqv = p.Sq * G;
  const int i0 = qb * p.qv, nq = min(p.qv, nqv - i0);
  const int k_lo = split * p.keys_per_split;
  const int buf = p.n_pages * p.psz;
  const int page0 = k_lo / p.psz;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pt = p.page_table + size_t(b) * p.n_pages;
  // the split's page rows, loaded beside the lengths (a split never
  // reaches past the slot buffer)
  const int k_top = min(k_lo + p.keys_per_split, buf);
  if (Rows::kPaged)
    for (int i = tid; page0 + i <= (k_top - 1) / p.psz; i += NWARP * 32)
      prow[i] = pt[page0 + i] * p.psz;
  const int kproc = block_kproc<Rows>(p, b, (i0 + nq - 1) / G);
  const int k_from = max(k_lo, block_kbeg<Rows>(p, i0 / G));
  const int k_hi = min(k_lo + p.keys_per_split, kproc);
  if (k_from >= k_hi) {  // no key: the combine skips this split
    if (p.n_splits == 1)
      for (int e = tid; e < nq * D; e += NWARP * 32)
        store_out(p, out_index(p, b, kvh, i0 + e / D) + e % D, 0.f);
    return;
  }

  if (tid < 16) lut16[tid] = fp4::decode_e2m1(tid);
  for (int i = tid; i < 256; i += NWARP * 32) lut8[i] = fp4::decode_e4m3(i);
  for (int e = tid; e < nq * D; e += NWARP * 32) {
    const int j = e / D, d = e % D, i = i0 + j;
    const size_t qi = ((size_t(b) * p.Sq + i / G) * p.H + kvh * G + i % G) * D + d;
    qs[e] = p.q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(p.q)[qi])
                     : static_cast<const float*>(p.q)[qi];
  }
  const int slot = Rows::kPaged ? b : 0;  // whose (q_offset, kv_len)
  const int q_off = p.q_offsets[slot];
  const int kv_len = min(max(p.lengths[slot], 0), buf);
  const int last = q_off + p.Sq - 1;  // rolling kpos reference row
  const int last_mod = floor_mod(last, buf);

  // PV: this lane's dims d0 .. d0 + DL - 1 of each query vector
  const int d0 = lane * DL;
  int sidx[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) sidx[i] = (d0 + i) / p.block;
  const bool one_scale = p.block % DL == 0;
  float acc[QM][DL], m[QM], l[QM];
  int qpos[QM];
#pragma unroll
  for (int j = 0; j < QM; ++j) {
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[j][e] = 0.f;
    qpos[j] = q_off + (i0 + min(j, nq - 1)) / G;
    m[j] = NEG_INF;
    l[j] = 0.f;
  }
  __syncthreads();  // page rows, tables, q

  // ring stage `st` <- the K and V rows of keys t0 .. t0 + TK - 1 (< k_hi):
  // per warp step, groups of lanes each copy one key's 16-byte code chunks
  // (K then V), then one key's 4-byte scale words (or bytes)
  const int cpr = p.cb / 16;
  const bool words = p.sb % 4 == 0;
  const int spr = words ? p.sb / 4 : p.sb;
  const int ck = max(1, 32 / (2 * cpr)), cl = lane / (2 * cpr);
  const int sk = spr ? max(1, 32 / (2 * spr)) : 1, sl = spr ? lane / (2 * spr) : 0;
  auto row_of = [&](int key) {
    return Rows::kPaged
               ? (size_t(prow[key / p.psz - page0]) + key % p.psz) * p.KVH + kvh
               : (size_t(b) * p.psz + key) * p.KVH + kvh;
  };
  auto fetch = [&](int t0, int st) {
    uint8_t* kcs = ring + st * stage_bytes;
    uint8_t* vcs = kcs + TK * p.cstride;
    uint8_t* kss = vcs + TK * p.cstride;
    uint8_t* vss = kss + TK * p.sstride;
    const int nkeys = min(TK, k_hi - t0);
    for (int j0 = warp * ck; j0 < nkeys; j0 += NWARP * ck) {
      const int j = j0 + cl;
      if (cl >= ck || j >= nkeys) continue;
      const size_t hrow = row_of(t0 + j);
      for (int c = lane % (2 * cpr); c < 2 * cpr; c += 32) {
        const bool v = c >= cpr;
        const int u = v ? c - cpr : c;
        fp4::cp_async16((v ? vcs : kcs) + j * p.cstride + 16 * u,
                        (v ? p.vc : p.kc) + hrow * p.cb + 16 * u);
      }
    }
    if (!spr) return;
    for (int j0 = warp * sk; j0 < nkeys; j0 += NWARP * sk) {
      const int j = j0 + sl;
      if (sl >= sk || j >= nkeys) continue;
      const size_t hrow = row_of(t0 + j);
      for (int c = lane % (2 * spr); c < 2 * spr; c += 32) {
        const bool v = c >= spr;
        const int u = v ? c - spr : c;
        uint8_t* dst = (v ? vss : kss) + j * p.sstride;
        const uint8_t* src = (v ? p.vs : p.ks) + hrow * p.sb;
        if (words)
          fp4::cp_async4(dst + 4 * u, src + 4 * u);
        else
          dst[u] = src[u];
      }
    }
  };

  const int nt = (k_hi - k_from + TK - 1) / TK;
  fetch(k_from, 0);
  fp4::cp_async_commit();
  for (int t = 0; t < nt; ++t) {
    const int t0 = k_from + t * TK, st = t % p.stages;
    if (p.stages == 2) {
      if (t + 1 < nt) fetch(t0 + TK, st ^ 1);
      fp4::cp_async_commit();
      fp4::cp_async_wait<1>();
    } else {
      fp4::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* kcs = ring + st * stage_bytes;
    const uint8_t* vcs = kcs + TK * p.cstride;
    const uint8_t* kss = vcs + TK * p.cstride;
    const uint8_t* vss = kss + TK * p.sstride;

    // scores: lane j of warp w scores key t0 + 32w + j for every query
    const int jw = 32 * warp, j = jw + lane, key = t0 + j;
    const bool proc = key < k_hi;
    float s[QM];
#pragma unroll
    for (int jq = 0; jq < QM; ++jq) s[jq] = 0.f;
    if (proc)
      score_row<QM, D>(p.fmt, p.cb, p.block, kcs + j * p.cstride,
                       kss + j * p.sstride, qs, nq, lut16, lut8, s);
    const int kpos =
        p.rolling ? last - floor_mod(last_mod - key, buf) : key;
    const bool key_ok = key < kv_len && kpos >= 0;
    float pr[QM];
#pragma unroll
    for (int jq = 0; jq < QM; ++jq) {
      if (jq >= nq) break;
      bool ok = key_ok;
      if (p.causal) ok = ok && kpos <= qpos[jq];
      if (p.window > 0) ok = ok && kpos > qpos[jq] - p.window;
      const float sj = ok ? s[jq] * p.sm_scale : NEG_INF;
      // the warp's 32 keys at once: unread keys take no part
      const float mx = fmaxf(m[jq], warp_max(proc ? sj : -INFINITY));
      const float corr = expf(m[jq] - mx);
      pr[jq] = proc ? expf(sj - mx) : 0.f;
      l[jq] = l[jq] * corr + warp_sum(pr[jq]);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[jq][e] *= corr;
      m[jq] = mx;
    }
    // acc += p V over the warp's keys, lane by lane of dims
    const int nj = min(32, k_hi - (t0 + jw));
#pragma unroll 4  // 4 keys' table loads in flight, not one
    for (int jj = 0; jj < nj; ++jj) {
      float vr[DL];
      decode_row<DL>(p.fmt, vcs + (jw + jj) * p.cstride,
                     vss + (jw + jj) * p.sstride, d0, sidx, one_scale, lut16,
                     lut8, vr);
#pragma unroll
      for (int jq = 0; jq < QM; ++jq) {
        if (jq >= nq) break;
        const float pj = __shfl_sync(0xffffffffu, pr[jq], jj);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[jq][e] = fmaf(pj, vr[e], acc[jq][e]);
      }
    }
    __syncthreads();
    if (p.stages == 1 && t + 1 < nt) {
      fetch(t0 + TK, 0);
      fp4::cp_async_commit();
    }
  }
  fp4::cp_async_wait<0>();

  // merge the 4 warps' partials (in warp order) into the split's partial
#pragma unroll
  for (int jq = 0; jq < QM; ++jq) {
    if (jq >= nq) break;
    float* r = mrg + (warp * QM + jq) * (D + 2);
#pragma unroll
    for (int e = 0; e < DL; ++e) r[d0 + e] = acc[jq][e];
    if (lane == 0) {
      r[D] = m[jq];
      r[D + 1] = l[jq];
    }
  }
  __syncthreads();
  for (int e = tid; e < nq * D; e += NWARP * 32) {
    const int jq = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w)
      mx = fmaxf(mx, mrg[(w * QM + jq) * (D + 2) + D]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float* r = mrg + (w * QM + jq) * (D + 2);
      const float wgt = expf(r[D] - mx);
      ls += wgt * r[D + 1];
      as += wgt * r[d];
    }
    const size_t oi = out_index(p, b, kvh, i0 + jq);
    if (p.n_splits == 1) {
      store_out(p, oi + d, as / fmaxf(ls, 1e-30f));
      continue;
    }
    const size_t o = oi / D * p.n_splits + split;
    p.ws_acc[o * D + d] = as;
    if (d == 0) {
      p.ws_ml[2 * o] = mx;
      p.ws_ml[2 * o + 1] = ls;
    }
  }
}

// One warp per (slot, row, head): merge the splits that ran, in a fixed
// order, and write out = acc / max(l, 1e-30) in q's dtype (0 where none
// ran).  Lanes share the splits for m and l, then each lane owns D/32 dims.
template <class Rows>
__global__ void __launch_bounds__(128) kv_combine_kernel(const PagedArgs p,
                                                         int total) {
  const int gw = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (gw >= total) return;
  const int h = gw % p.H, row = (gw / p.H) % p.Sq, b = gw / (p.H * p.Sq);
  const int G = p.H / p.KVH, i = row * G + h % G;
  const int i0 = i / p.qv * p.qv, nq = min(p.qv, p.Sq * G - i0);
  const int kproc = block_kproc<Rows>(p, b, (i0 + nq - 1) / G);
  const int kbeg = block_kbeg<Rows>(p, i0 / G);
  // the splits whose keys [s kps, (s + 1) kps) meet [kbeg, kproc)
  const int s0 = kbeg < kproc ? kbeg / p.keys_per_split : 0;
  const int n_act =
      kbeg < kproc ? min(p.n_splits, (kproc + p.keys_per_split - 1) /
                                         p.keys_per_split)
                   : 0;
  const float* ml = p.ws_ml + 2 * size_t(gw) * p.n_splits;
  const float* accs = p.ws_acc + size_t(gw) * p.n_splits * p.D;
  float mx = NEG_INF, ls = 0.f;
  for (int s = s0 + lane; s < n_act; s += 32) mx = fmaxf(mx, ml[2 * s]);
  mx = warp_max(mx);
  for (int s = s0 + lane; s < n_act; s += 32)
    ls += expf(ml[2 * s] - mx) * ml[2 * s + 1];
  ls = warp_sum(ls);
  const float den = fmaxf(ls, 1e-30f);
  for (int d = lane; d < p.D; d += 32) {
    float as = 0.f;
#pragma unroll 4
    for (int s = s0; s < n_act; ++s)
      as += expf(ml[2 * s] - mx) * accs[size_t(s) * p.D + d];
    store_out(p, size_t(gw) * p.D + d, as / den);
  }
}

template <class Rows, int DL, int QM>
int launch_split(const PagedArgs& p, int B, cudaStream_t stream) {
  const size_t smem = split_smem(DL, QM, p);
  const cudaError_t attr = cudaFuncSetAttribute(
      kv_split_kernel<Rows, DL, QM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  const int G = p.H / p.KVH;
  const int n_qblocks = (p.Sq * G + p.qv - 1) / p.qv;
  dim3 grid(p.n_splits, n_qblocks * p.KVH, B);
  kv_split_kernel<Rows, DL, QM><<<grid, NWARP * 32, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// QM = 1 where a block holds one query vector (decode without GQA), else
// the most this head size allows: min(8, 32 / DL), as flash_attn.py: k5_qmax.
template <class Rows, int DL>
int launch_dl(const PagedArgs& p, int B, cudaStream_t stream) {
  constexpr int QMAX = (32 / DL) < 8 ? 32 / DL : 8;
  if (p.qv > QMAX) return int(cudaErrorInvalidValue);
  return p.qv == 1 ? launch_split<Rows, DL, 1>(p, B, stream)
                   : launch_split<Rows, DL, QMAX>(p, B, stream);
}

// The split launch, then (K5) the combine where the plan has more than one
// split.
template <class Rows>
int launch_kv(PagedArgs& p, int B, int nb, cudaStream_t stream) {
  const int D = p.D, fmt = p.fmt;
  p.cb = fmt == kNvfp4 ? D / 2 : (fmt == kFp8 ? D : 2 * D);
  p.sb = fmt == kNvfp4 ? nb : (fmt == kFp8 ? 2 * nb : 0);
  // shared-memory row strides that put the rows a warp reads at once in
  // different banks: an odd number of 16-byte units (codes), of words
  // (scales)
  p.cstride = p.cb + ((p.cb / 16) % 2 == 0 ? 16 : 32);
  const int sw = (p.sb + 3) / 4;
  p.sstride = p.sb ? 4 * (sw % 2 ? sw : sw + 1) : 0;
  p.stages = p.keys_per_split > TK ? 2 : 1;
  int err;
  switch (D / 32) {
    case 1: err = launch_dl<Rows, 1>(p, B, stream); break;
    case 2: err = launch_dl<Rows, 2>(p, B, stream); break;
    case 3: err = launch_dl<Rows, 3>(p, B, stream); break;
    case 4: err = launch_dl<Rows, 4>(p, B, stream); break;
    case 5: err = launch_dl<Rows, 5>(p, B, stream); break;
    case 6: err = launch_dl<Rows, 6>(p, B, stream); break;
    case 7: err = launch_dl<Rows, 7>(p, B, stream); break;
    case 8: err = launch_dl<Rows, 8>(p, B, stream); break;
    default: return int(cudaErrorInvalidValue);
  }
  if constexpr (Rows::kPaged) {  // K6 runs one split: no combine
    if (err != 0 || p.n_splits == 1) return err;
    const int total = B * p.Sq * p.H;
    kv_combine_kernel<Rows><<<(total + 3) / 4, 128, 0, stream>>>(p, total);
    return int(cudaGetLastError());
  }
  return err;
}

}  // namespace

// K5.  ws_ml (B, Sq, H, n_splits, 2) and ws_acc (B, Sq, H, n_splits, D) f32
// workspaces (unused with one split); qv query vectors per block,
// keys_per_split (a multiple of 32) and n_splits from k5_plan.  D % 32 ==
// 0, D <= 256.
extern "C" int flash_attention_paged_fwd(
    const void* q, int q_bf16, const uint8_t* k_codes,
    const uint8_t* k_scales, const uint8_t* v_codes, const uint8_t* v_scales,
    const int* page_table, const int* lengths, const int* q_offsets,
    void* out, float* ws_ml, float* ws_acc, int B, int Sq, int H, int KVH,
    int D, int page_size, int n_pages, int nb, int fmt, int block,
    int causal, int window, float sm_scale, int qv, int keys_per_split,
    int n_splits, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return int(cudaSuccess);
  PagedArgs p{q, k_codes, k_scales, v_codes, v_scales, page_table, lengths,
              q_offsets, ws_ml, ws_acc, out};
  p.q_bf16 = q_bf16;
  p.Sq = Sq;
  p.H = H;
  p.KVH = KVH;
  p.D = D;
  p.psz = page_size;
  p.n_pages = n_pages;
  p.fmt = fmt;
  p.block = block;
  p.causal = causal;
  p.window = window;
  p.rolling = window > 0;
  p.sm_scale = sm_scale;
  p.qv = qv;
  p.keys_per_split = keys_per_split;
  p.n_splits = n_splits;
  return launch_kv<PagedRows>(p, B, nb, stream);
}

// K6 over the contiguous cache (B, Sk, KVH, Dc): pos the int32 pair
// (q_offset, kv_len) on the device; fmt kNvfp4 or kFp8; rolling 1 for a
// sliding-window buffer written at row pos % Sk (needs window > 0); qv
// query vectors per block and keys_per_split (Sk rounded up to whole tiles:
// one split, written to out directly) from k6_plan.
extern "C" int flash_attention_packed_fwd(
    const void* q, int q_bf16, const uint8_t* k_codes,
    const uint8_t* k_scales, const uint8_t* v_codes, const uint8_t* v_scales,
    const int* pos, void* out, int B, int Sq, int H, int KVH, int D, int Sk,
    int nb, int fmt, int block, int causal, int window, int rolling,
    float sm_scale, int qv, int keys_per_split, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return int(cudaSuccess);
  if (fmt == kBf16 || keys_per_split < Sk || (rolling && window <= 0))
    return int(cudaErrorInvalidValue);
  PagedArgs p{q, k_codes, k_scales, v_codes, v_scales, nullptr, pos + 1,
              pos, nullptr, nullptr, out};
  p.q_bf16 = q_bf16;
  p.Sq = Sq;
  p.H = H;
  p.KVH = KVH;
  p.D = D;
  p.psz = Sk;
  p.n_pages = 1;
  p.fmt = fmt;
  p.block = block;
  p.causal = causal;
  p.window = window;
  p.rolling = rolling;
  p.sm_scale = sm_scale;
  p.qv = qv;
  p.keys_per_split = keys_per_split;
  p.n_splits = 1;
  return launch_kv<PackedRows>(p, B, nb, stream);
}
