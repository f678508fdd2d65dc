// K5 flash_attention_paged for Hopper (sm_90a), bound with ctypes.
//
// Replaces repro/kernels/flash_attn.py::flash_attention_paged
// (_flash_paged_kernel, pl.pallas_call at flash_attn.py:417): attention of
// q (B, Sq, H, D) over the PAGED block-quantized KV pool of continuous
// batching.  Pools are (P, page, KVH, Dc): nvfp4 uint8 nibble pairs +
// float8_e4m3fn scales (P, page, KVH, D/block); fp8 float8_e4m3fn codes +
// bf16 scales; bf16 codes (scales ignored).  Each slot b reads its logical
// page ki from physical page page_table[b, ki] and carries its own
// (q_offset, kv_len) -- three int32 device operands, read inside the kernel,
// so the host never syncs on a length.  GQA, causal, and a sliding window
// over a ROLLING buffer (slot j holds the latest pos with pos % buf == j).
//
// What bounds it on an H100: at continuous-batching decode (8 slots, one
// query row, <= 512 cached tokens of llama2-7b) one call reads ~2.4 MB of
// packed K/V at most and does ~0.1 GFLOP: microseconds of bytes, so in
// practice latency (the serial page loop of one block) bounds it.  The pool
// is streamed at its packed width (0.5625 B/elem for nvfp4) and never
// gathered into a contiguous or dequantized buffer in device memory.
//
// Design, simple and right first (K6's, with a page-table indirection):
//   * one block per (query row, kv head, slot) serves all G query heads of
//     the group, so every K/V tile is read and dequantized once for the
//     group;
//   * a tile is 32 consecutive logical keys (one per lane); each key's
//     physical row comes from the page table (page = key / page_size), is
//     dequantized (nibble x E4M3 byte, or fp8 x bf16, or bf16) into shared
//     memory in f32, and one warp per query head runs the f32 online softmax;
//   * the loop stops at kv_len and, for a linear cache under the causal
//     mask, at the row's causal frontier: a skipped key contributes exactly
//     0 once a valid key has been seen, which is what the TPU kernel's page
//     skip gives too; a slot with kv_len == 0 runs no tile and writes 0;
//   * rolling kpos = last - (((last % buf - j) % buf + buf) % buf): Python's
//     floor modulo written out for C's truncating %;
//   * masked scores are NEG_INF = -1e30 (not -inf) and l is clamped at
//     1e-30, as in the TPU kernel, so empty rows stay finite;
//   * f32 CUDA-core dots; no tensor cores or TMA yet.
#include "fp4_common.cuh"

namespace {

constexpr int TK = 32;          // logical keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr int NWARP = 4;

enum PoolFmt { kNvfp4 = 0, kFp8 = 1, kBf16 = 2 };

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float load_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_f(void* p, size_t i, float v,
                                        int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  return ((x % m) + m) % m;
}

// grid (Sq, KVH, B), NWARP*32 threads.  Dynamic shared memory (floats):
// qs[G][D] | acc[G][D] | ml[2G] | kt[TK][D+1] | vt[TK][D] | rows[TK] (int)
__global__ void flash_paged_kernel(
    const void* __restrict__ q, int q_bf16, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ ks, const uint8_t* __restrict__ vc,
    const uint8_t* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const int* __restrict__ q_offsets,
    void* __restrict__ out, int Sq, int H, int KVH, int D, int psz,
    int n_pages, int nb, int fmt, int block, int causal, int window,
    float sm_scale) {
  extern __shared__ float smem[];
  const int qi = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  float* qs = smem;
  float* acc = qs + G * D;
  float* ms = acc + G * D;
  float* ls = ms + G;
  float* kt = ls + G;
  float* vt = kt + TK * (D + 1);
  int* rows = reinterpret_cast<int*>(vt + TK * D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;

  const int buf = n_pages * psz;
  const int q_offset = q_offsets[b];
  const int kv_len = min(max(lengths[b], 0), buf);
  const int qpos = q_offset + qi;
  const int last = q_offset + Sq - 1;          // rolling kpos reference row
  const int* pt_row = page_table + size_t(b) * n_pages;
  for (int i = tid; i < G * D; i += nthr) {
    int g = i / D, d = i % D;
    size_t qidx = ((size_t(b) * Sq + qi) * H + kvh * G + g) * D + d;
    qs[i] = load_f(q, qidx, q_bf16);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nthr) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  int kend = kv_len;
  if (causal && window <= 0) kend = min(kend, max(qpos + 1, 0));
  const int Dc = (fmt == kNvfp4) ? D / 2 : D;
  const int last_mod = floor_mod(last, buf);
  __syncthreads();

  for (int t0 = 0; t0 < kend; t0 += TK) {
    // physical row (page * psz + offset) of each of the tile's keys
    if (tid < TK) {
      int key = t0 + tid;
      rows[tid] = key < buf ? pt_row[key / psz] * psz + key % psz : -1;
    }
    __syncthreads();
    // dequantize the K and V tiles into shared memory (f32)
    for (int i = tid; i < TK * Dc; i += nthr) {
      int j = i / Dc, c = i % Dc;
      int r = rows[j];
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (r >= 0) {
        size_t row = size_t(r) * KVH + kvh;
        if (fmt == kNvfp4) {
          uint32_t kb = kc[row * Dc + c], vb = vc[row * Dc + c];
          int d = 2 * c;                      // low nibble = column 2c
          float ksc = fp4::decode_e4m3(ks[row * nb + d / block]);
          float vsc = fp4::decode_e4m3(vs[row * nb + d / block]);
          k0 = fp4::decode_e2m1(kb & 0xFu) * ksc;
          k1 = fp4::decode_e2m1(kb >> 4) * ksc;
          v0 = fp4::decode_e2m1(vb & 0xFu) * vsc;
          v1 = fp4::decode_e2m1(vb >> 4) * vsc;
        } else if (fmt == kFp8) {
          const __nv_bfloat16* ksb =
              reinterpret_cast<const __nv_bfloat16*>(ks);
          const __nv_bfloat16* vsb =
              reinterpret_cast<const __nv_bfloat16*>(vs);
          k0 = fp4::decode_e4m3(kc[row * Dc + c]) *
               __bfloat162float(ksb[row * nb + c / block]);
          v0 = fp4::decode_e4m3(vc[row * Dc + c]) *
               __bfloat162float(vsb[row * nb + c / block]);
        } else {
          k0 = __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(kc)[row * Dc + c]);
          v0 = __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(vc)[row * Dc + c]);
        }
      }
      if (fmt == kNvfp4) {
        kt[j * (D + 1) + 2 * c] = k0;
        kt[j * (D + 1) + 2 * c + 1] = k1;
        vt[j * D + 2 * c] = v0;
        vt[j * D + 2 * c + 1] = v1;
      } else {
        kt[j * (D + 1) + c] = k0;
        vt[j * D + c] = v0;
      }
    }
    __syncthreads();
    const int j = t0 + lane;                     // logical slot of this lane
    const int kpos = (window > 0) ? last - floor_mod(last_mod - j, buf) : j;
    bool valid = j < kv_len && kpos >= 0;
    if (causal) valid = valid && kpos <= qpos;
    if (window > 0) valid = valid && kpos > qpos - window;
    for (int g = warp; g < G; g += NWARP) {
      float s = 0.f;
      const float* qg = qs + g * D;
      const float* kr = kt + lane * (D + 1);
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
      s = valid ? s * sm_scale : NEG_INF;
      const float m_prev = ms[g], l_prev = ls[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float corr = expf(m_prev - m_new);
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      float* ag = acc + g * D;
      for (int d = lane; d < D; d += 32) {
        float pv = 0.f;
        for (int jj = 0; jj < TK; ++jj)
          pv = fmaf(__shfl_sync(0xffffffffu, p, jj), vt[jj * D + d], pv);
        ag[d] = ag[d] * corr + pv;
      }
      __syncwarp();
      if (lane == 0) {
        ms[g] = m_new;
        ls[g] = l_prev * corr + psum;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += nthr) {
    int g = i / D, d = i % D;
    size_t oidx = ((size_t(b) * Sq + qi) * H + kvh * G + g) * D + d;
    store_f(out, oidx, acc[i] / fmaxf(ls[g], 1e-30f), q_bf16);
  }
}

}  // namespace

extern "C" int flash_attention_paged_fwd(
    const void* q, int q_bf16, const uint8_t* k_codes,
    const uint8_t* k_scales, const uint8_t* v_codes, const uint8_t* v_scales,
    const int* page_table, const int* lengths, const int* q_offsets,
    void* out, int B, int Sq, int H, int KVH, int D, int page_size,
    int n_pages, int nb, int fmt, int block, int causal, int window,
    float sm_scale, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0) return int(cudaSuccess);
  int G = H / KVH;
  size_t smem = sizeof(float) * (2 * size_t(G) * D + 2 * G +
                                 TK * (D + 1) + size_t(TK) * D) +
                sizeof(int) * TK;
  cudaError_t err = cudaFuncSetAttribute(
      flash_paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(Sq, KVH, B);
  flash_paged_kernel<<<grid, NWARP * 32, smem, stream>>>(
      q, q_bf16, k_codes, k_scales, v_codes, v_scales, page_table, lengths,
      q_offsets, out, Sq, H, KVH, D, page_size, n_pages, nb, fmt, block,
      causal, window, sm_scale);
  return int(cudaGetLastError());
}
