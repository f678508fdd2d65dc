// K6 flash_attention_packed and K7 flash_attention for Hopper (sm_90a),
// bound with ctypes.
//
// K6 replaces repro/kernels/flash_attn.py::flash_attention_packed
// (_flash_packed_kernel, pl.pallas_call at flash_attn.py:255): attention of
// q (B, Sq, H, D) over a contiguous block-quantized KV cache -- nvfp4:
// (B, Sk, KVH, D/2) uint8 nibble pairs + (B, Sk, KVH, D/16) float8_e4m3fn
// scales; fp8: float8_e4m3fn codes + bf16 scales -- with (q_offset, kv_len)
// read from a device int32 pair, GQA, causal and sliding-window masks.
// K7 replaces flash_attn.py::flash_attention (_flash_kernel, call at
// flash_attn.py:454): bf16/f32 q, k, v, GQA, causal, window, and p rounded
// to V's dtype before the pv product (flash_attn.py:80-82).
//
// What bounds them on an H100: at the serving shapes (decode over <= 256
// cached tokens, prefill of 64 tokens) both move a few MB at most and do
// ~0.1 GFLOP, so they take microseconds of bytes or operations and are in
// practice bound by launch latency and by the serial tile loop of one
// block.  K6 streams the cache at its packed width (0.5625 B/elem).
//
// What the design does about it, simple and right first:
//   * K6: one block per (query row, kv head, batch) serves all G query
//     heads of the group, so every K/V tile is read and dequantized once
//     for the group; tiles of 32 keys are dequantized (nibble x E4M3 byte,
//     or fp8 x bf16) into shared memory in f32, one warp per query head
//     runs the online softmax with a lane per key, p stays f32.  The loop
//     stops at min(kv_len, causal frontier) and starts at the window's
//     first tile: skipped tiles contribute exactly 0 after a valid tile.
//   * K7: one block per (16-row q tile, head, batch), four rows per warp,
//     a loop over 32-key tiles with the causal/window tile skip; any Sq and
//     Sk, the ragged edge masked.
//   * masked scores are NEG_INF = -1e30 as in the TPU kernels, so the
//     arithmetic of fully masked tiles matches theirs.
//   * f32 CUDA-core dots; no tensor cores or TMA yet.
#include "fp4_common.cuh"

namespace {

constexpr int TK = 32;          // keys per tile (one per lane)
constexpr float NEG_INF = -1e30f;
constexpr int NWARP = 4;

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

__device__ __forceinline__ bool key_valid(int kpos, int qpos, int kv_len,
                                          int causal, int window) {
  bool ok = kpos < kv_len;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---- K6 -------------------------------------------------------------------
// grid (Sq, KVH, B), NWARP*32 threads.  Dynamic shared memory (floats):
// qs[G][D] | acc[G][D] | ml[2G] | kt[TK][D+1] | vt[TK][D]
__global__ void flash_packed_kernel(const void* __restrict__ q, int q_bf16,
                                    const uint8_t* __restrict__ kc,
                                    const uint8_t* __restrict__ ks,
                                    const uint8_t* __restrict__ vc,
                                    const uint8_t* __restrict__ vs,
                                    const int* __restrict__ pos,
                                    void* __restrict__ out, int Sq, int H,
                                    int KVH, int D, int Sk, int nvfp4,
                                    int block, int causal, int window,
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
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;

  const int q_offset = pos[0], kv_len = min(pos[1], Sk);
  const int qpos = q_offset + qi;
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
  if (causal) kend = min(kend, qpos + 1);
  int kstart = 0;
  if (window > 0) kstart = max(0, qpos - window + 1);
  const int t_first = (kstart / TK) * TK;
  const int Dc = nvfp4 ? D / 2 : D;
  const int nb = D / block;
  __syncthreads();

  for (int t0 = t_first; t0 < kend; t0 += TK) {
    // dequantize the K and V tiles into shared memory (f32)
    for (int i = tid; i < TK * Dc; i += nthr) {
      int j = i / Dc, c = i % Dc;
      int key = t0 + j;
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (key < Sk) {
        size_t row = (size_t(b) * Sk + key) * KVH + kvh;
        if (nvfp4) {
          uint32_t kb = kc[row * Dc + c], vb = vc[row * Dc + c];
          int d = 2 * c;                      // low nibble = column 2c
          float ksc = fp4::decode_e4m3(ks[row * nb + d / block]);
          float vsc = fp4::decode_e4m3(vs[row * nb + d / block]);
          k0 = fp4::decode_e2m1(kb & 0xFu) * ksc;
          k1 = fp4::decode_e2m1(kb >> 4) * ksc;
          v0 = fp4::decode_e2m1(vb & 0xFu) * vsc;
          v1 = fp4::decode_e2m1(vb >> 4) * vsc;
        } else {
          const __nv_bfloat16* ksb = reinterpret_cast<const __nv_bfloat16*>(ks);
          const __nv_bfloat16* vsb = reinterpret_cast<const __nv_bfloat16*>(vs);
          k0 = fp4::decode_e4m3(kc[row * Dc + c]) *
               __bfloat162float(ksb[row * nb + c / block]);
          v0 = fp4::decode_e4m3(vc[row * Dc + c]) *
               __bfloat162float(vsb[row * nb + c / block]);
        }
      }
      if (nvfp4) {
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
    const int key = t0 + lane;
    const bool valid = key_valid(key, qpos, kv_len, causal, window);
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
        for (int j = 0; j < TK; ++j)
          pv = fmaf(__shfl_sync(0xffffffffu, p, j), vt[j * D + d], pv);
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

// ---- K7 -------------------------------------------------------------------
// grid (ceil(Sq/BQ), H, B), NWARP*32 threads, RPW query rows per warp.
// Dynamic shared memory (floats): qs[BQ][D] | kt[TK][D+1] | vt[TK][D]
constexpr int RPW = 4;
constexpr int BQ = NWARP * RPW;

template <int DPL>  // head-dim values per lane: D = 32 * DPL
__global__ void flash_kernel(const void* __restrict__ q,
                             const void* __restrict__ k,
                             const void* __restrict__ v, int bf16,
                             void* __restrict__ out, int Sq, int Sk, int H,
                             int KVH, int causal, int window,
                             float sm_scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ float smem[];
  float* qs = smem;
  float* kt = qs + BQ * D;
  float* vt = kt + TK * (D + 1);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * BQ;

  for (int i = tid; i < BQ * D; i += blockDim.x) {
    int r = i / D, d = i % D, row = q0 + r;
    qs[i] = row < Sq ? load_f(q, ((size_t(b) * Sq + row) * H + h) * D + d,
                              bf16)
                     : 0.f;
  }
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  // tile skip for the whole q tile (rows q0 .. q0 + BQ - 1)
  int kend = Sk;
  if (causal) kend = min(kend, q0 + BQ);
  int t_first = 0;
  if (window > 0) t_first = (max(0, q0 - window + 1) / TK) * TK;
  __syncthreads();

  for (int t0 = t_first; t0 < kend; t0 += TK) {
    for (int i = tid; i < TK * D; i += blockDim.x) {
      int j = i / D, d = i % D, key = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Sk) {
        size_t idx = ((size_t(b) * Sk + key) * KVH + kvh) * D + d;
        kv = load_f(k, idx, bf16);
        vv = load_f(v, idx, bf16);
      }
      kt[j * (D + 1) + d] = kv;
      vt[j * D + d] = vv;
    }
    __syncthreads();
    const int key = t0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + warp * RPW + r;
      const float* qr = qs + (warp * RPW + r) * D;
      const float* kr = kt + lane * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const bool valid = key < Sk && key_valid(key, row, Sk, causal, window);
      s = valid ? s * sm_scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float corr = expf(m[r] - m_new);
      float p = expf(s - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      // p is cast to V's dtype before the pv product (TPU kernel rule)
      if (bf16) p = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        float pv = 0.f;
        for (int j = 0; j < TK; ++j)
          pv = fmaf(__shfl_sync(0xffffffffu, p, j), vt[j * D + d], pv);
        acc[r][i] = acc[r][i] * corr + pv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      store_f(out, ((size_t(b) * Sq + row) * H + h) * D + lane + 32 * i,
              acc[r][i] / denom, bf16);
  }
}

template <int DPL>
int launch_flash(const void* q, const void* k, const void* v, int bf16,
                 void* out, int B, int Sq, int Sk, int H, int KVH,
                 int causal, int window, float sm_scale,
                 cudaStream_t stream) {
  constexpr int D = 32 * DPL;
  size_t smem = sizeof(float) * (BQ * D + TK * (D + 1) + TK * D);
  cudaFuncSetAttribute(flash_kernel<DPL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<DPL><<<grid, NWARP * 32, smem, stream>>>(
      q, k, v, bf16, out, Sq, Sk, H, KVH, causal, window, sm_scale);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_packed_fwd(
    const void* q, int q_bf16, const uint8_t* k_codes,
    const uint8_t* k_scales, const uint8_t* v_codes, const uint8_t* v_scales,
    const int* pos, void* out, int B, int Sq, int H, int KVH, int D, int Sk,
    int nvfp4, int block, int causal, int window, float sm_scale,
    cudaStream_t stream) {
  int G = H / KVH;
  size_t smem = sizeof(float) *
                (2 * size_t(G) * D + 2 * G + TK * (D + 1) + size_t(TK) * D);
  cudaFuncSetAttribute(flash_packed_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  dim3 grid(Sq, KVH, B);
  flash_packed_kernel<<<grid, NWARP * 32, smem, stream>>>(
      q, q_bf16, k_codes, k_scales, v_codes, v_scales, pos, out, Sq, H, KVH,
      D, Sk, nvfp4, block, causal, window, sm_scale);
  return int(cudaGetLastError());
}

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, int bf16, void* out, int B,
                                   int Sq, int Sk, int H, int KVH, int D,
                                   int causal, int window, float sm_scale,
                                   cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_flash<1>(q, k, v, bf16, out, B, Sq, Sk, H, KVH, causal,
                             window, sm_scale, stream);
    case 64:
      return launch_flash<2>(q, k, v, bf16, out, B, Sq, Sk, H, KVH, causal,
                             window, sm_scale, stream);
    case 96:
      return launch_flash<3>(q, k, v, bf16, out, B, Sq, Sk, H, KVH, causal,
                             window, sm_scale, stream);
    case 128:
      return launch_flash<4>(q, k, v, bf16, out, B, Sq, Sk, H, KVH, causal,
                             window, sm_scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
