// Ragged paged attention over a block table, for Hopper (sm_90a).
//
// Replaces the TPU kernel hcache_deepspeed_tpu/ops/paged_attention.py:77
// `_kernel` (reached through `pallas_paged_attention`). For each sequence b
// the queries q[b, t, h, :] attend to the cached keys and values of kv head
// h // G at absolute positions col, through the block table: the key at
// position col lives in pool slot tables[b, col / BS] * BS + col % BS. The
// mask is col <= start[b] + t and col < kv_len[b]. GQA is done by stacking
// the G query heads of one kv head as rows (row r -> t = r / G, g = r % G),
// so no kv head is repeated. Softmax is online, in fp32. A row with no
// valid column (a padded lane with kv_len = 0) writes zeros, as the TPU
// kernel's l == 0 guard does.
//
// Bound: at decode, bytes. Each kv head's K and V for the valid context must
// be read once: 2 * B * KV * kv_len * D * itemsize bytes (Llama-2-7B, B = 8,
// kv_len = 1024, bf16: 134 MB per layer, about 40 us at 3.35 TB/s), against
// about 4 * D operations per key per query row. Prefill chunks (T * G rows
// per kv head) reuse each K/V tile across up to 16 rows.
//
// Design (simple and right first; no wgmma, TMA or split-K yet):
//  * one thread block per (tile of ROWS query rows, kv head, sequence);
//    ROWS is 1, 4 or 16 by T * G, so a decode row with G = 1 is one block;
//  * the block walks its sequence's block table itself, in tiles of 128
//    key positions, and stops at the last position any of its rows may see
//    (causal), so cost follows the real context, not the table width;
//  * the 4 warps load each tile's K and V rows cooperatively with 16-byte
//    loads into shared memory (rows padded to an odd word stride, so the
//    lane-per-key reads below hit 32 distinct banks);
//  * each warp owns 32 of the tile's keys (one per lane) for all ROWS rows:
//    lane = key for the scores, lane = output dims for P.V, with the
//    probabilities passed through shared memory;
//  * each warp keeps its own running max, running sum and fp32 accumulator
//    in registers; the four warps' partial softmax states are merged once
//    at the end.
#include <stdint.h>

#include "hds_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = kWarps * 32;  // key positions per block tile
constexpr float kNegInf = -1e30f;   // finite, as the TPU kernel's mask

template <typename T, int D>
struct Layout {
  // padded row stride in elements: an odd number of 32-bit words
  static constexpr int kStride = D + 4 / static_cast<int>(sizeof(T));
};

template <typename T, int D, int ROWS>
__host__ __device__ constexpr size_t smem_bytes() {
  // K and V tiles, or (after the loop) the warps' partial states
  return (2 * kTile * Layout<T, D>::kStride * sizeof(T) >
                  kWarps * ROWS * (2 + D) * sizeof(float)
              ? 2 * kTile * Layout<T, D>::kStride * sizeof(T)
              : kWarps * ROWS * (2 + D) * sizeof(float)) +
         ROWS * D * sizeof(float) +           // queries, as float
         kWarps * ROWS * 32 * sizeof(float) + // probabilities
         kTile * sizeof(int);                 // pool slot of each tile key
}

// two neighbouring elements of a shared-memory row (even offset)
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return make_float2(p[0], p[1]);
}

template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ start,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       int T_, int Hq, int KV, int P, int NB, int BS,
                       float scale) {
  constexpr int kStride = Layout<T, D>::kStride;
  constexpr int kDims = D / 32;        // output dims per lane
  constexpr int kChunks = D * sizeof(T) / 16;  // 16-byte chunks per row
  constexpr size_t kTileBytes =
      smem_bytes<T, D, ROWS>() - ROWS * D * sizeof(float) -
      kWarps * ROWS * 32 * sizeof(float) - kTile * sizeof(int);

  const int G = Hq / KV;
  const int TG = T_ * G;
  const int row0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kTile * kStride;
  float* q_s = reinterpret_cast<float*>(smem + kTileBytes);
  float* p_s = q_s + ROWS * D;
  int* slot_s = reinterpret_cast<int*>(p_s + kWarps * ROWS * 32);

  const int kvlen = kv_len[b];
  const int st = start[b];

  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, d = i % D, gr = row0 + r;
    float val = 0.f;
    if (gr < TG) {
      const int h = kvh * G + gr % G;
      val = hds::to_f(q[((static_cast<size_t>(b) * T_ + gr / G) * Hq + h) * D +
                        d]);
    }
    q_s[i] = val;
  }

  int row_pos[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][kDims];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gr = row0 + r;
    row_pos[r] = gr < TG ? st + gr / G : -1;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
  }
  // keys past the last position any row of this tile may attend
  const int last_row = min(row0 + ROWS, TG) - 1;
  const int limit = min(kvlen, st + last_row / G + 1);

  const T* kbase = k_pool + static_cast<size_t>(kvh) * P * D;
  const T* vbase = v_pool + static_cast<size_t>(kvh) * P * D;
  const int* table = tables + static_cast<size_t>(b) * NB;
  __syncthreads();

  for (int base = 0; base < limit; base += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int pos = base + i;
      int slot = -1;
      if (pos < limit) {
        const int blk = min(pos / BS, NB - 1);
        slot = table[blk] * BS + pos % BS;
      }
      slot_s[i] = slot;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int key = i / kChunks, c = i % kChunks;
      const int slot = slot_s[key];
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (slot >= 0) {
        kr = reinterpret_cast<const uint4*>(kbase +
                                            static_cast<size_t>(slot) * D)[c];
        vr = reinterpret_cast<const uint4*>(vbase +
                                            static_cast<size_t>(slot) * D)[c];
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + key * kStride) + c * 4;
      uint32_t* vd = reinterpret_cast<uint32_t*>(v_s + key * kStride) + c * 4;
      kd[0] = kr.x; kd[1] = kr.y; kd[2] = kr.z; kd[3] = kr.w;
      vd[0] = vr.x; vd[1] = vr.y; vd[2] = vr.z; vd[3] = vr.w;
    }
    __syncthreads();

    if (base + warp * 32 < limit) {   // uniform per warp
      const int key = warp * 32 + lane;
      const int col = base + key;
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
      const T* krow = k_s + key * kStride;
#pragma unroll 4
      for (int d = 0; d < D; d += 2) {
        const float2 kk = load_pair(krow + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          s[r] = fmaf(q_s[r * D + d], kk.x, s[r]);
          s[r] = fmaf(q_s[r * D + d + 1], kk.y, s[r]);
        }
      }
      float* pw = p_s + warp * ROWS * 32;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool ok = col < kvlen && col <= row_pos[r];
        const float sv = ok ? s[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], hds::warp_max(sv));
        // masked entries contribute exactly 0, even before any valid one
        const float p = ok ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + hds::warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[r][c] *= corr;
        pw[r * 32 + lane] = p;
      }
      __syncwarp();
      for (int j = 0; j < 32; ++j) {
        const T* vrow = v_s + (warp * 32 + j) * kStride;
        float vv[kDims];
#pragma unroll
        for (int c = 0; c < kDims; ++c) vv[c] = hds::to_f(vrow[lane + 32 * c]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = pw[r * 32 + j];
#pragma unroll
          for (int c = 0; c < kDims; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }

  // merge the warps' partial softmax states (reusing the tile memory)
  float* cm = reinterpret_cast<float*>(smem);     // [kWarps][ROWS]
  float* cl = cm + kWarps * ROWS;                 // [kWarps][ROWS]
  float* cacc = cl + kWarps * ROWS;               // [kWarps][ROWS][D]
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      cm[warp * ROWS + r] = m[r];
      cl[warp * ROWS + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      cacc[(warp * ROWS + r) * D + lane + 32 * c] = acc[r][c];
  }
  __syncthreads();
  for (int r = warp; r < ROWS; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= TG) continue;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w * ROWS + r]);
    float den = 0.f, o[kDims];
#pragma unroll
    for (int c = 0; c < kDims; ++c) o[c] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(cm[w * ROWS + r] - mx);
      den += cl[w * ROWS + r] * f;
#pragma unroll
      for (int c = 0; c < kDims; ++c)
        o[c] = fmaf(cacc[(w * ROWS + r) * D + lane + 32 * c], f, o[c]);
    }
    if (den == 0.f) den = 1.f;   // empty row: o is 0, write zeros
    const int h = kvh * G + gr % G;
    T* orow = out + ((static_cast<size_t>(b) * T_ + gr / G) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < kDims; ++c) orow[lane + 32 * c] = hds::from_f<T>(o[c] / den);
  }
}

template <typename T, int D, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* start, const int* kv_len,
                   void* out, int B, int T_, int Hq, int KV, int P, int NB,
                   int BS, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D, ROWS>();
  auto kernel = paged_attention_kernel<T, D, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int TG = T_ * (Hq / KV);
  dim3 grid((TG + ROWS - 1) / ROWS, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, start, kv_len, static_cast<T*>(out),
      T_, Hq, KV, P, NB, BS, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* tables, const int* start,
                        const int* kv_len, void* out, int B, int T_, int Hq,
                        int KV, int P, int NB, int BS, float scale,
                        cudaStream_t s) {
  const int TG = T_ * (Hq / KV);
  if (TG == 1)
    return launch<T, D, 1>(q, k, v, tables, start, kv_len, out, B, T_, Hq, KV,
                           P, NB, BS, scale, s);
  if (TG <= 4)
    return launch<T, D, 4>(q, k, v, tables, start, kv_len, out, B, T_, Hq, KV,
                           P, NB, BS, scale, s);
  return launch<T, D, 16>(q, k, v, tables, start, kv_len, out, B, T_, Hq, KV,
                          P, NB, BS, scale, s);
}

}  // namespace

// q, out [B, T, Hq, D]; k_pool, v_pool [KV, P, D] (one layer); tables
// [B, NB] int32; start, kv_len [B] int32. All contiguous on the device and
// checked by the Python wrapper: D in {64, 128}, BS % 8 == 0, P % BS == 0,
// Hq % KV == 0. Returns the launch's cudaError_t.
extern "C" int hds_paged_attention(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* start, const void* kv_len,
                                   void* out, int B, int T_, int Hq, int KV,
                                   int D, int P, int NB, int BS, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* st = static_cast<const int*>(start);
  const int* kl = static_cast<const int*>(kv_len);
  if (B == 0 || T_ == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  if (dtype == hds::kBFloat16 && D == 128)
    err = launch_rows<__nv_bfloat16, 128>(q, k_pool, v_pool, tb, st, kl, out,
                                          B, T_, Hq, KV, P, NB, BS, scale, s);
  else if (dtype == hds::kBFloat16 && D == 64)
    err = launch_rows<__nv_bfloat16, 64>(q, k_pool, v_pool, tb, st, kl, out,
                                         B, T_, Hq, KV, P, NB, BS, scale, s);
  else if (dtype == hds::kFloat32 && D == 128)
    err = launch_rows<float, 128>(q, k_pool, v_pool, tb, st, kl, out, B, T_,
                                  Hq, KV, P, NB, BS, scale, s);
  else if (dtype == hds::kFloat32 && D == 64)
    err = launch_rows<float, 64>(q, k_pool, v_pool, tb, st, kl, out, B, T_,
                                 Hq, KV, P, NB, BS, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
