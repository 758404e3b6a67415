// Row RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel hcache_deepspeed_tpu/ops/rms_norm.py:26
// `_rms_kernel` (reached through `_rms_fwd_pallas`): per row, the fp32 mean
// of squares, times rsqrt(mean + eps), times the weight, cast back to the
// input dtype.
//
// Bound: bytes. The kernel must read the N x H input and the H weights and
// write N x H outputs (2*N*H*itemsize + H*w_itemsize bytes) while doing
// about 4 operations per element, far below the card's operations-per-byte
// balance point. The design therefore spends nothing on arithmetic and
// everything on the memory stream: one thread block per row, 16-byte vector
// loads and stores (8 bf16 or 4 fp32 elements per thread access), a float32
// warp-shuffle reduction of the sum of squares, then a second pass over the
// row (an L1/L2 hit, not a second trip to device memory at H = 4096) that
// scales and writes. The weight vector is read through the cache by every
// row.
#include <stdint.h>

#include "hds_common.cuh"

namespace {

template <typename T, typename W>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const W* __restrict__ w,
                                T* __restrict__ out, int hidden, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + static_cast<size_t>(blockIdx.x) * hidden;
  T* orow = out + static_cast<size_t>(blockIdx.x) * hidden;
  const int nvec = hidden / VEC;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = hds::to_f(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = hds::warp_sum(ss);

  __shared__ float warp_sums[32];
  __shared__ float s_rstd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    t = hds::warp_sum(t);
    if (lane == 0) s_rstd = rsqrtf(t / static_cast<float>(hidden) + eps);
  }
  __syncthreads();
  const float rstd = s_rstd;

  uint4* ov = reinterpret_cast<uint4*>(orow);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // (x * rstd) * w, the reference's order
      o[j] = hds::from_f<T>(hds::to_f(e[j]) * rstd *
                            hds::to_f(w[i * VEC + j]));
    }
    ov[i] = res;
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* out, int rows, int hidden,
            float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  int nvec = hidden / VEC;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  rms_norm_kernel<T, W><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), hidden, eps);
}

}  // namespace

// x [rows, hidden] and out: contiguous, 16-byte aligned, hidden % 8 == 0
// (checked by the Python wrapper). Returns the launch's cudaError_t.
extern "C" int hds_rms_norm(const void* x, const void* w, void* out,
                            int rows, int hidden, float eps, int x_dtype,
                            int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (x_dtype == hds::kBFloat16 && w_dtype == hds::kBFloat16)
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, hidden, eps, s);
    else if (x_dtype == hds::kBFloat16 && w_dtype == hds::kFloat32)
      launch<__nv_bfloat16, float>(x, w, out, rows, hidden, eps, s);
    else if (x_dtype == hds::kFloat32 && w_dtype == hds::kBFloat16)
      launch<float, __nv_bfloat16>(x, w, out, rows, hidden, eps, s);
    else if (x_dtype == hds::kFloat32 && w_dtype == hds::kFloat32)
      launch<float, float>(x, w, out, rows, hidden, eps, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
