// Proxy top-K selection (K6) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel nerf_siren_tpu/ops/pallas/proxy_select.py::
// _kernel (`proxy_select`). Per ray (o, d, near, far), exactly as the plain
// PyTorch version nerf_siren_tpu_torch/ops/kernels/proxy_select.py::
// proxy_select_ref: C uniform candidates z_i = near (1 - t_i) + far t_i,
// t_i = i / (C - 1); the density proxy's score at o + d z_i
// (proxy_common.cuh); then K rounds of "take the highest score, the lowest
// index among equals, and remove it". It writes the K chosen depths (R, K)
// in score order.
//
// Bound: operations (the proxy's 33 H + H multiply-adds per candidate;
// 32 bytes in and 4 K bytes out per ray). One warp owns a ray: lane l scores
// candidates l, l + 32, ... (C <= 32 * PER_LANE) with the weights broadcast
// from shared memory, keeps its scores in registers, and each round is one
// warp-wide (max, first index) reduction by shuffles; the owner lane then
// drops its winner. Nothing but the depths leaves the SM. The TPU kernel's
// layout (the (T*S, 4) flat candidate block built outside the kernel, the
// sin-block/cos-block embedding permutation, the one-hot selection by iota)
// is not kept.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include <math.h>

#include "proxy_common.cuh"

namespace {

using namespace proxy;

constexpr int WARPS = 8;       // rays per CTA, one per warp
constexpr int PER_LANE = 8;    // candidates per lane: C <= 256
constexpr int MAX_CANDIDATES = 32 * PER_LANE;

__device__ __forceinline__ float depth_at(float near, float far, int i, int C) {
  const float t = __fdiv_rn(float(i), float(C - 1));
  return __fadd_rn(__fmul_rn(near, __fsub_rn(1.0f, t)), __fmul_rn(far, t));
}

__global__ void __launch_bounds__(WARPS * 32)
    proxy_select_kernel(Weights wts, const float* __restrict__ rays, long long n_rays, int C,
                        int K, float* __restrict__ z_out) {
  extern __shared__ __align__(16) float smem[];
  load_weights(wts, smem);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;
  const float* ray = rays + r * 8;
  const float near = ray[6], far = ray[7];

  float s[PER_LANE];
#pragma unroll
  for (int m = 0; m < PER_LANE; ++m) {
    const int i = lane + 32 * m;
    s[m] = -INFINITY;
    if (i < C) {
      const float z = depth_at(near, far, i, C);
      s[m] = score(smem, wts.hidden, along(ray[0], ray[3], z), along(ray[1], ray[4], z),
                   along(ray[2], ray[5], z));
    }
  }
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int m = 0; m < PER_LANE; ++m) {
      if (s[m] > bv) {  // strict: the lower index wins a tie within the lane
        bv = s[m];
        bi = lane + 32 * m;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int m = 0; m < PER_LANE; ++m)
      if (bi == lane + 32 * m) s[m] = -INFINITY;
    if (lane == 0) z_out[r * K + k] = depth_at(near, far, bi, C);
  }
}

}  // namespace

extern "C" {

// Weights: w1 (hidden, 33) bf16, b1 (hidden,) f32, w2 (hidden,) bf16, b2 (1,)
// f32. rays: (n_rays, 8) f32 [o, d, near, far]. z: (n_rays, n_keep) f32.
// Returns a cudaError_t value.
int proxy_select_forward(const void* w1, const void* b1, const void* w2, const void* b2,
                         int hidden, const float* rays, long long n_rays, int n_candidates,
                         int n_keep, float* z, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || n_candidates < 2 ||
      n_candidates > MAX_CANDIDATES || n_keep < 1 || n_keep > n_candidates || n_rays < 0)
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  const Weights w = {static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                     static_cast<const bf16*>(w2), static_cast<const float*>(b2), hidden};
  const size_t smem = size_t(weight_floats(hidden)) * 4;
  cudaError_t err = cudaFuncSetAttribute(proxy_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (n_rays + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  proxy_select_kernel<<<unsigned(blocks), WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      w, rays, n_rays, n_candidates, n_keep, z);
  return int(cudaGetLastError());
}

}  // extern "C"
