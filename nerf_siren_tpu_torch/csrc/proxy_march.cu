// Proxy march (K3) for Hopper (sm_90a): the fast renderer's pre-model
// pipeline in one pass over each ray.
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/proxy_march.py::
// _opacity_kernel (`proxy_opacity`, the culling prepass) and ::_march_kernel
// (`proxy_march_select`). Per ray (o, d, near, far), exactly as the plain
// PyTorch version nerf_siren_tpu_torch/ops/kernels/proxy_march.py::
// proxy_opacity_ref / proxy_march_select_ref:
//   C uniform candidates z_j = near + j * spacing, spacing = (far - near) /
//   (C - 1); the density proxy's score at o + d z_j (proxy_common.cuh);
//   sigma = expm1(relu(score)), alpha = 1 - exp(-sigma * spacing * |d|),
//   expected weight w_j = alpha * T, T *= 1 - alpha + 1e-10.
//   `proxy_opacity` writes 1 - T after the last candidate.
//   `proxy_march_select` inverts the CDF of the interior weights w[1:-1]
//   (each + 1e-5, cdf_i = S_i / S_total, cdf_0 = 0) over the bins
//   near + (i + 0.5) spacing at u = (k + .5) / K (`midpoint`) or k / (K - 1),
//   with the reference sample_pdf's edges: count of cdf <= u, below/above
//   clamped to the bins, denominators < 1e-5 replaced by 1. It writes the K
//   ascending depths (R, K), the survivors o + d z (R, K, 3) ray-major (one
//   direction per ray for the field kernel), and optionally the landing
//   bin's normalised density dcdf / dz (R, K) and the mass S_total (R,).
//
// Bound: operations. A candidate costs 33 H + H multiply-adds of the proxy
// (H = 96: ~6.5 kFLOP) against 32 bytes in per ray and 16 K bytes out, so the
// arithmetic is the limit (the TPU kernel's own finding: its time was the
// sin and the MXU, never HBM). The design keeps everything of a ray in one
// thread: the weights (~18 KB as float32 at H = 96) in shared memory, read
// by every thread of a warp at the same address (a broadcast); the
// candidate loop and its transmittance in registers; the C - 2 running sums
// of the CDF in shared memory, one column per thread (no bank conflicts).
// Candidate depths are near + j * spacing, so the bins need no search: the
// CDF is walked once with a pointer that only moves forward, as u rises.
// The proxy runs on the CUDA cores, not the tensor cores: its 33-wide input
// is 1/8 of a wgmma tile's depth and its cost is ~1% of the field's.
//
// TPU layout tricks not kept: the (8, N) lane-major rays and TILE_R padding
// (any R), the rotation recurrence for sin (sinf/cosf of 2^k x), the folded
// [W1s|W1x|b1] stack, candidate-major survivor order.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include "proxy_common.cuh"

namespace {

using namespace proxy;

constexpr int TPB = 128;  // rays per CTA, one per thread

template <bool SELECT>
__global__ void __launch_bounds__(TPB)
    proxy_march_kernel(Weights wts, const float* __restrict__ rays, long long n_rays, int C,
                       int K, int midpoint, float* __restrict__ opacity,
                       float* __restrict__ z_out, float* __restrict__ xyz_out,
                       float* __restrict__ rho_out, float* __restrict__ mass_out) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* cum = smem + weight_floats(wts.hidden) + threadIdx.x;  // column of this thread
  load_weights(wts, sw);
  __syncthreads();

  const long long r = (long long)blockIdx.x * TPB + threadIdx.x;
  if (r >= n_rays) return;
  const float* ray = rays + r * 8;
  const float o[3] = {ray[0], ray[1], ray[2]};
  const float d[3] = {ray[3], ray[4], ray[5]};
  const float near = ray[6], far = ray[7];
  const int h = wts.hidden;
  const float spacing = __fdiv_rn(__fsub_rn(far, near), float(C - 1));
  const float dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                                   __fmul_rn(d[2], d[2])));
  const float dz = __fmul_rn(spacing, dn);

  float T = 1.0f, S = 0.0f;
  for (int j = 0; j < C; ++j) {
    const float z = along(near, float(j), spacing);
    const float sc = score(sw, h, along(o[0], d[0], z), along(o[1], d[1], z),
                           along(o[2], d[2], z));
    const float a = __fsub_rn(1.0f, expf(-__fmul_rn(expm1f(fmaxf(sc, 0.0f)), dz)));
    if (SELECT && j >= 1 && j <= C - 2) {
      S = __fadd_rn(S, __fadd_rn(__fmul_rn(a, T), 1e-5f));
      cum[(j - 1) * TPB] = S;
    }
    T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.0f, a), 1e-10f));
  }
  if (!SELECT) {
    opacity[r] = __fsub_rn(1.0f, T);
    return;
  }

  // cdf_i = S_i / S for i = 1..nb, cdf_0 = 0; cnt = #{i : cdf_i <= u} >= 1
  const int nb = C - 2;
  auto cdf = [&](int i) { return i == 0 ? 0.0f : __fdiv_rn(cum[(i - 1) * TPB], S); };
  int cnt = 1;
  for (int k = 0; k < K; ++k) {
    const float u = midpoint ? __fdiv_rn(float(k) + 0.5f, float(K))
                             : __fdiv_rn(float(k), float(K - 1));
    while (cnt <= nb && cdf(cnt) <= u) ++cnt;
    const int below = cnt - 1, above = min(cnt, nb);
    const float cb = cdf(below), ca = cdf(above);
    const float bb = along(near, float(below) + 0.5f, spacing);
    const float ba = along(near, float(above) + 0.5f, spacing);
    const float dcdf = __fsub_rn(ca, cb);
    const float denom = dcdf < 1e-5f ? 1.0f : dcdf;
    const float zk = __fadd_rn(bb, __fmul_rn(__fdiv_rn(__fsub_rn(u, cb), denom),
                                             __fsub_rn(ba, bb)));
    const long long q = r * K + k;
    z_out[q] = zk;
#pragma unroll
    for (int c = 0; c < 3; ++c) xyz_out[q * 3 + c] = along(o[c], d[c], zk);
    if (rho_out) rho_out[q] = __fdiv_rn(dcdf, fmaxf(__fsub_rn(ba, bb), 1e-7f));
  }
  if (mass_out) mass_out[r] = S;
}

template <bool SELECT>
int launch(const Weights& w, const float* rays, long long n_rays, int C, int K, int midpoint,
           float* opacity, float* z, float* xyz, float* rho, float* mass, void* stream) {
  const size_t smem = size_t(weight_floats(w.hidden) + (SELECT ? (C - 2) * TPB : 0)) * 4;
  cudaError_t err = cudaFuncSetAttribute(proxy_march_kernel<SELECT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long blocks = (n_rays + TPB - 1) / TPB;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  proxy_march_kernel<SELECT><<<unsigned(blocks), TPB, smem, static_cast<cudaStream_t>(stream)>>>(
      w, rays, n_rays, C, K, midpoint, opacity, z, xyz, rho, mass);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Weights: w1 (hidden, 33) bf16, b1 (hidden,) f32, w2 (hidden,) bf16, b2 (1,)
// f32. rays: (n_rays, 8) f32 [o, d, near, far]. Returns a cudaError_t value.

// opacity: (n_rays,) f32.
int proxy_opacity_forward(const void* w1, const void* b1, const void* w2, const void* b2,
                          int hidden, const float* rays, long long n_rays, int n_candidates,
                          float* opacity, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || n_candidates < 4 || n_rays < 0)
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  const Weights w = {static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                     static_cast<const bf16*>(w2), static_cast<const float*>(b2), hidden};
  return launch<false>(w, rays, n_rays, n_candidates, 0, 0, opacity, nullptr, nullptr, nullptr,
                       nullptr, stream);
}

// z: (n_rays, n_keep) f32, xyz: (n_rays, n_keep, 3) f32; rho (n_rays,
// n_keep) and mass (n_rays,) f32, or both null.
int proxy_march_select_forward(const void* w1, const void* b1, const void* w2, const void* b2,
                               int hidden, const float* rays, long long n_rays,
                               int n_candidates, int n_keep, int midpoint, float* z, float* xyz,
                               float* rho, float* mass, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || n_candidates < 4 || n_keep < 2 || n_rays < 0 ||
      (rho == nullptr) != (mass == nullptr))
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  const Weights w = {static_cast<const bf16*>(w1), static_cast<const float*>(b1),
                     static_cast<const bf16*>(w2), static_cast<const float*>(b2), hidden};
  return launch<true>(w, rays, n_rays, n_candidates, n_keep, midpoint, nullptr, z, xyz, rho,
                      mass, stream);
}

}  // extern "C"
