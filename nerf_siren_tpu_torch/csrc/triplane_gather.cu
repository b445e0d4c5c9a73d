// Triplane gather (K5) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel nerf_siren_tpu/ops/pallas/triplane_gather.py::
// _gather_kernel (`triplane_gather_plane`, driven by render/triplane.py::
// make_kernel_plane_sampler). It computes exactly the plain PyTorch version
// nerf_siren_tpu_torch/ops/kernels/triplane_gather.py::triplane_gather_ref,
// i.e. ops/grid_sample.py::grid_sample_2d_packed on the three planes of a
// zero-bordered channel-last table (3, H+2, W+2, C), bf16 or float32. Per
// point xyz and plane p: q = scale * xyz; (u, v) = (q_x, q_y), (q_x, q_z),
// (q_z, q_x) for p = 0, 1, 2; ix = ((u + 1) W - 1) / 2, iy likewise; ix0 =
// floor(ix), wx1 = ix - ix0, wx0 = 1 - wx1 (y alike); the corners at table
// rows iy0+1, iy0+2 and columns ix0+1, ix0+2 (clamped into the table);
// out = b00 (wy0 wx0) + b01 (wy0 wx1) + b10 (wy1 wx0) + b11 (wy1 wx1),
// summed left to right, times 0 unless -1 <= ix0 <= W-1 and -1 <= iy0 <=
// H-1. Every step is one __fmul_rn / __fadd_rn / __fsub_rn in PyTorch's
// order (no FMA contraction), so on the card it equals the plain version
// bit for bit. It writes (3, M, C) float32.
//
// Bound: bytes. Per point it reads 12 bytes of coordinates and, per plane,
// four corners of C channels from a table that stays in L2 (12.8 MB at 3 x
// 258 x 258 x 32 bf16); it writes 3 C floats, which dominate (384 of ~400
// bytes per point at C 32). One thread per (point, channel): consecutive
// threads take consecutive channels, so a warp reads each corner of a point
// as one 64-byte run (C 32, bf16) and writes each plane's features as one
// 128-byte run. The TPU kernel's layout (the row-major tile table, the tile
// DMA at quantised origins, the one-hot y-matmul, the ray x depth groups,
// the `valid` output and the caller's miss list) is not kept: a GPU gathers
// any point directly.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_PLANES = 3;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// the (u, v) world axes of planes 0, 1, 2: the inverses of generate_planes
__device__ __forceinline__ int axis_u(int p) { return p == 2 ? 2 : 0; }
__device__ __forceinline__ int axis_v(int p) { return p == 0 ? 1 : (p == 1 ? 2 : 0); }

// ((t + 1) * size - 1) / 2, rounded after every step (the division by 2 is
// exact, so it is the product with 0.5)
__device__ __forceinline__ float unnormalize(float t, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(t, 1.0f), float(size)), 1.0f), 0.5f);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    triplane_gather_kernel(const T* __restrict__ table, int H, int W, int C,
                           const float* __restrict__ xyz, long long M, float scale,
                           int points_per_block, float* __restrict__ out) {
  const int lp = threadIdx.x / C;
  if (lp >= points_per_block) return;
  const long long m = (long long)blockIdx.x * points_per_block + lp;
  if (m >= M) return;
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = __fmul_rn(scale, xyz[m * 3 + k]);

  const long long row = (long long)(W + 2) * C;     // elements per table row
  const long long plane = (long long)(H + 2) * row;
  for (int p = 0; p < N_PLANES; ++p) {
    const float ix = unnormalize(q[axis_u(p)], W);
    const float iy = unnormalize(q[axis_v(p)], H);
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float wx1 = __fsub_rn(ix, fx0), wy1 = __fsub_rn(iy, fy0);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
    const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
    const float valid = (fx0 >= -1.0f && fx0 <= float(W - 1) && fy0 >= -1.0f &&
                         fy0 <= float(H - 1)) ? 1.0f : 0.0f;
    // the corner block's first row and column, clamped into the table (a NaN
    // coordinate clamps to 0; its output is NaN, as the plain version's)
    const int r0 = int(fminf(fmaxf(__fadd_rn(fy0, 1.0f), 0.0f), float(H)));
    const int c0 = int(fminf(fmaxf(__fadd_rn(fx0, 1.0f), 0.0f), float(W)));
    const T* top = table + p * plane + r0 * row + (long long)c0 * C;
    const T* bottom = top + row;
    float* dst = out + ((long long)p * M + m) * C;
    for (int c = threadIdx.x - lp * C; c < C; c += THREADS) {
      float acc = __fmul_rn(to_float(top[c]), w00);
      acc = __fadd_rn(acc, __fmul_rn(to_float(top[C + c]), w01));
      acc = __fadd_rn(acc, __fmul_rn(to_float(bottom[c]), w10));
      acc = __fadd_rn(acc, __fmul_rn(to_float(bottom[C + c]), w11));
      dst[c] = __fmul_rn(acc, valid);
    }
  }
}

}  // namespace

extern "C" {

// table: (3, H+2, W+2, C), bf16 when is_bf16 else float32, zero border.
// xyz: (M, 3) float32. out: (3, M, C) float32. Returns a cudaError_t value.
int triplane_gather_forward(const void* table, int is_bf16, int H, int W, int C,
                            const float* xyz, long long M, float scale, float* out,
                            void* stream) {
  if (H < 1 || W < 1 || C < 1 || M < 0) return int(cudaErrorInvalidValue);
  if (M == 0) return int(cudaSuccess);
  const int points_per_block = C >= THREADS ? 1 : THREADS / C;
  const long long blocks = (M + points_per_block - 1) / points_per_block;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    triplane_gather_kernel<<<unsigned(blocks), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), H, W, C, xyz, M, scale, points_per_block, out);
  else
    triplane_gather_kernel<<<unsigned(blocks), THREADS, 0, s>>>(
        static_cast<const float*>(table), H, W, C, xyz, M, scale, points_per_block, out);
  return int(cudaGetLastError());
}

}  // extern "C"
