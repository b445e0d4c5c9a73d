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
// Bound: bytes. Per point it reads 12 bytes of coordinates and writes 3 C
// floats (384 bytes at C 32), and the points read the texels of their
// corner blocks from a table (12.8 MB at 3 x 258 x 258 x 32 bf16; one
// 4096-ray chunk's coarse points touch ~1 MB of it) that fits the 50 MB
// L2. Behind the device-memory bound stands L2: each point reads 3 planes
// x 2 rows x 2 corners x C channels from it (768 bytes at C 32, bf16),
// twice the bytes it writes, and L2 moves whole 32-byte sectors. The
// design moves those bytes in as few, as wide and as full transactions as
// it can:
//  1. One thread per (point, group of VEC channels), VEC x sizeof(T) = 16
//     bytes on the main path (8 bf16 or 4 float32 channels). The index work
//     (scaled coordinates, floors, weights, validity, clamped corner
//     offsets) is done once per plane for VEC channels, and the plane loop
//     is unrolled. Lanes are point-major: thread t takes point t / G and
//     group t % G (G = C / VEC), so its output starts at VEC t within the
//     plane and a warp's stores for one plane form one contiguous run (8
//     points x 128 bytes at C 32, bf16). At VEC 8 lanes l and l ^ 16 swap
//     halves before storing, so that each float4 store instruction fills
//     whole sectors (`store_streaming`).
//  2. Each corner is one load of VEC channels through the read-only path
//     (ld.global.nc; consecutive samples of a ray often share texels). The
//     two corners of a row are C apart, so a plane takes four loads. The
//     source issues all twelve before the first product; ptxas (VEC 8, 80
//     registers) issues the first plane's four among the index work and the
//     other eight together as that plane's products begin, and the three
//     blocks an SM holds hide the rest.
//  3. The table stays in L2 and the output streams past it: every table
//     load carries an L2::evict_last cache policy (createpolicy), every
//     output store is st.global.cs (evict-first). No stream access-policy
//     window is set: it would outlive the call and reach every other kernel.
//  4. VEC is a template argument, picked at launch by the wrapper's
//     `launch_plan` as the widest load that divides C and the table's
//     address alignment: loads of 16 bytes (bf16 VEC 8, float32 VEC 4), 8
//     (4, 2), 4 (2, 1) and 2 (bf16 1). Every width is this kernel; each
//     stores its VEC floats as float4, float2 or float streaming stores.
// `python -m nerf_siren_tpu_torch.k5_ablation` times the kernel with one of
// points 1 and 3 taken out at a time.
// The TPU kernel's layout (the row-major tile table, the tile DMA at
// quantised origins, the one-hot y-matmul, the ray x depth groups, the
// `valid` output and the caller's miss list) is not kept: a GPU gathers
// any point directly.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // ops/kernels/triplane_gather.py::THREADS
constexpr int N_PLANES = 3;

// the (u, v) world axes of planes 0, 1, 2: the inverses of generate_planes
__device__ __forceinline__ int axis_u(int p) { return p == 2 ? 2 : 0; }
__device__ __forceinline__ int axis_v(int p) { return p == 0 ? 1 : (p == 1 ? 2 : 0); }

// ((t + 1) * size - 1) / 2, rounded after every step (the division by 2 is
// exact, so it is the product with 0.5)
__device__ __forceinline__ float unnormalize(float t, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(t, 1.0f), float(size)), 1.0f), 0.5f);
}

// One corner's VEC channels of a T table, loaded in one read-only
// instruction with the table's L2 policy, unpacked to float on use.
template <typename T, int VEC>
struct Corner {
  static constexpr int BYTES = VEC * int(sizeof(T));
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* p, uint64_t policy) {
    if constexpr (BYTES == 16) {
      asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
                   : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p), "l"(policy));
    } else if constexpr (BYTES == 8) {
      asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
                   : "=r"(w[0]), "=r"(w[1]) : "l"(p), "l"(policy));
    } else if constexpr (BYTES == 4) {
      asm volatile("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
                   : "=r"(w[0]) : "l"(p), "l"(policy));
    } else {
      static_assert(BYTES == 2, "corner loads are 16, 8, 4 or 2 bytes");
      unsigned short h;
      asm volatile("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
                   : "=h"(h) : "l"(p), "l"(policy));
      w[0] = h;
    }
  }

  // channel i as float (exact: a bf16 is the top half of its float)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const uint32_t v = w[i / 2];
      return __uint_as_float(i % 2 ? v & 0xffff0000u : v << 16);
    }
  }
};

// This lane's VEC floats to dst (aligned to min(16, 4 VEC) bytes) as
// streaming stores. dst is run + VEC lane, where run is the warp's output for
// the plane. At VEC 8 a lane's 32 bytes take two float4 stores; stored as
// they lie, each would write half of every 32-byte sector of the warp's 1 KB
// run, and L2 would take each sector twice. When the whole warp is live,
// lanes l and l ^ 16 swap second halves (four shuffles) instead: the first
// store then writes run[0, 512 B) (lanes 0-15 their own first halves, lanes
// 16-31 their partners' second halves) and the second run[512 B, 1 KB).
template <int VEC>
__device__ __forceinline__ void store_streaming(float* dst, const float (&o)[VEC],
                                                bool full_warp) {
  if constexpr (VEC == 8) {
    const float4 own = make_float4(o[0], o[1], o[2], o[3]);
    if (full_warp) {
      const bool hi = threadIdx.x & 16;
      const float4 other = make_float4(
          __shfl_xor_sync(0xffffffffu, o[4], 16), __shfl_xor_sync(0xffffffffu, o[5], 16),
          __shfl_xor_sync(0xffffffffu, o[6], 16), __shfl_xor_sync(0xffffffffu, o[7], 16));
      float* other_dst = dst + (hi ? 4 - 16 * VEC : 4 + 16 * VEC);   // the partner's second half
      __stcs(reinterpret_cast<float4*>(hi ? other_dst : dst), hi ? other : own);
      __stcs(reinterpret_cast<float4*>(hi ? dst : other_dst), hi ? own : other);
    } else {
      __stcs(reinterpret_cast<float4*>(dst), own);
      __stcs(reinterpret_cast<float4*>(dst) + 1, make_float4(o[4], o[5], o[6], o[7]));
    }
  } else if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(o[0], o[1], o[2], o[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(o[0], o[1]));
  } else {
    static_assert(VEC == 1, "a thread stores 8, 4, 2 or 1 floats");
    __stcs(dst, o[0]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    triplane_gather_kernel(const T* __restrict__ table, int H, int W, int C,
                           const float* __restrict__ xyz, long long M, float scale,
                           float* __restrict__ out) {
  // thread t -> (point m, channel group g)
  const int G = C / VEC;
  const unsigned long long t = (unsigned long long)blockIdx.x * THREADS + threadIdx.x;
  const long long m = (long long)(t / (unsigned long long)G);
  const int g = int(t - (unsigned long long)m * G);
  const bool full_warp = (t | 31ull) < (unsigned long long)M * G;   // every lane has a point
  if (m >= M) return;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));

  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = __fmul_rn(scale, __ldg(xyz + m * 3 + k));

  // index work, once per plane for VEC channels
  const long long row = (long long)(W + 2) * C;     // elements per table row
  const long long plane = (long long)(H + 2) * row;
  float wt[N_PLANES][4], valid[N_PLANES];
  const T* top[N_PLANES];
#pragma unroll
  for (int p = 0; p < N_PLANES; ++p) {
    const float ix = unnormalize(q[axis_u(p)], W);
    const float iy = unnormalize(q[axis_v(p)], H);
    const float fx0 = floorf(ix), fy0 = floorf(iy);
    const float wx1 = __fsub_rn(ix, fx0), wy1 = __fsub_rn(iy, fy0);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    wt[p][0] = __fmul_rn(wy0, wx0);
    wt[p][1] = __fmul_rn(wy0, wx1);
    wt[p][2] = __fmul_rn(wy1, wx0);
    wt[p][3] = __fmul_rn(wy1, wx1);
    valid[p] = (fx0 >= -1.0f && fx0 <= float(W - 1) && fy0 >= -1.0f && fy0 <= float(H - 1))
                   ? 1.0f : 0.0f;
    // the corner block's first row and column, clamped into the table (a NaN
    // coordinate clamps to 0; its output is NaN, as the plain version's)
    const int r0 = int(fminf(fmaxf(__fadd_rn(fy0, 1.0f), 0.0f), float(H)));
    const int c0 = int(fminf(fmaxf(__fadd_rn(fx0, 1.0f), 0.0f), float(W)));
    top[p] = table + p * plane + r0 * row + (long long)c0 * C + g * VEC;
  }

  // all twelve corner loads in flight before the first product
  Corner<T, VEC> corner[N_PLANES][4];
#pragma unroll
  for (int p = 0; p < N_PLANES; ++p) {
    corner[p][0].load(top[p], policy);
    corner[p][1].load(top[p] + C, policy);
    corner[p][2].load(top[p] + row, policy);
    corner[p][3].load(top[p] + row + C, policy);
  }

#pragma unroll
  for (int p = 0; p < N_PLANES; ++p) {
    float o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float acc = __fmul_rn(corner[p][0].get(i), wt[p][0]);
      acc = __fadd_rn(acc, __fmul_rn(corner[p][1].get(i), wt[p][1]));
      acc = __fadd_rn(acc, __fmul_rn(corner[p][2].get(i), wt[p][2]));
      acc = __fadd_rn(acc, __fmul_rn(corner[p][3].get(i), wt[p][3]));
      o[i] = __fmul_rn(acc, valid[p]);
    }
    store_streaming<VEC>(out + ((long long)p * M + m) * C + g * VEC, o, full_warp);
  }
}

template <typename T, int VEC>
int launch(const void* table, int H, int W, int C, const float* xyz, long long M, float scale,
           float* out, long long blocks, cudaStream_t s) {
  triplane_gather_kernel<T, VEC><<<unsigned(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(table), H, W, C, xyz, M, scale, out);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: (3, H+2, W+2, C), bf16 when is_bf16 else float32, zero border.
// xyz: (M, 3) float32. out: (3, M, C) float32. vec: channels per corner
// load (bf16 8, 4, 2 or 1; float32 4, 2 or 1), dividing C, the table's
// address aligned to vec elements; blocks of THREADS threads covering the
// M x C / vec threads with no block to spare (the wrapper's launch_plan).
// Returns a cudaError_t value.
int triplane_gather_forward(const void* table, int is_bf16, int H, int W, int C, int vec,
                            const float* xyz, long long M, float scale, float* out,
                            long long blocks, void* stream) {
  if (H < 1 || W < 1 || C < 1 || M < 0 || vec < 1 || C % vec) return int(cudaErrorInvalidValue);
  if (M == 0) return int(cudaSuccess);
  const int load_bytes = vec * (is_bf16 ? 2 : 4);
  const int store_align = vec * 4 < 16 ? vec * 4 : 16;
  if (reinterpret_cast<uintptr_t>(table) % load_bytes ||
      reinterpret_cast<uintptr_t>(out) % store_align)
    return int(cudaErrorMisalignedAddress);
  const long long threads = M * (C / vec);
  if (blocks < 1 || blocks > 0x7fffffffLL || blocks * THREADS < threads ||
      (blocks - 1) * THREADS >= threads)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (vec) {
      case 8: return launch<__nv_bfloat16, 8>(table, H, W, C, xyz, M, scale, out, blocks, s);
      case 4: return launch<__nv_bfloat16, 4>(table, H, W, C, xyz, M, scale, out, blocks, s);
      case 2: return launch<__nv_bfloat16, 2>(table, H, W, C, xyz, M, scale, out, blocks, s);
      case 1: return launch<__nv_bfloat16, 1>(table, H, W, C, xyz, M, scale, out, blocks, s);
    }
  } else {
    switch (vec) {
      case 4: return launch<float, 4>(table, H, W, C, xyz, M, scale, out, blocks, s);
      case 2: return launch<float, 2>(table, H, W, C, xyz, M, scale, out, blocks, s);
      case 1: return launch<float, 1>(table, H, W, C, xyz, M, scale, out, blocks, s);
    }
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
