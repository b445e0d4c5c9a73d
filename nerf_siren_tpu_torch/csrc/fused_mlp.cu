// Fused NeRF field evaluation for Hopper (sm_90a), inference only.
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/fused_mlp.py::
// _sigma_kernel (sigma-only pass) and ::_full_kernel (rgb + sigma pass).
// Per point it computes, exactly as the plain PyTorch version
// nerf_siren_tpu_torch/ops/kernels/fused_mlp.py::fused_sigma_ref/_full_ref:
//   positional encoding of xyz (10 freqs) and of the direction (4 freqs) in
//   reference channel order, sin/cos formed in float32 with the precise
//   sinf/cosf (arguments reach 2^9|x| ~ 2000-5000, where the fast
//   intrinsics lose accuracy; never build this with --use_fast_math);
//   the ReLU trunk (width 256, any depth <= MAX_DEPTH, skip concat
//   [emb, h] at the layers whose embedding weight is given);
//   the sigma head; and in the full pass the folded direction branch
//   relu(W_comb h + W_dir demb + b_comb) -> sigmoid rgb head.
// Every product takes bf16 operands (embedding incl. the raw coordinates,
// hidden activations after ReLU, weights) and accumulates in float32;
// biases, ReLU and the heads' sums are float32.
//
// Bound: compute. A point costs ~1 MFLOP (7 256x256 layers, the 64-wide
// embedding inputs, the 128-wide direction branch) against 12-24 bytes of
// input and 4-16 bytes of output, so the tensor cores are the limit, not
// HBM. The design keeps everything but the weights on chip: one CTA owns a
// tile of TP = 128 points, their embeddings and bf16 activations live in
// shared memory for the whole network (one activation buffer, rewritten
// in place after a block barrier), and the layer products run on the
// tensor cores (wmma, bf16 in / f32 accumulate). The weights (~1.06 MB bf16
// per field) do not fit one SM's shared memory and stream from L2 as wmma
// B fragments; each warp reuses every B fragment for 4 row tiles (64
// points). The heads (1 and 3 outputs) are SIMT dot products from shared
// memory. The ragged last tile is masked: no padding of N is needed.
// TMA, wgmma and warp specialisation are left for later work.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int W = 256;            // trunk width
constexpr int WD = W / 2;         // direction-branch width
constexpr int TP = 128;           // points per CTA
constexpr int THREADS = 256;      // 8 warps: 2 (rows of 64 points) x 4 (column slices)
constexpr int EMB_X = 64;         // 63 xyz-embedding channels + 1 zero column
constexpr int EMB_D = 32;         // 27 direction-embedding channels + 5 zero columns
constexpr int PAD = 8;            // bf16 row padding against shared-memory bank conflicts
constexpr int LDH = W + PAD;
constexpr int LDX = EMB_X + PAD;
constexpr int LDD = EMB_D + PAD;
constexpr int MAX_DEPTH = 16;

constexpr size_t SMEM_H = size_t(TP) * LDH * 2;
constexpr size_t SMEM_X = size_t(TP) * LDX * 2;
constexpr size_t SMEM_D = size_t(TP) * LDD * 2;
constexpr size_t SMEM_STAGE = size_t(THREADS / 32) * 256 * 4;
constexpr size_t SMEM_PTS = size_t(TP) * 3 * 4;
constexpr size_t SMEM_BYTES = SMEM_H + SMEM_X + SMEM_D + SMEM_STAGE + 2 * SMEM_PTS + TP * 4;

struct FieldParams {
  const __nv_bfloat16* w_h[MAX_DEPTH];  // (W, W) hidden-input columns; null for layer 0
  const __nv_bfloat16* w_e[MAX_DEPTH];  // (W, EMB_X) embedding-input columns; null if none
  const float* b[MAX_DEPTH];            // (W,)
  const __nv_bfloat16* w_sigma;         // (W,)
  const float* b_sigma;                 // (1,)
  const __nv_bfloat16* w_comb;          // (WD, W) xyz_final folded into dir_layer
  const __nv_bfloat16* w_dir;           // (WD, EMB_D)
  const float* b_comb;                  // (WD,)
  const __nv_bfloat16* w_rgb;           // (3, WD)
  const float* b_rgb;                   // (3,)
  int depth;
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[i][j] += A[m0+16i.., k] * Wt[k, n0+16j..] over k < K, where A is a
// (TP, K) row-major bf16 tile in shared memory and Wt(k, n) = w[n * ldw + k]
// is a torch-layout (out, in) weight in global memory (col-major B).
template <int FN>
__device__ __forceinline__ void mma_segment(FragC (&acc)[4][FN], const __nv_bfloat16* a,
                                            int lda, const __nv_bfloat16* w, int ldw, int K,
                                            int m0, int n0) {
  for (int k = 0; k < K; k += 16) {
    FragA fa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], a + (m0 + 16 * i) * lda + k, lda);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, w + size_t(n0 + 16 * j) * ldw + k, ldw);
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
}

template <int FN>
__device__ __forceinline__ void zero(FragC (&acc)[4][FN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// out[m, n] = bf16(relu(acc[m, n] + bias[n])) for the warp's (64, 16*FN)
// block, through a per-warp 16x16 float staging tile (the accumulator's
// register layout is opaque to wmma).
template <int FN>
__device__ __forceinline__ void store_relu(FragC (&acc)[4][FN], float* stage,
                                           const float* __restrict__ bias,
                                           __nv_bfloat16* out, int ldo, int m0, int n0,
                                           int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = n0 + 16 * j + c0;
      __nv_bfloat16* dst = out + (m0 + 16 * i + r) * ldo + col;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = __float2bfloat16_rn(fmaxf(stage[r * 16 + c0 + e] + bias[col + e], 0.0f));
      __syncwarp();
    }
  }
}

// Reference-order embedding [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] of
// `pts` (TP, 3) into a bf16 (TP, cols) tile, zero past 3 * (2 * n_freqs + 1).
__device__ __forceinline__ void embed(const float* pts, int n_freqs, __nv_bfloat16* out,
                                      int ld, int cols) {
  const int used = 3 * (2 * n_freqs + 1);
  for (int idx = threadIdx.x; idx < TP * cols; idx += THREADS) {
    const int p = idx / cols, j = idx % cols;
    float v = 0.0f;
    if (j < 3) {
      v = pts[p * 3 + j];
    } else if (j < used) {
      const int q = j - 3, k = q / 6, r = q % 6;
      const float a = pts[p * 3 + r % 3] * float(1 << k);  // exact power-of-two scale
      v = r < 3 ? sinf(a) : cosf(a);
    }
    out[p * ld + j] = __float2bfloat16_rn(v);
  }
}

template <bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
    nerf_field_kernel(FieldParams prm, const float* __restrict__ xyz,
                      const float* __restrict__ dirs, long long samples_per_dir,
                      float* __restrict__ out, long long n_points) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sh = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_H);
  __nv_bfloat16* sd = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_H + SMEM_X);
  float* stage_all = reinterpret_cast<float*>(smem + SMEM_H + SMEM_X + SMEM_D);
  float* pts = reinterpret_cast<float*>(smem + SMEM_H + SMEM_X + SMEM_D + SMEM_STAGE);
  float* dsm = pts + TP * 3;
  float* sig = dsm + TP * 3;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp >> 2) * 64;
  float* stage = stage_all + warp * 256;
  const long long p0 = (long long)blockIdx.x * TP;

  for (int i = tid; i < TP * 3; i += THREADS) {
    const long long g = p0 * 3 + i;
    pts[i] = g < n_points * 3 ? xyz[g] : 0.0f;
    if (FULL) {
      const long long p = p0 + i / 3;
      dsm[i] = p < n_points ? dirs[(p / samples_per_dir) * 3 + i % 3] : 0.0f;
    }
  }
  __syncthreads();
  embed(pts, 10, sx, LDX, EMB_X);
  if (FULL) embed(dsm, 4, sd, LDD, EMB_D);
  __syncthreads();

  {  // trunk: W-wide layers, activations kept in `sh`
    constexpr int FN = W / 64;
    const int n0 = (warp & 3) * (W / 4);
    FragC acc[4][FN];
    for (int l = 0; l < prm.depth; ++l) {
      zero(acc);
      if (prm.w_h[l]) mma_segment(acc, sh, LDH, prm.w_h[l], W, W, m0, n0);
      if (prm.w_e[l]) mma_segment(acc, sx, LDX, prm.w_e[l], EMB_X, EMB_X, m0, n0);
      __syncthreads();  // every warp has read `sh` before it is overwritten
      store_relu(acc, stage, prm.b[l], sh, LDH, m0, n0, lane);
      __syncthreads();
    }
  }

  // sigma head: two threads per point, each over half of the width
  const int p = tid >> 1, half = tid & 1;
  {
    const __nv_bfloat16* hp = sh + p * LDH + half * (W / 2);
    const __nv_bfloat16* wp = prm.w_sigma + half * (W / 2);
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < W / 2; ++k) s += __bfloat162float(hp[k]) * __bfloat162float(wp[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += prm.b_sigma[0];
    if (!FULL) {
      if (half == 0 && p0 + p < n_points) out[p0 + p] = s;
      return;
    }
    if (half == 0) sig[p] = s;
  }

  {  // direction branch: relu(W_comb h + W_dir demb + b_comb) -> sh[:, :WD]
    constexpr int FN = WD / 64;
    const int n0 = (warp & 3) * (WD / 4);
    FragC acc[4][FN];
    zero(acc);
    mma_segment(acc, sh, LDH, prm.w_comb, W, W, m0, n0);
    mma_segment(acc, sd, LDD, prm.w_dir, EMB_D, EMB_D, m0, n0);
    __syncthreads();
    store_relu(acc, stage, prm.b_comb, sh, LDH, m0, n0, lane);
    __syncthreads();
  }

  {  // rgb head: two threads per point, 3 sums each over half of WD
    const __nv_bfloat16* hp = sh + p * LDH + half * (WD / 2);
    float c[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < WD / 2; ++k) {
      const float h = __bfloat162float(hp[k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        c[ch] += h * __bfloat162float(prm.w_rgb[ch * WD + half * (WD / 2) + k]);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] += __shfl_xor_sync(0xffffffffu, c[ch], 1);
    if (half == 0 && p0 + p < n_points) {
      float* o = out + (p0 + p) * 4;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = 1.0f / (1.0f + expf(-(c[ch] + prm.b_rgb[ch])));
      o[3] = sig[p];
    }
  }
}

}  // namespace

extern "C" {

// Pointer table `ptrs` (device addresses, 0 where absent), 3 * depth + 7 long:
//   w_h[0..depth), w_e[0..depth), b[0..depth),
//   w_sigma, b_sigma, w_comb, w_dir, b_comb, w_rgb, b_rgb.
// xyz: (n_points, 3) f32. dirs: (ceil(n_points / samples_per_dir), 3) f32,
// read only when `full`. out: (n_points, 1) f32 sigma, or (n_points, 4)
// f32 [r, g, b, sigma] when `full`. Returns a cudaError_t value.
int nerf_field_forward(const void* const* ptrs, int depth, int width, const float* xyz,
                       const float* dirs, long long samples_per_dir, float* out,
                       long long n_points, int full, void* stream) {
  if (width != W || depth < 1 || depth > MAX_DEPTH || samples_per_dir < 1 || n_points < 0)
    return int(cudaErrorInvalidValue);
  FieldParams prm = {};
  for (int l = 0; l < depth; ++l) {
    prm.w_h[l] = static_cast<const __nv_bfloat16*>(ptrs[l]);
    prm.w_e[l] = static_cast<const __nv_bfloat16*>(ptrs[depth + l]);
    prm.b[l] = static_cast<const float*>(ptrs[2 * depth + l]);
  }
  const void* const* heads = ptrs + 3 * depth;
  prm.w_sigma = static_cast<const __nv_bfloat16*>(heads[0]);
  prm.b_sigma = static_cast<const float*>(heads[1]);
  prm.w_comb = static_cast<const __nv_bfloat16*>(heads[2]);
  prm.w_dir = static_cast<const __nv_bfloat16*>(heads[3]);
  prm.b_comb = static_cast<const float*>(heads[4]);
  prm.w_rgb = static_cast<const __nv_bfloat16*>(heads[5]);
  prm.b_rgb = static_cast<const float*>(heads[6]);
  prm.depth = depth;
  if (prm.w_e[0] == nullptr || prm.w_h[0] != nullptr) return int(cudaErrorInvalidValue);
  if (n_points == 0) return int(cudaSuccess);

  const long long blocks = (n_points + TP - 1) / TP;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (full) {
    err = cudaFuncSetAttribute(nerf_field_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    nerf_field_kernel<true><<<unsigned(blocks), THREADS, SMEM_BYTES, s>>>(
        prm, xyz, dirs, samples_per_dir, out, n_points);
  } else {
    err = cudaFuncSetAttribute(nerf_field_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return int(err);
    nerf_field_kernel<false><<<unsigned(blocks), THREADS, SMEM_BYTES, s>>>(
        prm, xyz, dirs, samples_per_dir, out, n_points);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
