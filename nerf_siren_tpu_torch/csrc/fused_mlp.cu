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
// cudaGetLastError() so the caller can raise on a refused launch. The tile
// shape, the layer product and the embedding are in nerf_field_common.cuh,
// shared with the training kernels; the heads too, shared with the int8
// field (fused_mlp_int8.cu).

#include "nerf_field_common.cuh"

namespace {

using namespace nerf_field;

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
  HeadParams heads;
  int depth;
};

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
      if (prm.w_h[l]) mma_segment<FN, false>(acc, sh, LDH, prm.w_h[l], W, W, m0, n0);
      if (prm.w_e[l]) mma_segment<FN, false>(acc, sx, LDX, prm.w_e[l], EMB_X, EMB_X, m0, n0);
      __syncthreads();  // every warp has read `sh` before it is overwritten
      store_relu(acc, stage, prm.b[l], sh, LDH, m0, n0, lane);
      __syncthreads();
    }
  }

  eval_heads<FULL>(prm.heads, sh, sd, stage, sig, out, p0, n_points);
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
  prm.heads = head_params(ptrs + 3 * depth);
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
