// Device code shared by the NeRF field kernels: the training field
// (csrc/fused_mlp_train.cu) uses all of it: the tile shape, the
// shared-memory row layout, the tensor-core product over one layer and the
// positional encoding. One CTA of THREADS threads owns a tile of TP points;
// its 8 warps split the tile as 2 (rows of 64 points) x 4 (column slices).
// The eval fields (csrc/fused_mlp.cu, csrc/fused_mlp_int8.cu) take only the
// widths, TP and the head pointers; their shared device code is in
// nerf_field_sm90.cuh.
//
// The build (ops/kernels/_build.py) hashes this header with each source, so
// an edit here rebuilds every library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace nerf_field {

using namespace nvcuda;

typedef __nv_bfloat16 bf16;

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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int FN>
__device__ __forceinline__ void zero(FragC (&acc)[4][FN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc[i][j] += A[m0+16i.., k] * B[k, n0+16j..] over k < K. A: (TP, K) bf16
// row-major tile in shared memory. ROW_B false: B(k, n) = w[n * ldw + k], a
// torch-layout (out, in) weight in global memory read as its transpose (the
// forward); ROW_B true: B(k, n) = w[k * ldw + n], the same weight itself
// (the backward's dgrad).
template <int FN, bool ROW_B>
__device__ __forceinline__ void mma_segment(FragC (&acc)[4][FN], const bf16* a, int lda,
                                            const bf16* w, int ldw, int K, int m0, int n0) {
  for (int k = 0; k < K; k += 16) {
    FragA fa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(fa[i], a + (m0 + 16 * i) * lda + k, lda);
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if (ROW_B) {
        FragBr fb;
        wmma::load_matrix_sync(fb, w + size_t(k) * ldw + n0 + 16 * j, ldw);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      } else {
        FragBc fb;
        wmma::load_matrix_sync(fb, w + size_t(n0 + 16 * j) * ldw + k, ldw);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
}

// Reference-order embedding [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] of
// `pts` (TP, 3) into a bf16 (TP, cols) tile, zero past 3 * (2 * n_freqs + 1).
// Precise sinf/cosf: arguments reach 2^9|x| ~ 2000-5000, where the fast
// intrinsics lose accuracy; never build with --use_fast_math.
__device__ __forceinline__ void embed(const float* pts, int n_freqs, bf16* out, int ld,
                                      int cols) {
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

// The eval field's heads, bf16 operands with float32 sums (the W_comb fold of
// xyz_final into dir_layer is done at pack time).
struct HeadParams {
  const bf16* w_sigma;  // (W,)
  const float* b_sigma; // (1,)
  const bf16* w_comb;   // (WD, W) xyz_final folded into dir_layer
  const bf16* w_dir;    // (WD, EMB_D)
  const float* b_comb;  // (WD,)
  const bf16* w_rgb;    // (3, WD)
  const float* b_rgb;   // (3,)
};

// The head pointers at the end of a field's pointer table (the order the
// wrappers in ops/kernels/ pass them): w_sigma, b_sigma, w_comb, w_dir,
// b_comb, w_rgb, b_rgb.
inline HeadParams head_params(const void* const* heads) {
  HeadParams h;
  h.w_sigma = static_cast<const bf16*>(heads[0]);
  h.b_sigma = static_cast<const float*>(heads[1]);
  h.w_comb = static_cast<const bf16*>(heads[2]);
  h.w_dir = static_cast<const bf16*>(heads[3]);
  h.b_comb = static_cast<const float*>(heads[4]);
  h.w_rgb = static_cast<const bf16*>(heads[5]);
  h.b_rgb = static_cast<const float*>(heads[6]);
  return h;
}

}  // namespace nerf_field
