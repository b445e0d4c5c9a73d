// Constants shared by the NeRF field kernels: the trunk and direction-branch
// widths, the embedding widths (zero-padded), the tile of TP points, and the
// eval field's head pointers. The eval fields (csrc/fused_mlp.cu,
// csrc/fused_mlp_int8.cu) keep their shared device code in
// nerf_field_sm90.cuh; the training field (csrc/fused_mlp_train.cu) takes
// the widths, TP and that header's ring and layout helpers.
//
// The build (ops/kernels/_build.py) hashes this header with each source, so
// an edit here rebuilds every library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf_field {

typedef __nv_bfloat16 bf16;

constexpr int W = 256;            // trunk width of K2; the eval fields' default (they take 128-512)
constexpr int WD = W / 2;         // direction-branch width
constexpr int TP = 128;           // points per tile
constexpr int EMB_X = 64;         // 63 xyz-embedding channels + 1 zero column
constexpr int EMB_D = 32;         // 27 direction-embedding channels + 5 zero columns

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
