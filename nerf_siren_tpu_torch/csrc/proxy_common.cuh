// Device code of the density-proxy kernels: the proxy's weights in shared
// memory and its score at one point on the CUDA cores (csrc/proxy_select.cu,
// K6), and the constants and `along` that the proxy march (csrc/
// proxy_march.cu, K3, which scores on the tensor cores) shares.
//
// The proxy (render/fast.py) is a 2-layer MLP on a 5-frequency positional
// encoding: emb (33, reference order [x, sin(2^0 x), cos(2^0 x), ...]) ->
// relu(W1 emb + b1) (hidden H <= 128) -> w2 . h + b2. Operands are bf16 and
// sums float32, as `apply_proxy(..., compute_dtype=bf16)`: the embedding and
// the hidden activations are rounded to bf16, the weights are bf16 values
// held as float32 in shared memory, and each sum runs in input order from 0
// with the bias added last. Products of two bf16 values are exact in
// float32, so an fmaf here rounds exactly as the plain version's separate
// multiply and add (ops/kernels/proxy_march.py::proxy_scores_ref), and the
// two agree bit for bit given the same sinf/cosf.
//
// The build (ops/kernels/_build.py) hashes this header with each source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace proxy {

typedef __nv_bfloat16 bf16;

constexpr int FREQS = 5;
constexpr int IN = 3 * (2 * FREQS + 1);  // 33 embedding channels
constexpr int LDW = 36;                  // floats per hidden row in shared memory (33 + 3 zero)
constexpr int MAX_HIDDEN = 128;

struct Weights {
  const bf16* w1;   // (H, IN), torch layout (out, in)
  const float* b1;  // (H,)
  const bf16* w2;   // (H,)
  const float* b2;  // (1,)
  int hidden;
};

// Floats of shared memory the weights take: W1 (H, LDW), b1, w2, b2 (+ pad).
__host__ __device__ constexpr int weight_floats(int h) { return h * LDW + 2 * h + 4; }

// Every thread of the block copies its share; the caller syncs after.
__device__ __forceinline__ void load_weights(const Weights& w, float* s) {
  const int h = w.hidden;
  for (int i = threadIdx.x; i < h * LDW; i += blockDim.x) {
    const int k = i / LDW, j = i % LDW;
    s[i] = j < IN ? __bfloat162float(w.w1[k * IN + j]) : 0.0f;
  }
  for (int k = threadIdx.x; k < h; k += blockDim.x) {
    s[h * LDW + k] = w.b1[k];
    s[h * LDW + h + k] = __bfloat162float(w.w2[k]);
  }
  if (threadIdx.x == 0) s[h * LDW + 2 * h] = w.b2[0];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// o + d * t with two roundings (no contraction to fma), as PyTorch computes it.
__device__ __forceinline__ float along(float o, float d, float t) {
  return __fadd_rn(o, __fmul_rn(d, t));
}

// Proxy score at (x, y, z). Precise sinf/cosf (never build with
// --use_fast_math): 2^4 |x| reaches ~100 in the Blender box.
__device__ __forceinline__ float score(const float* s, int h, float x, float y, float z) {
  float e[LDW];
  const float c[3] = {x, y, z};
#pragma unroll
  for (int r = 0; r < 3; ++r) e[r] = round_bf16(c[r]);
#pragma unroll
  for (int k = 0; k < FREQS; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float a = c[r] * float(1 << k);  // exact power-of-two scale
      e[3 + 6 * k + r] = round_bf16(sinf(a));
      e[6 + 6 * k + r] = round_bf16(cosf(a));
    }
  }
#pragma unroll
  for (int j = IN; j < LDW; ++j) e[j] = 0.0f;
  const float* b1 = s + h * LDW;
  const float* w2 = b1 + h;
  float out = 0.0f;
#pragma unroll 2
  for (int k = 0; k < h; ++k) {
    const float4* row = reinterpret_cast<const float4*>(s + k * LDW);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < LDW / 4; ++q) {
      const float4 v = row[q];
      acc = fmaf(e[4 * q], v.x, acc);
      acc = fmaf(e[4 * q + 1], v.y, acc);
      acc = fmaf(e[4 * q + 2], v.z, acc);
      acc = fmaf(e[4 * q + 3], v.w, acc);
    }
    out = fmaf(round_bf16(fmaxf(acc + b1[k], 0.0f)), w2[k], out);
  }
  return out + w2[h];
}

}  // namespace proxy
