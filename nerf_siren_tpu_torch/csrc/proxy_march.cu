// The density-proxy kernels for Hopper (sm_90a): the proxy scored on the
// tensor cores over C uniform candidates per ray, then one of three
// epilogues: the march (K3: its opacity prepass and its depth placement)
// or the top-K (K6).
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/proxy_march.py::
// _opacity_kernel (`proxy_opacity`, the culling prepass) and ::_march_kernel
// (`proxy_march_select`), and nerf_siren_tpu/ops/pallas/proxy_select.py::
// _kernel (`proxy_select`). Per ray (o, d, near, far), as the plain PyTorch
// versions nerf_siren_tpu_torch/ops/kernels/proxy_march.py::
// proxy_opacity_ref / proxy_march_select_ref and ops/kernels/proxy_select.py::
// proxy_select_ref:
//   C uniform candidates: for the march z_j = near + j * spacing, spacing =
//   (far - near) / (C - 1); for the top-K z_j = near (1 - t_j) + far t_j,
//   t_j = j / (C - 1) (t = 0 at C = 1, as linspace(0, 1, 1));
//   the density proxy's score at o + d z_j: relu(W1 emb + b1) with the
//   5-frequency embedding emb (33 channels, reference order [x, sin(2^0 x),
//   cos(2^0 x), ...]) and the hidden activations rounded to bf16, float32
//   sums, b1 added in float32 after the product, then w2 . h + b2.
//   The march (OPACITY, SELECT): sigma = expm1(relu(score)), alpha = 1 -
//   exp(-sigma * spacing * |d|), expected weight w_j = alpha * T, T *= 1 -
//   alpha + 1e-10.
//   `proxy_opacity` writes 1 - T after the last candidate.
//   `proxy_march_select` inverts the CDF of the interior weights w[1:-1]
//   (each + 1e-5, cdf_i = S_i / S_total, cdf_0 = 0) over the bins
//   near + (i + 0.5) spacing at u = (k + .5) / K (`midpoint`) or k / (K - 1),
//   with the reference sample_pdf's edges: count of cdf <= u, below/above
//   clamped to the bins, denominators < 1e-5 replaced by 1. It writes the K
//   ascending depths (R, K), the survivors o + d z (R, K, 3) ray-major (one
//   direction per ray for the field kernel), and optionally the landing
//   bin's normalised density dcdf / dz (R, K) and the mass S_total (R,).
//   `proxy_select` (TOPK) writes the depths of the K highest scores in
//   score order (R, K), the lower index first among equal scores.
// The embedding, the candidates and every step of the march and of the
// top-K round exactly as the plain versions'; only the order of the
// proxy's float32 sums differs (the tensor cores' for W1 emb and for
// w2 . h). So a score may differ by float32 rounding, or, where that moves
// a pre-activation across a bf16 rounding step, by one bf16 step of one
// hidden activation; given the same scores the march and the top-K are
// bit for bit the plain ones (`proxy_march_scores_forward` and
// `proxy_select_scores_forward` read the scores back to show it).
//
// Bound: operations. A candidate costs 33 H + H multiply-adds of the proxy
// (H = 96: ~6.5 kFLOP, ~7 us a 32,768-ray chunk at C 32 on the bf16
// tensor cores) against 32 bytes in per ray and 16 K bytes out (4 K for
// the top-K); what is left beside the products is 15 precise sincosf a
// candidate, the bias and conversion of H hidden units, and the epilogue.
//
// Design: one template, three epilogues (OPACITY, SELECT, TOPK).
// - A persistent CTA (one warpgroup) walks blocks of B rays (64 up to C 64,
//   then 32 up to 128, 16 up to 256). Its B x C points are rows p = ray C +
//   j, scored 64 rows at a time; the last tile's rows past the block are
//   padding, scored and dropped.
// - Above 256 candidates the same code runs as a kernel of its own
//   (proxy_march_wide_kernel, so the kernels of C <= 256 keep their code)
//   on blocks of B = max(1, 4096 / C) rays: about 4096 scores a block, down
//   to one ray a block from C 4096. A block's rows of C scores set its
//   shared memory (4 bytes a candidate beside ~19 KB of weights at width
//   128): MAX_CANDIDATES is the largest C whose one-ray block fits the 227
//   KB a block may use, 53,103. CTAs per SM: as many as both the registers
//   (4 up to width 96, 3 at 128: min_ctas) and one CTA's shared memory
//   allow, so 4 / 3 up to C 256 and fewer from some thousands on.
// - Above MAX_CANDIDATES (proxy_march_huge_kernel) a block is one ray
//   whose row of C scores lives in device memory: a scratch of C floats
//   per CTA of the grid (blocks x C, not rays x C), which the wrapper
//   allocates; the grid is at most as many CTAs as the scratch has rows.
//   Scoring, the march and its three passes are the same code on that row
//   (a generic pointer; __syncthreads orders the block's global writes
//   before its reads). The top-K there is not the rank count (C compares
//   a candidate, O(C^2) a ray) but K passes of a block-wide arg-max: pass
//   k takes the best candidate after pass k - 1's in the rank's order (a
//   lower score, or an equal one at a higher index) by (score, then lowest
//   index), so it keeps the same candidates in the same order, O(K C).
// - The embedding is built in registers as wgmma's A (m64nNk16, A from
//   registers, three k16 steps: 33 columns padded to 48). The four threads
//   of a quad hold the same two rows; thread t holds columns 16 s + 8 h +
//   2 t (+ 1) of k-step s, h = 0, 1: six bf16 pairs of each row. The 15
//   angles 2^k (x, y, z)_r (angle q = 3 k + r) split over the quad: thread t
//   takes q = 4 t + i, i < 4, one precise sincosf each (2^4 |x| reaches ~100
//   in the Blender box; never build with --use_fast_math), sin and cos of
//   one angle as the pair i; thread 3's pairs 3 and 4 hold (x, y) and (z, 0).
//   The pack permutes W1's columns to match (ops/kernels/proxy_march.py::
//   k3_columns, the pack's `k3_w1t`), so the embedding is the plain
//   version's bf16 embedding bit for bit.
// - B is W1^T: the pack's `k3_w1t`, (NT, 64) bf16 with NT = H rounded up to
//   a width with a wrapper (16, 32, 64, 96, 128; sm90_async.cuh::wgmma_rs),
//   K-major in the 128-byte swizzle, copied to shared memory once per CTA;
//   w2 (bf16, the second product's B) and b1 (float32) beside it. Padded
//   hidden rows are zero in W1, b1 and w2, so they add exactly 0.
// - The epilogue stays in registers: + b1 in float32, then ReLU and bf16 in
//   one conversion a pair, which lands each pair of hidden activations in
//   the register where the second product's A wants it (the accumulator
//   fragment's layout is the A fragment's); w2 . h is that product, (64 x
//   NT) x (NT x 8) with w2 as B's column 0 (m64n8k16; the product of two
//   bf16 values is exact in float32, only the sum's order differs), + b2.
//   Lanes 0 and 1 of a quad turn rows g and g + 8's scores into the
//   candidates' alphas (expm1f, expf; TOPK keeps the raw score), into
//   row[ray][j] in shared memory, at an odd row stride so that one thread
//   per ray reads a row conflict-free. A warp's 16 points are placed once,
//   by lanes 0-15, and shuffled to the quads that embed them.
// - The march, in three passes over the block, each as the plain march in
//   order and rounding: one thread per ray scans its alphas for T and the
//   running sums S_i (which overwrite the alphas already read); all threads
//   divide the running sums by their ray's S into the CDF; then one thread
//   per (ray, k) places sample k by a binary search for the count of CDF
//   entries <= u (the CDF does not fall, so the count is the plain
//   searchsorted's) and stores its depth, survivor and density, consecutive
//   threads at consecutive addresses. Only the scan is serial, and it is a
//   multiply and an add a candidate; every exp, division and search runs in
//   parallel.
// - The top-K by rank: for each candidate j of its ray a thread counts
//   rank_j = #{i : s_i > s_j or (s_i == s_j and i < j)} over the ray's row,
//   and if rank_j < K stores z_j at z[ray][rank_j]. That is exactly K rounds
//   of (take the highest score, the lowest index among equals, remove it)
//   and a stable descending sort, with no serial rounds, shuffles or
//   reduction order; the threads of a warp that share a ray read each s_i
//   together (a broadcast). A thread ranks RANK_P candidates of one ray at
//   once, so each s_i it reads serves RANK_P compares. C compares a
//   candidate, beside its 33 H + H multiply-adds.
// - A ray's outputs depend on that ray alone, never on its place in the
//   batch: every row is scored by the same code, whatever tile it lands in.
//
// TPU layout tricks not kept: the (8, N) lane-major rays and TILE_R padding
// (any R), the rotation recurrence for sin, the folded [W1s|W1x|b1] stack
// (b1 stays float32), candidate-major survivor order, the (T*S, 4) flat
// candidate block built outside the kernel, the one-hot selection by iota.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FREQS = 5;          // the proxy's embedding frequencies
constexpr int MAX_HIDDEN = 128;
constexpr int K3_MIN_CANDIDATES = 4;  // the march needs two interior candidates
constexpr int THREADS = 128;  // one warpgroup
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can opt into (227 KB)
// CTAs per SM the registers must allow: 4 (128 registers a thread) up to
// width 96, 3 (168) at 128, whose 64 accumulators would spill under 128.
__host__ __device__ constexpr int min_ctas(int nt) { return nt > 96 ? 3 : 4; }
constexpr int TILE = 64;      // rows of one wgmma
constexpr int KSTEPS = 3;     // 48 embedding columns
constexpr int W1T_ROW = 128;  // bytes of one hidden unit's row of the W1^T tile
constexpr int RANK_P = 4;     // candidates a thread of the top-K ranks at once

enum Epilogue { OPACITY = 0, SELECT = 1, TOPK = 2 };

constexpr int WIDE_FROM = 257;  // the candidates from which the wide kernels run

// Rays a block: up to C 256 64, 32 or 16; the wide kernels' about 4096 candidates.
template <bool WIDE>
__host__ __device__ constexpr int rays_per_block(int c) {
  return WIDE ? (c < 4096 ? 4096 / c : 1) : (c <= 64 ? 64 : c <= 128 ? 32 : 16);
}
__host__ __device__ constexpr int row_ld(int c) { return c | 1; }  // odd row stride

// Byte offsets of the shared-memory regions after the W1^T tile at 0 (NT
// rows of 128 bytes): w2 as the second product's B (8 rows of NT, row 0 w2,
// the rest zero; K-major, 128-byte swizzle: 1024 bytes a 64-column block),
// b1 (float32), b2, the block's rays (8 floats each), each ray's spacing,
// spacing |d| and mass S, and its row of C alphas (then running sums, then
// CDF; the top-K's C scores).
struct Layout {
  int w2t, b1, b2, rays, ray_terms, rows, bytes;
};

__host__ __device__ constexpr int w2t_bytes(int nt) { return (nt + 63) / 64 * 1024; }

template <bool WIDE>
__host__ __device__ constexpr Layout layout(int nt, int c) {
  const int b = rays_per_block<WIDE>(c);
  Layout l = {};
  l.w2t = nt * W1T_ROW;  // a multiple of 1024: the swizzle's atoms stay aligned
  l.b1 = l.w2t + w2t_bytes(nt);
  l.b2 = l.b1 + nt * 4;
  l.rays = l.b2 + 16;
  l.ray_terms = l.rays + b * 8 * 4;
  l.rows = l.ray_terms + b * 4 * 4;
  l.bytes = l.rows + b * row_ld(c) * 4;
  return l;
}

constexpr int block_rays(int c) {
  return c >= WIDE_FROM ? rays_per_block<true>(c) : rays_per_block<false>(c);
}

constexpr int shared_bytes(int nt, int c) {
  return 1024 /* alignment slack */ +
         (c >= WIDE_FROM ? layout<true>(nt, c) : layout<false>(nt, c)).bytes;
}

// The largest C whose one-ray block fits SMEM_MAX at the widest hidden
// width: C = 53,103 (ops/kernels/proxy_march.py::MAX_CANDIDATES mirrors it).
constexpr int max_candidates() {
  // one ray a block from C 4096 on: the bytes beside its row, then the floats left for it
  const int fixed = shared_bytes(MAX_HIDDEN, 4096) - 4 * row_ld(4096);
  return ((SMEM_MAX - fixed) / 4 - 1) | 1;  // the largest C with row_ld(C) = C | 1 fitting
}
constexpr int MAX_CANDIDATES = max_candidates();
static_assert(shared_bytes(MAX_HIDDEN, MAX_CANDIDATES) <= SMEM_MAX &&
                  shared_bytes(MAX_HIDDEN, MAX_CANDIDATES + 1) > SMEM_MAX,
              "MAX_CANDIDATES is the largest C whose one-ray block fits");
// The most candidates a ray: row offsets (ray C + j, and the rows of a tile)
// stay within 32 bits.
constexpr int MAX_C = 1 << 30;

// One CTA's dynamic shared memory as launched: above MAX_CANDIDATES the
// huge kernel's, whose row of scores is in device memory.
constexpr int launch_shared_bytes(int nt, int c) {
  return c > MAX_CANDIDATES ? 1024 /* alignment slack */ + layout<true>(nt, c).rows
                            : shared_bytes(nt, c);
}

struct Args {
  const uint4* w1t;  // (NT, 64) bf16: the pack's k3_w1t
  const float* b1;   // (H,)
  const bf16* w2;    // (H,)
  const float* b2;   // (1,)
  int hidden;
  const float* rays;  // (n_rays, 8)
  long long n_rays;
  int C, K, midpoint;
  float* opacity;  // OPACITY: (n_rays,)
  float* z;        // SELECT, TOPK: (n_rays, K); SELECT: (n_rays, K, 3), and (n_rays, K),
                   // (n_rays,) or null
  float* xyz;
  float* rho;
  float* mass;
  float* scores;  // with SCORES: (n_rays, C)
};

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return uint32_t(__bfloat16_as_ushort(h.x)) | (uint32_t(__bfloat16_as_ushort(h.y)) << 16);
}

// bf16(relu(lo)), bf16(relu(hi)) in the low and high halves.
__device__ __forceinline__ uint32_t relu_bf16_pair(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// An output element to device memory.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// o + d * t with two roundings (no contraction to fma), as PyTorch computes it.
__device__ __forceinline__ float along(float o, float d, float t) {
  return __fadd_rn(o, __fmul_rn(d, t));
}

// The top-K's candidate i: near (1 - t) + far t, t = i / max(C - 1, 1),
// rounded as the plain version.
__device__ __forceinline__ float depth_at(float near, float far, int i, int C) {
  const float t = __fdiv_rn(float(i), float(C > 1 ? C - 1 : 1));
  return __fadd_rn(__fmul_rn(near, __fsub_rn(1.0f, t)), __fmul_rn(far, t));
}

// alpha = 1 - exp(-expm1(relu(score)) * spacing |d|), rounded as the plain march.
__device__ __forceinline__ float alpha_of(float score, float dz) {
  return __fsub_rn(1.0f, expf(-__fmul_rn(expm1f(fmaxf(score, 0.0f)), dz)));
}

// Thread t's six bf16 pairs of one point's embedding row: pair i < 4 is
// (sin, cos) of angle q = 4 t + i = 3 k + r, 2^k times coordinate r, while
// q < 15; then (x, y) at thread 3's pair 3, (z, 0) at its pair 4, zeros.
__device__ __forceinline__ void embed_pairs(float x, float y, float z, int t, uint32_t (&pr)[6]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 4 * t + i;
    if (q < 3 * FREQS) {
      const int k = q / 3, r = q - 3 * k;
      const float v = r == 0 ? x : (r == 1 ? y : z);
      float s, c;
      sincosf(v * __int_as_float((127 + k) << 23), &s, &c);  // exact power-of-two scale
      pr[i] = bf16_pair(s, c);
    } else {
      pr[i] = bf16_pair(x, y);
    }
  }
  pr[4] = t == 3 ? bf16_pair(z, 0.0f) : 0u;
  pr[5] = 0u;
}

// The block's nr x C candidates scored into rows_s[ray * ld + j]: as alphas
// for the march, as they are for the top-K; with SCORES the scores also go
// to device memory.
template <int NT, int EPI, bool SCORES>
__device__ __forceinline__ void score_block(const Args& a, long long r0, const float* rays_s,
                                            const float* terms_s, float* rows_s, int nr,
                                            uint32_t w1t_addr, uint32_t w2t_addr,
                                            const float* b1s, float b2, int warp, int lane) {
  const int C = a.C, n_rows = nr * C, ld = row_ld(C), t = lane & 3, g = lane >> 2;
  for (int row0 = 0; row0 < n_rows; row0 += TILE) {
    // lane l < 16 places the warp's row l: its ray (-1 for a padding row,
    // scored and dropped), candidate and point; the quads take theirs by
    // shuffles (thread t of quad g holds rows g and g + 8)
    int ray = -1, j = 0;
    float pt[3] = {0.0f, 0.0f, 0.0f};
    const int p = row0 + warp * 16 + (lane & 15);
    if (p < n_rows) {
      ray = p / C;
      j = p - ray * C;
      const float* ry = rays_s + ray * 8;
      const float zj = EPI == TOPK ? depth_at(ry[6], ry[7], j, C)
                                   : along(ry[6], float(j), terms_s[ray * 4]);
#pragma unroll
      for (int c = 0; c < 3; ++c) pt[c] = along(ry[c], ry[3 + c], zj);
    }
    uint32_t frag[KSTEPS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = g + 8 * h;
      uint32_t pr[6];
      embed_pairs(__shfl_sync(0xffffffffu, pt[0], src), __shfl_sync(0xffffffffu, pt[1], src),
                  __shfl_sync(0xffffffffu, pt[2], src), t, pr);
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        frag[s][h] = pr[2 * s];
        frag[s][h + 2] = pr[2 * s + 1];
      }
    }
    // lane t < 2 of a quad finishes row g + 8 t
    const int ray_t = __shfl_sync(0xffffffffu, ray, g + 8 * (t & 1));
    const int j_t = __shfl_sync(0xffffffffu, j, g + 8 * (t & 1));

    // W1 emb: (64 x 48) x (48 x NT)
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
      sm90::wgmma_rs<NT>(acc, frag[s], sm90::desc_sw128(w1t_addr + 32 * s), s > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc);

    // w2 . h: h = bf16(relu(acc + b1)) is, pair by pair, the A of the
    // second product (64 x NT) x (NT x 8), whose column 0 is the score
    uint32_t hfrag[NT / 16][4];
#pragma unroll
    for (int s = 0; s < NT / 16; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bb = *reinterpret_cast<const float2*>(b1s + 16 * s + 8 * (q >> 1) + 2 * t);
        hfrag[s][q] = relu_bf16_pair(acc[8 * s + 2 * q] + bb.x, acc[8 * s + 2 * q + 1] + bb.y);
      }
    }
    float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < NT / 16; ++s)
      sm90::wgmma_rs<8>(acc2, hfrag[s], sm90::desc_sw128(w2t_addr + (s / 4) * 1024 + (s % 4) * 32),
                        s > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operand(acc2);
    const float up = __shfl_sync(0xffffffffu, acc2[2], lane & ~3);  // row g + 8, column 0
    if (t < 2 && ray_t >= 0) {
      const float sc = __fadd_rn(t == 0 ? acc2[0] : up, b2);
      if (SCORES) a.scores[(r0 + ray_t) * C + j_t] = sc;
      if constexpr (EPI == TOPK) rows_s[ray_t * ld + j_t] = sc;
      else rows_s[ray_t * ld + j_t] = alpha_of(sc, terms_s[ray_t * 4 + 1]);
    }
  }
}

// The march of the block's nr rays over their alphas (see the header).
template <int EPI>
__device__ __forceinline__ void march_block(const Args& a, long long r0, const float* rays_s,
                                            float* terms_s, float* rows_s, int nr, int tid) {
  const int C = a.C, K = a.K, ld = row_ld(C), nb = C - 2;
  if (tid < nr) {  // the scan: T, and S_i over the interior candidates
    float* row = rows_s + tid * ld;
    float T = 1.0f, S = 0.0f;
#pragma unroll 4
    for (int j = 0; j < C; ++j) {
      const float al = row[j];
      if (EPI == SELECT && j >= 1 && j <= C - 2) {
        S = __fadd_rn(S, __fadd_rn(__fmul_rn(al, T), 1e-5f));
        row[j - 1] = S;  // the running sums overwrite the alphas already read
      }
      T = __fmul_rn(T, __fadd_rn(__fsub_rn(1.0f, al), 1e-10f));
    }
    if (EPI == OPACITY) put(a.opacity + r0 + tid, __fsub_rn(1.0f, T));
    if (EPI == SELECT) {
      terms_s[tid * 4 + 2] = S;
      if (a.mass) put(a.mass + r0 + tid, S);
    }
  }
  if (EPI != SELECT) return;
  __syncthreads();
  // cdf_i = S_i / S for i = 1..nb at row[i - 1]; cdf_0 = 0
  for (int i = tid; i < nr * nb; i += THREADS) {
    const int ray = i / nb, m = i - ray * nb;
    rows_s[ray * ld + m] = __fdiv_rn(rows_s[ray * ld + m], terms_s[ray * 4 + 2]);
  }
  __syncthreads();
  // sample k of each ray: cnt = #{i : cdf_i <= u} >= 1, found by bisection
  for (int i = tid; i < nr * K; i += THREADS) {
    const int ray = i / K, k = i - ray * K;
    const float* cdf = rows_s + ray * ld;  // cdf[m] = cdf_{m + 1}
    const float* ry = rays_s + ray * 8;
    const float u = a.midpoint ? __fdiv_rn(float(k) + 0.5f, float(K))
                               : __fdiv_rn(float(k), float(K - 1));
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= u) lo = mid + 1;
      else hi = mid;
    }
    const int below = lo, above = min(lo + 1, nb);
    const float near = ry[6], spacing = terms_s[ray * 4];
    const float cb = below == 0 ? 0.0f : cdf[below - 1], ca = cdf[above - 1];
    const float bb = along(near, float(below) + 0.5f, spacing);
    const float ba = along(near, float(above) + 0.5f, spacing);
    const float dcdf = __fsub_rn(ca, cb);
    const float denom = dcdf < 1e-5f ? 1.0f : dcdf;
    const float zk = __fadd_rn(bb, __fmul_rn(__fdiv_rn(__fsub_rn(u, cb), denom),
                                             __fsub_rn(ba, bb)));
    const long long q = r0 * K + i;  // = (r0 + ray) K + k
    put(a.z + q, zk);
#pragma unroll
    for (int c = 0; c < 3; ++c) put(a.xyz + 3 * q + c, along(ry[c], ry[3 + c], zk));
    if (a.rho) put(a.rho + q, __fdiv_rn(dcdf, fmaxf(__fsub_rn(ba, bb), 1e-7f)));
  }
}

// The top-K of the block's nr rows of C scores: candidate j's rank is the
// count of candidates before it (a higher score, or an equal one at a lower
// index), and the K of rank < K store their depths at their rank. A thread
// ranks RANK_P candidates of one ray at once (j = g + G p), so that each
// score it reads serves RANK_P compares and RANK_P independent counts.
__device__ __forceinline__ void topk_block(const Args& a, long long r0, const float* rays_s,
                                           const float* rows_s, int nr, int tid) {
  const int C = a.C, K = a.K, ld = row_ld(C), G = (C + RANK_P - 1) / RANK_P;
  for (int i = tid; i < nr * G; i += THREADS) {
    const int ray = i / G, g = i - ray * G;
    const float* row = rows_s + ray * ld;
    float s[RANK_P];
    int rank[RANK_P];
#pragma unroll
    for (int p = 0; p < RANK_P; ++p) {
      s[p] = g + G * p < C ? row[g + G * p] : 0.0f;  // past C: ranked, never stored
      rank[p] = 0;
    }
#pragma unroll 4
    for (int m = 0; m < C; ++m) {
      const float v = row[m];
#pragma unroll
      for (int p = 0; p < RANK_P; ++p) rank[p] += int(v > s[p]) | int(v == s[p] && m < g + G * p);
    }
    const float near = rays_s[ray * 8 + 6], far = rays_s[ray * 8 + 7];
#pragma unroll
    for (int p = 0; p < RANK_P; ++p) {
      const int j = g + G * p;
      if (j < C && rank[p] < K) put(a.z + (r0 + ray) * K + rank[p], depth_at(near, far, j, C));
    }
  }
}

// The top-K of one ray above MAX_CANDIDATES, its C scores at `row` in
// device memory: K passes of a block-wide arg-max, pass k taking the best
// candidate (the higher score, the lower index among equals) of those after
// pass k - 1's pick in that order, so pass k picks the candidate of rank k.
__device__ __forceinline__ void topk_argmax(const Args& a, long long ray, const float* rays_s,
                                            const float* row, int tid, float* red_s,
                                            int* red_i) {
  const int C = a.C, K = a.K, warp = tid >> 5, lane = tid & 31;
  float prev_s = 0.0f;
  int prev_i = -1;  // no pick yet: every candidate is after it
  for (int k = 0; k < K; ++k) {
    float best_s = 0.0f;
    int best_i = -1;
    for (int j = tid; j < C; j += THREADS) {
      const float v = row[j];
      const bool after = prev_i < 0 || v < prev_s || (v == prev_s && j > prev_i);
      if (after && (best_i < 0 || v > best_s)) {  // j rises: an equal score keeps the lower index
        best_s = v;
        best_i = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (oi >= 0 && (best_i < 0 || os > best_s || (os == best_s && oi < best_i))) {
        best_s = os;
        best_i = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = best_s;
      red_i[warp] = best_i;
    }
    __syncthreads();
    best_s = red_s[0];
    best_i = red_i[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) {
      const float os = red_s[w];
      const int oi = red_i[w];
      if (oi >= 0 && (best_i < 0 || os > best_s || (os == best_s && oi < best_i))) {
        best_s = os;
        best_i = oi;
      }
    }
    __syncthreads();  // every thread has read this pass's partials
    if (tid == 0) put(a.z + ray * K + k, depth_at(rays_s[6], rays_s[7], best_i, C));
    prev_s = best_s;
    prev_i = best_i;
  }
}

// A persistent CTA's blocks (the kernels below).
template <int NT, int EPI, bool SCORES, bool WIDE>
__device__ __forceinline__ void march_ctas(const Args& a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.C, B = rays_per_block<WIDE>(C);
  const Layout l = layout<WIDE>(NT, C);
  float* b1s = reinterpret_cast<float*>(smem + l.b1);
  float* rays_s = reinterpret_cast<float*>(smem + l.rays);
  float* terms_s = reinterpret_cast<float*>(smem + l.ray_terms);
  float* rows_s = reinterpret_cast<float*>(smem + l.rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The weights, once per CTA; the wgmma reads W1^T and w2 through the
  // async proxy. w2's B: element (n, k) of 64-column block k / 64 at byte
  // 128 n + 2 (k % 64) (row 0 is not swizzled), w2 in row 0.
  for (int i = tid; i < NT * W1T_ROW / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(a.w1t + i);
  unsigned short* w2t = reinterpret_cast<unsigned short*>(smem + l.w2t);
  for (int e = tid; e < w2t_bytes(NT) / 2; e += THREADS) {
    const int n = (e % 512) / 64, k = e / 512 * 64 + e % 64;
    w2t[e] = n == 0 && k < a.hidden ? __bfloat16_as_ushort(a.w2[k]) : 0;
  }
  for (int k = tid; k < NT; k += THREADS) b1s[k] = k < a.hidden ? __ldg(a.b1 + k) : 0.0f;
  sm90::fence_proxy_async();
  __syncthreads();
  const float b2 = __ldg(a.b2);
  const uint32_t w1t_addr = sm90::smem_addr(smem), w2t_addr = w1t_addr + l.w2t;

  const long long n_blocks = (a.n_rays + B - 1) / B;
  for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long long r0 = blk * B;
    const int nr = int(a.n_rays - r0 < B ? a.n_rays - r0 : B);
    for (int i = tid; i < nr * 8; i += THREADS) rays_s[i] = __ldg(a.rays + r0 * 8 + i);
    __syncthreads();
    // the march's spacing = (far - near) / (C - 1) and spacing |d|, as the plain march
    if (EPI != TOPK && tid < nr) {
      const float* ry = rays_s + tid * 8;
      const float spacing = __fdiv_rn(__fsub_rn(ry[7], ry[6]), float(C - 1));
      const float dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(ry[3], ry[3]), __fmul_rn(ry[4], ry[4])),
                                       __fmul_rn(ry[5], ry[5])));
      terms_s[tid * 4] = spacing;
      terms_s[tid * 4 + 1] = __fmul_rn(spacing, dn);
    }
    __syncthreads();
    score_block<NT, EPI, SCORES>(a, r0, rays_s, terms_s, rows_s, nr, w1t_addr, w2t_addr, b1s,
                                 b2, warp, lane);
    __syncthreads();
    if constexpr (EPI == TOPK) {
      topk_block(a, r0, rays_s, rows_s, nr, tid);
    } else {
      march_block<EPI>(a, r0, rays_s, terms_s, rows_s, nr, tid);
    }
    __syncthreads();  // the next block's rays and rows overwrite these
  }
}

template <int NT, int EPI, bool SCORES>
__global__ void __launch_bounds__(THREADS, min_ctas(NT)) proxy_march_kernel(const Args a) {
  march_ctas<NT, EPI, SCORES, false>(a);
}

// C above 256 (WIDE_FROM on): blocks of about 4096 candidates, down to one ray.
template <int NT, int EPI, bool SCORES>
__global__ void __launch_bounds__(THREADS, min_ctas(NT)) proxy_march_wide_kernel(const Args a) {
  march_ctas<NT, EPI, SCORES, true>(a);
}

// C above MAX_CANDIDATES: one ray a block, its row of scores in the CTA's
// row of the scratch (a kernel argument of its own, so Args and the other
// kernels stay as they were); the shared memory holds everything but the
// row.
template <int NT, int EPI, bool SCORES>
__global__ void __launch_bounds__(THREADS, min_ctas(NT))
    proxy_march_huge_kernel(const Args a, float* __restrict__ scratch) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = a.C;
  const Layout l = layout<true>(NT, C);  // one ray a block: rays, terms, then (not here) the row
  float* b1s = reinterpret_cast<float*>(smem + l.b1);
  float* rays_s = reinterpret_cast<float*>(smem + l.rays);
  float* terms_s = reinterpret_cast<float*>(smem + l.ray_terms);
  float* row = scratch + (long long)blockIdx.x * row_ld(C);
  __shared__ float red_s[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < NT * W1T_ROW / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem)[i] = __ldg(a.w1t + i);
  unsigned short* w2t = reinterpret_cast<unsigned short*>(smem + l.w2t);
  for (int e = tid; e < w2t_bytes(NT) / 2; e += THREADS) {
    const int n = (e % 512) / 64, k = e / 512 * 64 + e % 64;
    w2t[e] = n == 0 && k < a.hidden ? __bfloat16_as_ushort(a.w2[k]) : 0;
  }
  for (int k = tid; k < NT; k += THREADS) b1s[k] = k < a.hidden ? __ldg(a.b1 + k) : 0.0f;
  sm90::fence_proxy_async();
  __syncthreads();
  const float b2 = __ldg(a.b2);
  const uint32_t w1t_addr = sm90::smem_addr(smem), w2t_addr = w1t_addr + l.w2t;

  for (long long r0 = blockIdx.x; r0 < a.n_rays; r0 += gridDim.x) {
    if (tid < 8) rays_s[tid] = __ldg(a.rays + r0 * 8 + tid);
    __syncthreads();
    if (EPI != TOPK && tid == 0) {
      const float spacing = __fdiv_rn(__fsub_rn(rays_s[7], rays_s[6]), float(C - 1));
      const float dn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rays_s[3], rays_s[3]),
                                                 __fmul_rn(rays_s[4], rays_s[4])),
                                       __fmul_rn(rays_s[5], rays_s[5])));
      terms_s[0] = spacing;
      terms_s[1] = __fmul_rn(spacing, dn);
    }
    __syncthreads();
    score_block<NT, EPI, SCORES>(a, r0, rays_s, terms_s, row, 1, w1t_addr, w2t_addr, b1s, b2,
                                 warp, lane);
    __syncthreads();
    if constexpr (EPI == TOPK) {
      topk_argmax(a, r0, rays_s, row, tid, red_s, red_i);
    } else {
      march_block<EPI>(a, r0, rays_s, terms_s, row, 1, tid);
    }
    __syncthreads();  // the next ray's rays and row overwrite these
  }
}

int hidden_width(int hidden) {
  return hidden <= 16 ? 16 : hidden <= 32 ? 32 : hidden <= 64 ? 64 : hidden <= 96 ? 96 : 128;
}

// A persistent grid: on every SM as many CTAs as both the registers
// (min_ctas(NT)) and the shared memory of one CTA (with the block's
// reserved share) allow; up to C 256 a CTA takes under 40 KB, so min_ctas.
// One CTA a block where there are fewer blocks. Returns the CTAs, or minus
// a cudaError_t value.
long long grid_ctas(int nt, int c, long long n_blocks) {
  int dev = 0, sms = 0, sm_bytes = 0, reserved = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
          cudaSuccess)
    return -(long long)err;
  const int fit = sm_bytes / (launch_shared_bytes(nt, c) + reserved);
  if (fit < 1) return -(long long)cudaErrorInvalidConfiguration;
  const long long full = (long long)sms * (fit < min_ctas(nt) ? fit : min_ctas(nt));
  return n_blocks < full ? n_blocks : full;
}

// Above MAX_CANDIDATES a block is one ray and a CTA holds one row of the
// scratch (proxy_march_scratch_rows sizes it from the same grid).
template <int NT, int EPI, bool SCORES>
int launch_width(const Args& a, float* scratch, long long scratch_rows, void* stream) {
  const bool huge = a.C > MAX_CANDIDATES;
  void (*kernel)(const Args) = a.C >= WIDE_FROM ? proxy_march_wide_kernel<NT, EPI, SCORES>
                                                : proxy_march_kernel<NT, EPI, SCORES>;
  const void* entry = huge ? reinterpret_cast<const void*>(proxy_march_huge_kernel<NT, EPI, SCORES>)
                           : reinterpret_cast<const void*>(kernel);
  const int smem = launch_shared_bytes(NT, a.C);
  cudaError_t err =
      cudaFuncSetAttribute(entry, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const long long n_blocks = huge ? a.n_rays : (a.n_rays + block_rays(a.C) - 1) / block_rays(a.C);
  long long grid = grid_ctas(NT, a.C, n_blocks);
  if (grid < 0) return int(-grid);
  if (huge && grid > scratch_rows) grid = scratch_rows;  // a CTA a row of the scratch
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (huge)
    proxy_march_huge_kernel<NT, EPI, SCORES><<<unsigned(grid), THREADS, smem, s>>>(a, scratch);
  else
    kernel<<<unsigned(grid), THREADS, smem, s>>>(a);
  return int(cudaGetLastError());
}

template <int EPI, bool SCORES>
int launch(const Args& a, float* scratch, long long scratch_rows, void* stream) {
  switch (hidden_width(a.hidden)) {
    case 16: return launch_width<16, EPI, SCORES>(a, scratch, scratch_rows, stream);
    case 32: return launch_width<32, EPI, SCORES>(a, scratch, scratch_rows, stream);
    case 64: return launch_width<64, EPI, SCORES>(a, scratch, scratch_rows, stream);
    case 96: return launch_width<96, EPI, SCORES>(a, scratch, scratch_rows, stream);
    default: return launch_width<128, EPI, SCORES>(a, scratch, scratch_rows, stream);
  }
}

Args weights(const void* w1t, const void* b1, const void* w2, const void* b2, int hidden,
             const float* rays, long long n_rays, int C) {
  Args a = {};
  a.w1t = static_cast<const uint4*>(w1t);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.hidden = hidden;
  a.rays = rays;
  a.n_rays = n_rays;
  a.C = C;
  return a;
}

// The march takes K3_MIN_CANDIDATES..MAX_C candidates, the top-K 1..MAX_C;
// above MAX_CANDIDATES with a scratch of at least one row of row_ld(C)
// floats (`scratch_rows` rows) when there are rays.
bool valid(int hidden, int n_candidates, long long n_rays, int least = K3_MIN_CANDIDATES) {
  return hidden >= 1 && hidden <= MAX_HIDDEN && n_candidates >= least &&
         n_candidates <= MAX_C && n_rays >= 0;
}

bool scratch_ok(int n_candidates, long long n_rays, const float* scratch, long long rows) {
  return n_candidates <= MAX_CANDIDATES || n_rays == 0 || (scratch != nullptr && rows >= 1);
}

template <bool SCORES>
int select_top_k(const void* w1t, const void* b1, const void* w2, const void* b2, int hidden,
                 const float* rays, long long n_rays, int n_candidates, int n_keep,
                 float* scores, float* z, float* scratch, long long scratch_rows, void* stream) {
  if (!valid(hidden, n_candidates, n_rays, 1) || n_keep < 1 || n_keep > n_candidates ||
      !scratch_ok(n_candidates, n_rays, scratch, scratch_rows))
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  Args a = weights(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates);
  a.K = n_keep;
  a.z = z;
  a.scores = scores;
  return launch<TOPK, SCORES>(a, scratch, scratch_rows, stream);
}

}  // namespace

extern "C" {

// Weights: w1t (NT, 64) bf16, the pack's k3_w1t (NT = hidden rounded up to
// 16, 32, 64, 96 or 128), 16-byte aligned; b1 (hidden,) f32, w2 (hidden,)
// bf16, b2 (1,) f32. rays: (n_rays, 8) f32 [o, d, near, far]. scratch:
// null up to MAX_CANDIDATES (proxy_march_max_candidates), above it
// scratch_rows >= 1 rows of (C | 1) f32, one row a CTA of the grid (at most
// scratch_rows CTAs). Returns a cudaError_t value.

// opacity: (n_rays,) f32.
int proxy_opacity_forward(const void* w1t, const void* b1, const void* w2, const void* b2,
                          int hidden, const float* rays, long long n_rays, int n_candidates,
                          float* opacity, float* scratch, long long scratch_rows, void* stream) {
  if (!valid(hidden, n_candidates, n_rays) ||
      !scratch_ok(n_candidates, n_rays, scratch, scratch_rows))
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  Args a = weights(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates);
  a.opacity = opacity;
  return launch<OPACITY, false>(a, scratch, scratch_rows, stream);
}

// z: (n_rays, n_keep) f32, xyz: (n_rays, n_keep, 3) f32; rho (n_rays,
// n_keep) and mass (n_rays,) f32, or both null.
int proxy_march_select_forward(const void* w1t, const void* b1, const void* w2, const void* b2,
                               int hidden, const float* rays, long long n_rays,
                               int n_candidates, int n_keep, int midpoint, float* z, float* xyz,
                               float* rho, float* mass, float* scratch, long long scratch_rows,
                               void* stream) {
  if (!valid(hidden, n_candidates, n_rays) || n_keep < 2 || (rho == nullptr) != (mass == nullptr) ||
      !scratch_ok(n_candidates, n_rays, scratch, scratch_rows))
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  Args a = weights(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates);
  a.K = n_keep;
  a.midpoint = midpoint;
  a.z = z;
  a.xyz = xyz;
  a.rho = rho;
  a.mass = mass;
  return launch<SELECT, false>(a, scratch, scratch_rows, stream);
}

// The opacity kernel that also stores the scores it marched: scores
// (n_rays, n_candidates) f32, opacity (n_rays,) f32. A reading for the
// tests, not on the renderer's path.
int proxy_march_scores_forward(const void* w1t, const void* b1, const void* w2, const void* b2,
                               int hidden, const float* rays, long long n_rays, int n_candidates,
                               float* scores, float* opacity, float* scratch,
                               long long scratch_rows, void* stream) {
  if (!valid(hidden, n_candidates, n_rays) ||
      !scratch_ok(n_candidates, n_rays, scratch, scratch_rows))
    return int(cudaErrorInvalidValue);
  if (n_rays == 0) return int(cudaSuccess);
  Args a = weights(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates);
  a.opacity = opacity;
  a.scores = scores;
  return launch<OPACITY, true>(a, scratch, scratch_rows, stream);
}

// z: (n_rays, n_keep) f32, the depths of the n_keep highest scores in score
// order; 1 <= n_keep <= n_candidates.
int proxy_select_forward(const void* w1t, const void* b1, const void* w2, const void* b2,
                         int hidden, const float* rays, long long n_rays, int n_candidates,
                         int n_keep, float* z, float* scratch, long long scratch_rows,
                         void* stream) {
  return select_top_k<false>(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates, n_keep,
                             nullptr, z, scratch, scratch_rows, stream);
}

// The top-K kernel that also stores the scores it selected from: scores
// (n_rays, n_candidates) f32, z (n_rays, n_keep) f32. A reading for the
// tests, not on any path.
int proxy_select_scores_forward(const void* w1t, const void* b1, const void* w2, const void* b2,
                                int hidden, const float* rays, long long n_rays,
                                int n_candidates, int n_keep, float* scores, float* z,
                                float* scratch, long long scratch_rows, void* stream) {
  return select_top_k<true>(w1t, b1, w2, b2, hidden, rays, n_rays, n_candidates, n_keep,
                            scores, z, scratch, scratch_rows, stream);
}

// The dynamic shared memory of one CTA of any of the kernels at these
// sizes, in bytes (a reading for the smoke's build report).
int proxy_march_shared_bytes(int hidden, int n_candidates) {
  if (!valid(hidden, n_candidates, 0, 1)) return -1;
  return launch_shared_bytes(hidden_width(hidden), n_candidates);
}

// The most candidates a ray whose row of scores stays in shared memory (one
// ray a block in 227 KB); above it the kernels take a scratch.
int proxy_march_max_candidates() { return MAX_CANDIDATES; }

// The rows of scratch a launch on n_rays rays at these sizes uses on the
// current device: 0 up to MAX_CANDIDATES or without rays, else one per CTA
// of its grid (at most one per ray). Minus a cudaError_t value on failure.
long long proxy_march_scratch_rows(int hidden, int n_candidates, long long n_rays) {
  if (!valid(hidden, n_candidates, n_rays, 1)) return -(long long)cudaErrorInvalidValue;
  if (n_candidates <= MAX_CANDIDATES || n_rays == 0) return 0;
  return grid_ctas(hidden_width(hidden), n_candidates, n_rays);
}

}  // extern "C"
