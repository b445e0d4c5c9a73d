// Fused NeRF training field for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/fused_mlp_train.py::
// _fwd_kernel (fused_train_fwd_t) and ::_bwd_kernel (fused_train_bwd_t).
// The math is that of the plain PyTorch version in
// nerf_siren_tpu_torch/ops/kernels/fused_mlp_train.py (fused_train_fwd_ref /
// fused_train_bwd_ref), on the reference topology: 8 ReLU layers of width
// 256, the skip concat [emb, h] at layer 4, positional encodings of 10 (xyz)
// and 4 (direction) frequencies in reference channel order with precise
// sinf/cosf, and UNFOLDED heads (xyz_final and dir_layer stay separate,
// because their gradients are separate parameters).
//
// Precision (the TPU kernel's): every product takes bf16 operands and
// accumulates in float32; each ReLU output and `feat` are stored as bf16,
// and the backward's ReLU masks come from those bf16 values; every
// cotangent is rounded to bf16 before it enters a product (dgrad and wgrad
// alike); bias gradients sum the float32 cotangents.
//
// Forward (nerf_train_fwd_kernel): one CTA of 8 warps owns TP = 128 points,
// keeps their embeddings and the current activation in shared memory and
// runs every layer on the tensor cores (wmma, bf16 in / f32 out), streaming
// the weights from L2, as csrc/fused_mlp.cu does; output (N, 4) [rgb, sigma].
//
// Backward, three kernels:
//  1. nerf_train_bwd_tile_kernel: per 128-point tile, recompute the
//     forward and write the bf16 activations (emb, demb, h_0..h_7, feat, hd)
//     to a device-memory stash; then run the dgrad chain on the tensor cores
//     (heads -> direction branch -> xyz_final -> trunk, each dz kept in shared
//     memory as the next product's operand), writing each bf16 cotangent
//     slab to the stash and each tile's float32 bias-gradient partial sums
//     to a (tiles, NB) buffer. The eight activations of a tile (512 KB) do
//     not fit the 227 KB of shared memory, so they go to device memory
//     (~10 KB per point, 2 GB at the fine pass of 196,608 points).
//  2. nerf_train_wgrad_kernel: every weight gradient dW = dz^T . a contracts
//     over the points. A split-K tensor-core product: each CTA computes one
//     64x64 tile of one gradient over one slab of points and stores its
//     float32 partial; there is no atomic.
//  3. nerf_train_reduce_kernel: sums the slabs' partials (and the tiles'
//     bias partials) in a fixed order, so gradients are deterministic.
//
// Bound: operations. ~1.19 MFLOP per point forward and ~3x that backward
// (recompute + dgrad + wgrad), against ~40 input/output bytes per point;
// the backward's stash traffic (~10 KB per point written, read back ~4x)
// is the second limit. The ragged tail of N is masked: inputs are not
// padded; the stash is allocated in whole tiles and rows past N carry zero
// cotangents. TMA, wgmma and warp specialisation are left for later work.
//
// Plain C interface, loaded with ctypes; launchers return cudaGetLastError().
// The tile shape, the layer product and the embedding are in
// nerf_field_common.cuh, shared with the eval kernels.

#include "nerf_field_common.cuh"

namespace {

using namespace nerf_field;

constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int HEAD = 16;          // head-cotangent stash columns: [dz_r(3), dz_sigma, 0...]
constexpr int N_JOBS = 14;        // weight-gradient products
constexpr int WG_THREADS = 128;   // wgrad CTA: 4 warps, 2 x 2 of 32x32
constexpr int WG_TILE = 64;

// row of bias-gradient partial sums: b0..b7, b_feat, b_dir, heads
constexpr int B_FEAT = DEPTH * W;
constexpr int B_DIR = B_FEAT + W;
constexpr int B_HEAD = B_DIR + WD;
constexpr int NB = B_HEAD + HEAD;

// shared memory, in bytes; the forward uses the part before SMEM_FWD
constexpr size_t OFF_H = 0;
constexpr size_t OFF_X = OFF_H + size_t(TP) * LDH * 2;
constexpr size_t OFF_D = OFF_X + size_t(TP) * LDX * 2;
constexpr size_t OFF_STAGE = OFF_D + size_t(TP) * LDD * 2;
constexpr size_t OFF_PTS = OFF_STAGE + size_t(THREADS / 32) * 256 * 4;
constexpr size_t OFF_DIRS = OFF_PTS + size_t(TP) * 3 * 4;
constexpr size_t OFF_SIG = OFF_DIRS + size_t(TP) * 3 * 4;
constexpr size_t OFF_RGB = OFF_SIG + size_t(TP) * 4;
constexpr size_t SMEM_FWD = OFF_RGB + size_t(TP) * 3 * 4;
constexpr size_t OFF_DZ = SMEM_FWD;
constexpr size_t OFF_DZS = OFF_DZ + size_t(TP) * LDH * 2;
constexpr size_t OFF_CS = OFF_DZS + size_t(TP) * 4;
constexpr size_t SMEM_BWD = OFF_CS + size_t(2) * W * 4;

struct Weights {
  const bf16* w_h[DEPTH];  // (W, W) hidden-input columns; null for layer 0
  const bf16* w_e[DEPTH];  // (W, EMB_X) embedding columns; set for layers 0 and SKIP only
  const float* b[DEPTH];   // (W,)
  const bf16* w_sigma;     // (W,)
  const float* b_sigma;    // (1,)
  const bf16* w_feat;      // (W, W) xyz_final
  const float* b_feat;     // (W,)
  const bf16* w_dfeat;     // (WD, W) dir_layer's feature columns
  const bf16* w_ddir;      // (WD, EMB_D) dir_layer's direction-embedding columns
  const float* b_dir;      // (WD,)
  const bf16* w_rgb;       // (3, WD)
  const float* b_rgb;      // (3,)
};

struct Grads {             // float32 outputs, same order as Weights
  float* w_h[DEPTH];
  float* w_e[DEPTH];
  float* b[DEPTH];
  float* sigma_rows;       // (HEAD, W): row 3 is d w_sigma
  float* b_sigma;
  float* w_feat;
  float* b_feat;
  float* w_dfeat;
  float* w_ddir;
  float* b_dir;
  float* rgb_rows;         // (HEAD, WD): rows 0..2 are d w_rgb
  float* b_rgb;
};

struct Stash {             // device-memory slabs, n_pad rows each
  bf16* emb;               // (n_pad, EMB_X)
  bf16* demb;              // (n_pad, EMB_D)
  bf16* h[DEPTH];          // (n_pad, W) ReLU outputs
  bf16* feat;              // (n_pad, W)
  bf16* hd;                // (n_pad, WD)
  bf16* dz[DEPTH];         // (n_pad, W) trunk cotangents (masked)
  bf16* dfeat;             // (n_pad, W)
  bf16* dhd;               // (n_pad, WD)
  bf16* dhead;             // (n_pad, HEAD)
  float* bias_part;        // (tiles, NB)
  float* wpart;            // (splits, total) weight-gradient partials
};

struct WJob {              // out (O, I) = dz^T . a over the points
  const bf16* dz;
  const bf16* a;
  float* out;
  long long off;           // offset of this job in a partial row
  int ldz, lda, O, I, tiles_i, tile0;
};

struct WJobs {
  WJob j[N_JOBS];
  long long total;         // floats in one partial row
  int n_tiles;
};

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return bf(__float2bfloat16_rn(v)); }

// Visit the warp's (64, 16*FN) accumulator block element by element through
// its 16x16 float staging tile: f(row, col, value) for rows m0 + .., columns
// n0 + ..; f returns the value to sum into the column sums. Lane l handles
// column l & 15 and rows (l >> 4) * 8 .. + 8 of each 16x16 fragment, and
// lanes 0..15 end with colsum[j] = the sum over the 64 rows of column
// n0 + 16 j + lane, always added in the same order.
template <int FN, class F>
__device__ __forceinline__ void visit(FragC (&acc)[4][FN], float* stage, int m0, int n0,
                                      int lane, float (&colsum)[FN], F f) {
  const int c = lane & 15, rb = (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < FN; ++j) colsum[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e)
        colsum[j] += f(m0 + 16 * i + rb + e, n0 + 16 * j + c, stage[(rb + e) * 16 + c]);
      __syncwarp();
    }
  }
#pragma unroll
  for (int j = 0; j < FN; ++j) colsum[j] += __shfl_xor_sync(0xffffffffu, colsum[j], 16);
}

// The forward of one tile. Leaves hd in sh[:, :WD], raw sigma in sig and
// rgb in rgb (shared memory). With STASH, also writes emb, demb, h_l, feat
// and hd to the stash rows of this tile.
template <bool STASH>
__device__ __forceinline__ void forward_tile(const Weights& prm, const Stash& st,
                                             const float* __restrict__ xyz,
                                             const float* __restrict__ dirs,
                                             long long samples_per_dir, long long n_points,
                                             unsigned char* smem) {
  bf16* sh = reinterpret_cast<bf16*>(smem + OFF_H);
  bf16* sx = reinterpret_cast<bf16*>(smem + OFF_X);
  bf16* sd = reinterpret_cast<bf16*>(smem + OFF_D);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE) + (threadIdx.x >> 5) * 256;
  float* pts = reinterpret_cast<float*>(smem + OFF_PTS);
  float* dsm = reinterpret_cast<float*>(smem + OFF_DIRS);
  float* sig = reinterpret_cast<float*>(smem + OFF_SIG);
  float* rgb = reinterpret_cast<float*>(smem + OFF_RGB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp >> 2) * 64;
  const long long p0 = (long long)blockIdx.x * TP;

  for (int i = tid; i < TP * 3; i += THREADS) {
    const long long p = p0 + i / 3;
    pts[i] = p < n_points ? xyz[p0 * 3 + i] : 0.0f;
    dsm[i] = p < n_points ? dirs[(p / samples_per_dir) * 3 + i % 3] : 0.0f;
  }
  __syncthreads();
  embed(pts, 10, sx, LDX, EMB_X);
  embed(dsm, 4, sd, LDD, EMB_D);
  __syncthreads();
  if (STASH) {
    for (int i = tid; i < TP * EMB_X; i += THREADS)
      st.emb[p0 * EMB_X + i] = sx[(i / EMB_X) * LDX + i % EMB_X];
    for (int i = tid; i < TP * EMB_D; i += THREADS)
      st.demb[p0 * EMB_D + i] = sd[(i / EMB_D) * LDD + i % EMB_D];
  }

  {  // trunk
    constexpr int FN = W / 64;
    const int n0 = (warp & 3) * (W / 4);
    FragC acc[4][FN];
    float cs[FN];
    for (int l = 0; l < DEPTH; ++l) {
      zero(acc);
      if (prm.w_h[l]) mma_segment<FN, false>(acc, sh, LDH, prm.w_h[l], W, W, m0, n0);
      if (prm.w_e[l]) mma_segment<FN, false>(acc, sx, LDX, prm.w_e[l], EMB_X, EMB_X, m0, n0);
      __syncthreads();  // every warp has read `sh` before it is overwritten
      const float* bias = prm.b[l];
      bf16* hst = STASH ? st.h[l] + p0 * W : nullptr;
      visit(acc, stage, m0, n0, lane, cs, [&](int r, int c, float v) {
        const bf16 h = __float2bfloat16_rn(fmaxf(v + bias[c], 0.0f));
        sh[r * LDH + c] = h;
        if (STASH) hst[r * W + c] = h;
        return 0.0f;
      });
      __syncthreads();
    }
  }

  const int p = tid >> 1, half = tid & 1;
  {  // sigma head: two threads per point, each over half of the width
    const bf16* hp = sh + p * LDH + half * (W / 2);
    const bf16* wp = prm.w_sigma + half * (W / 2);
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < W / 2; ++k) s += bf(hp[k]) * bf(wp[k]);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) sig[p] = s + prm.b_sigma[0];
  }

  {  // feat = bf16(W_feat h + b_feat), no nonlinearity
    constexpr int FN = W / 64;
    const int n0 = (warp & 3) * (W / 4);
    FragC acc[4][FN];
    float cs[FN];
    zero(acc);
    mma_segment<FN, false>(acc, sh, LDH, prm.w_feat, W, W, m0, n0);
    __syncthreads();
    bf16* fst = STASH ? st.feat + p0 * W : nullptr;
    visit(acc, stage, m0, n0, lane, cs, [&](int r, int c, float v) {
      const bf16 f = __float2bfloat16_rn(v + prm.b_feat[c]);
      sh[r * LDH + c] = f;
      if (STASH) fst[r * W + c] = f;
      return 0.0f;
    });
    __syncthreads();
  }

  {  // hd = bf16(relu(W_dfeat feat + W_ddir demb + b_dir)) -> sh[:, :WD]
    constexpr int FN = WD / 64;
    const int n0 = (warp & 3) * (WD / 4);
    FragC acc[4][FN];
    float cs[FN];
    zero(acc);
    mma_segment<FN, false>(acc, sh, LDH, prm.w_dfeat, W, W, m0, n0);
    mma_segment<FN, false>(acc, sd, LDD, prm.w_ddir, EMB_D, EMB_D, m0, n0);
    __syncthreads();
    bf16* dst = STASH ? st.hd + p0 * WD : nullptr;
    visit(acc, stage, m0, n0, lane, cs, [&](int r, int c, float v) {
      const bf16 h = __float2bfloat16_rn(fmaxf(v + prm.b_dir[c], 0.0f));
      sh[r * LDH + c] = h;
      if (STASH) dst[r * WD + c] = h;
      return 0.0f;
    });
    __syncthreads();
  }

  {  // rgb head: two threads per point, 3 sums each over half of WD
    const bf16* hp = sh + p * LDH + half * (WD / 2);
    float c[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < WD / 2; ++k) {
      const float h = bf(hp[k]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] += h * bf(prm.w_rgb[ch * WD + half * (WD / 2) + k]);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] += __shfl_xor_sync(0xffffffffu, c[ch], 1);
    if (half == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        rgb[p * 3 + ch] = 1.0f / (1.0f + expf(-(c[ch] + prm.b_rgb[ch])));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    nerf_train_fwd_kernel(Weights prm, const float* __restrict__ xyz,
                          const float* __restrict__ dirs, long long samples_per_dir,
                          float* __restrict__ out, long long n_points) {
  extern __shared__ __align__(128) unsigned char smem[];
  forward_tile<false>(prm, Stash{}, xyz, dirs, samples_per_dir, n_points, smem);
  const float* sig = reinterpret_cast<const float*>(smem + OFF_SIG);
  const float* rgb = reinterpret_cast<const float*>(smem + OFF_RGB);
  const long long p0 = (long long)blockIdx.x * TP;
  for (int i = threadIdx.x; i < TP * 4; i += THREADS) {
    const int p = i >> 2, c = i & 3;
    if (p0 + p < n_points) out[p0 * 4 + i] = c < 3 ? rgb[p * 3 + c] : sig[p];
  }
}

// Write the two warp rows' column sums (cs_sh[2][W]) of `cols` columns into
// this tile's bias-partial row at `at`. Ends with a barrier.
__device__ __forceinline__ void flush_colsums(const float* cs_sh, float* row, int at, int cols) {
  __syncthreads();
  if (threadIdx.x < cols) row[at + threadIdx.x] = cs_sh[threadIdx.x] + cs_sh[W + threadIdx.x];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    nerf_train_bwd_tile_kernel(Weights prm, Stash st, const float* __restrict__ xyz,
                               const float* __restrict__ dirs, long long samples_per_dir,
                               const float* __restrict__ dy, long long n_points) {
  extern __shared__ __align__(128) unsigned char smem[];
  forward_tile<true>(prm, st, xyz, dirs, samples_per_dir, n_points, smem);

  const bf16* sh = reinterpret_cast<const bf16*>(smem + OFF_H);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE) + (threadIdx.x >> 5) * 256;
  float* dzr = reinterpret_cast<float*>(smem + OFF_RGB);  // rgb, then dz_rgb in place
  bf16* sdz = reinterpret_cast<bf16*>(smem + OFF_DZ);
  float* dzs = reinterpret_cast<float*>(smem + OFF_DZS);
  float* cs_sh = reinterpret_cast<float*>(smem + OFF_CS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (warp >> 2) * 64;
  const long long p0 = (long long)blockIdx.x * TP;
  float* brow = st.bias_part + (long long)blockIdx.x * NB;

  // heads: dz_r = dy_rgb * rgb * (1 - rgb), dz_sigma = dy_sigma (zero past N)
  if (tid < TP) {
    const bool valid = p0 + tid < n_points;
    const float* d = dy + (p0 + tid) * 4;
    bf16* hrow = st.dhead + (p0 + tid) * HEAD;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r = dzr[tid * 3 + c];
      const float g = valid ? d[c] * r * (1.0f - r) : 0.0f;
      dzr[tid * 3 + c] = g;
      hrow[c] = __float2bfloat16_rn(g);
    }
    dzs[tid] = valid ? d[3] : 0.0f;
    hrow[3] = __float2bfloat16_rn(dzs[tid]);
    for (int c = 4; c < HEAD; ++c) hrow[c] = __float2bfloat16_rn(0.0f);
  }
  __syncthreads();
  if (tid < 4) {
    float s = 0.0f;
    for (int p = 0; p < TP; ++p) s += tid < 3 ? dzr[p * 3 + tid] : dzs[p];
    brow[B_HEAD + tid] = s;
  }

  {  // direction branch: dz_hd = (hd > 0) * (W_rgb^T bf16(dz_r)), 128 columns
    const int o = tid & (WD - 1), half = tid >> 7;
    const float w0 = bf(prm.w_rgb[o]), w1 = bf(prm.w_rgb[WD + o]), w2 = bf(prm.w_rgb[2 * WD + o]);
    float s = 0.0f;
    for (int r = half * 64; r < half * 64 + 64; ++r) {
      const float g = round_bf(dzr[r * 3]) * w0 + round_bf(dzr[r * 3 + 1]) * w1 +
                      round_bf(dzr[r * 3 + 2]) * w2;
      const float dz = bf(sh[r * LDH + o]) > 0.0f ? g : 0.0f;
      const bf16 b = __float2bfloat16_rn(dz);
      sdz[r * LDH + o] = b;
      st.dhd[(p0 + r) * WD + o] = b;
      s += dz;
    }
    cs_sh[half * W + o] = s;
  }
  flush_colsums(cs_sh, brow, B_DIR, WD);

  constexpr int FN = W / 64;
  const int n0 = (warp & 3) * (W / 4);
  FragC acc[4][FN];
  float cs[FN];
  auto keep_colsums = [&]() {
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < FN; ++j) cs_sh[(m0 / 64) * W + n0 + 16 * j + lane] = cs[j];
    }
  };

  {  // dfeat = W_dfeat^T bf16(dz_hd)
    zero(acc);
    mma_segment<FN, true>(acc, sdz, LDH, prm.w_dfeat, W, WD, m0, n0);
    __syncthreads();
    bf16* out = st.dfeat + p0 * W;
    visit(acc, stage, m0, n0, lane, cs, [&](int r, int c, float v) {
      const bf16 b = __float2bfloat16_rn(v);
      sdz[r * LDH + c] = b;
      out[r * W + c] = b;
      return v;
    });
    keep_colsums();
    flush_colsums(cs_sh, brow, B_FEAT, W);
  }

  // dh_7 = W_feat^T bf16(dfeat) + w_sigma bf16(dz_sigma), masked by h_7;
  // then dh_{l-1} = W_l^T bf16(dz_l), masked by h_{l-1}, for l = 7 .. 1
  for (int l = DEPTH; l >= 1; --l) {
    const bool head = l == DEPTH;
    zero(acc);
    mma_segment<FN, true>(acc, sdz, LDH, head ? prm.w_feat : prm.w_h[l], W, W, m0, n0);
    __syncthreads();
    const bf16* mask = st.h[l - 1] + p0 * W;
    bf16* out = st.dz[l - 1] + p0 * W;
    visit(acc, stage, m0, n0, lane, cs, [&](int r, int c, float v) {
      if (head) v += round_bf(dzs[r]) * bf(prm.w_sigma[c]);
      const float dz = bf(mask[r * W + c]) > 0.0f ? v : 0.0f;
      const bf16 b = __float2bfloat16_rn(dz);
      sdz[r * LDH + c] = b;
      out[r * W + c] = b;
      return dz;
    });
    keep_colsums();
    flush_colsums(cs_sh, brow, (l - 1) * W, W);
  }
}

// One 64x64 tile of one weight gradient over one slab of points:
// part[split][job.off + o * I + i] = sum_p dz[p, o] * a[p, i].
__global__ void __launch_bounds__(WG_THREADS)
    nerf_train_wgrad_kernel(WJobs jobs, float* __restrict__ part, long long slab,
                            long long n_pad) {
  int jid = 0;
#pragma unroll 1
  for (int q = 1; q < N_JOBS; ++q)
    if ((int)blockIdx.x >= jobs.j[q].tile0) jid = q;
  const WJob job = jobs.j[jid];
  const int t = blockIdx.x - job.tile0;
  const int warp = threadIdx.x >> 5;
  const int wo = (t / job.tiles_i) * WG_TILE + (warp >> 1) * 32;
  const int wi = (t % job.tiles_i) * WG_TILE + (warp & 1) * 32;
  const long long k0 = blockIdx.y * slab;
  const long long k1 = k0 + slab < n_pad ? k0 + slab : n_pad;
  bool ok_o[2], ok_i[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    ok_o[a] = wo + 16 * a < job.O;
    ok_i[a] = wi + 16 * a < job.I;
  }
  if (!ok_o[0] || !ok_i[0]) return;  // the warp's block lies past the gradient's edge

  FragC acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);
  for (long long k = k0; k < k1; k += 16) {
    FragAc fa[2];
    FragBr fb[2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      if (ok_o[a]) wmma::load_matrix_sync(fa[a], job.dz + k * job.ldz + wo + 16 * a, job.ldz);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (ok_i[b]) wmma::load_matrix_sync(fb[b], job.a + k * job.lda + wi + 16 * b, job.lda);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (ok_o[a] && ok_i[b]) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
  }
  float* dst = part + blockIdx.y * jobs.total + job.off;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (ok_o[a] && ok_i[b])
        wmma::store_matrix_sync(dst + (long long)(wo + 16 * a) * job.I + wi + 16 * b, acc[a][b],
                                job.I, wmma::mem_row_major);
}

// Sum the slabs' weight partials and the tiles' bias partials in a fixed
// order and write every gradient.
__global__ void nerf_train_reduce_kernel(WJobs jobs, Grads g, const float* __restrict__ part,
                                         int splits, const float* __restrict__ bias_part,
                                         int tiles) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < jobs.total) {
    float s = 0.0f;
    for (int q = 0; q < splits; ++q) s += part[q * jobs.total + e];
    int jid = 0;
#pragma unroll 1
    for (int q = 1; q < N_JOBS; ++q)
      if (e >= jobs.j[q].off) jid = q;
    jobs.j[jid].out[e - jobs.j[jid].off] = s;
  } else if (e < jobs.total + NB) {
    const int b = int(e - jobs.total);
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += bias_part[(long long)t * NB + b];
    if (b < B_FEAT) {
      g.b[b / W][b % W] = s;
    } else if (b < B_DIR) {
      g.b_feat[b - B_FEAT] = s;
    } else if (b < B_HEAD) {
      g.b_dir[b - B_DIR] = s;
    } else if (b < B_HEAD + 3) {
      g.b_rgb[b - B_HEAD] = s;
    } else if (b == B_HEAD + 3) {
      g.b_sigma[0] = s;
    }
  }
}

long long pad_rows(long long n) { return (n + TP - 1) / TP * TP; }

// weight-gradient slabs: up to 32, each at least 1024 points, whole tiles
void split_plan(long long n_pad, long long* slab, int* splits) {
  long long want = n_pad / 1024;
  want = want < 1 ? 1 : (want > 32 ? 32 : want);
  long long s = (n_pad + want - 1) / want;
  s = (s + TP - 1) / TP * TP;
  *slab = s;
  *splits = int((n_pad + s - 1) / s);
}

constexpr long long JOB_TOTAL = (long long)(DEPTH - 1) * W * W + 2LL * W * EMB_X + W * W +
                                (long long)WD * W + WD * EMB_D + HEAD * W + HEAD * WD;

// Carve the workspace at `base` (may be null to size it); returns its bytes.
long long layout(long long n, char* base, Stash* st) {
  const long long n_pad = pad_rows(n);
  long long slab;
  int splits;
  split_plan(n_pad, &slab, &splits);
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  const long long b2 = 2;  // bytes of a bf16
  st->emb = reinterpret_cast<bf16*>(take(n_pad * EMB_X * b2));
  st->demb = reinterpret_cast<bf16*>(take(n_pad * EMB_D * b2));
  for (int l = 0; l < DEPTH; ++l) st->h[l] = reinterpret_cast<bf16*>(take(n_pad * W * b2));
  st->feat = reinterpret_cast<bf16*>(take(n_pad * W * b2));
  st->hd = reinterpret_cast<bf16*>(take(n_pad * WD * b2));
  for (int l = 0; l < DEPTH; ++l) st->dz[l] = reinterpret_cast<bf16*>(take(n_pad * W * b2));
  st->dfeat = reinterpret_cast<bf16*>(take(n_pad * W * b2));
  st->dhd = reinterpret_cast<bf16*>(take(n_pad * WD * b2));
  st->dhead = reinterpret_cast<bf16*>(take(n_pad * HEAD * b2));
  st->bias_part = reinterpret_cast<float*>(take(n_pad / TP * NB * 4));
  st->wpart = reinterpret_cast<float*>(take((long long)splits * JOB_TOTAL * 4));
  return at;
}

Weights read_weights(const void* const* p) {
  Weights w = {};
  for (int l = 0; l < DEPTH; ++l) {
    w.w_h[l] = static_cast<const bf16*>(p[l]);
    w.w_e[l] = static_cast<const bf16*>(p[DEPTH + l]);
    w.b[l] = static_cast<const float*>(p[2 * DEPTH + l]);
  }
  const void* const* q = p + 3 * DEPTH;
  w.w_sigma = static_cast<const bf16*>(q[0]);
  w.b_sigma = static_cast<const float*>(q[1]);
  w.w_feat = static_cast<const bf16*>(q[2]);
  w.b_feat = static_cast<const float*>(q[3]);
  w.w_dfeat = static_cast<const bf16*>(q[4]);
  w.w_ddir = static_cast<const bf16*>(q[5]);
  w.b_dir = static_cast<const float*>(q[6]);
  w.w_rgb = static_cast<const bf16*>(q[7]);
  w.b_rgb = static_cast<const float*>(q[8]);
  return w;
}

bool topology_ok(const Weights& w) {
  for (int l = 0; l < DEPTH; ++l) {
    if ((l == 0) != (w.w_h[l] == nullptr)) return false;
    if ((l == 0 || l == SKIP) != (w.w_e[l] != nullptr)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Weight table `w` (device addresses, 0 where absent), 3 * 8 + 9 long:
//   w_h[0..8) (0 for layer 0), w_e[0..8) (set for layers 0 and 4 only),
//   b[0..8), w_sigma, b_sigma, w_feat, b_feat, w_dfeat, w_ddir, b_dir,
//   w_rgb, b_rgb.
// xyz: (n, 3) f32; dirs: (ceil(n / samples_per_dir), 3) f32, point p takes
// dirs[p / samples_per_dir]; out: (n, 4) f32 [r, g, b, sigma].
// Returns a cudaError_t value.
int nerf_train_forward(const void* const* w, const float* xyz, const float* dirs,
                       long long samples_per_dir, float* out, long long n, void* stream) {
  const Weights prm = read_weights(w);
  if (!topology_ok(prm) || samples_per_dir < 1 || n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  const long long blocks = pad_rows(n) / TP;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(nerf_train_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_FWD));
  if (err != cudaSuccess) return int(err);
  nerf_train_fwd_kernel<<<unsigned(blocks), THREADS, SMEM_FWD, static_cast<cudaStream_t>(stream)>>>(
      prm, xyz, dirs, samples_per_dir, out, n);
  return int(cudaGetLastError());
}

// Bytes of device workspace nerf_train_backward needs for n points.
long long nerf_train_workspace_bytes(long long n) {
  Stash st;
  return layout(n < 0 ? 0 : n, nullptr, &st);
}

// Where nerf_train_backward leaves the forward's bf16 activations in its
// workspace, as byte offsets (12 long): emb (n_pad, EMB_X), demb
// (n_pad, EMB_D), h_0..h_7 (n_pad, W), feat (n_pad, W), hd (n_pad, WD),
// with n_pad = n rounded up to whole tiles of 128 points. Lets a test read
// the kernel's own ReLU masks.
void nerf_train_activation_offsets(long long n, long long* offsets) {
  char* const base = reinterpret_cast<char*>(256);  // any aligned base: only differences count
  Stash st;
  layout(n < 0 ? 0 : n, base, &st);
  const bf16* a[12] = {st.emb, st.demb};
  for (int l = 0; l < DEPTH; ++l) a[2 + l] = st.h[l];
  a[10] = st.feat;
  a[11] = st.hd;
  for (int i = 0; i < 12; ++i) offsets[i] = reinterpret_cast<const char*>(a[i]) - base;
}

// Gradient table `g` (float32 device outputs), in the order of the weight
// table: gw_h[8] (0 for layer 0), gw_e[8] (layers 0 and 4), gb[8],
// sigma_rows (16, 256) whose row 3 is d w_sigma, gb_sigma, gw_feat,
// gb_feat, gw_dfeat, gw_ddir, gb_dir, rgb_rows (16, 128) whose rows 0..2
// are d w_rgb, gb_rgb. dy: (n, 4) f32 cotangent of the forward's output.
// Every gradient is overwritten (not accumulated). Returns a cudaError_t.
int nerf_train_backward(const void* const* w, void* const* g, const float* xyz,
                        const float* dirs, long long samples_per_dir, const float* dy,
                        long long n, void* workspace, long long workspace_bytes,
                        void* stream) {
  const Weights prm = read_weights(w);
  if (!topology_ok(prm) || samples_per_dir < 1 || n < 1) return int(cudaErrorInvalidValue);
  Stash st;
  if (layout(n, static_cast<char*>(workspace), &st) > workspace_bytes)
    return int(cudaErrorInvalidValue);
  Grads gr;
  for (int l = 0; l < DEPTH; ++l) {
    gr.w_h[l] = static_cast<float*>(g[l]);
    gr.w_e[l] = static_cast<float*>(g[DEPTH + l]);
    gr.b[l] = static_cast<float*>(g[2 * DEPTH + l]);
  }
  void* const* q = g + 3 * DEPTH;
  gr.sigma_rows = static_cast<float*>(q[0]);
  gr.b_sigma = static_cast<float*>(q[1]);
  gr.w_feat = static_cast<float*>(q[2]);
  gr.b_feat = static_cast<float*>(q[3]);
  gr.w_dfeat = static_cast<float*>(q[4]);
  gr.w_ddir = static_cast<float*>(q[5]);
  gr.b_dir = static_cast<float*>(q[6]);
  gr.rgb_rows = static_cast<float*>(q[7]);
  gr.b_rgb = static_cast<float*>(q[8]);

  const long long n_pad = pad_rows(n);
  const long long tiles = n_pad / TP;
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  long long slab;
  int splits;
  split_plan(n_pad, &slab, &splits);

  WJobs jobs = {};
  int nj = 0, tile0 = 0;
  long long off = 0;
  auto add = [&](const bf16* dz, int ldz, const bf16* a, int lda, int O, int I, float* out) {
    WJob& j = jobs.j[nj++];
    j.dz = dz; j.ldz = ldz; j.a = a; j.lda = lda; j.O = O; j.I = I; j.out = out;
    j.off = off; j.tile0 = tile0;
    j.tiles_i = (I + WG_TILE - 1) / WG_TILE;
    tile0 += ((O + WG_TILE - 1) / WG_TILE) * j.tiles_i;
    off += (long long)O * I;
  };
  add(st.dz[0], W, st.emb, EMB_X, W, EMB_X, gr.w_e[0]);
  for (int l = 1; l < DEPTH; ++l) add(st.dz[l], W, st.h[l - 1], W, W, W, gr.w_h[l]);
  add(st.dz[SKIP], W, st.emb, EMB_X, W, EMB_X, gr.w_e[SKIP]);
  add(st.dfeat, W, st.h[DEPTH - 1], W, W, W, gr.w_feat);
  add(st.dhd, WD, st.feat, W, WD, W, gr.w_dfeat);
  add(st.dhd, WD, st.demb, EMB_D, WD, EMB_D, gr.w_ddir);
  add(st.dhead, HEAD, st.h[DEPTH - 1], W, HEAD, W, gr.sigma_rows);
  add(st.dhead, HEAD, st.hd, WD, HEAD, WD, gr.rgb_rows);
  if (nj != N_JOBS || off != JOB_TOTAL) return int(cudaErrorInvalidValue);
  jobs.total = off;
  jobs.n_tiles = tile0;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(nerf_train_bwd_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(SMEM_BWD));
  if (err != cudaSuccess) return int(err);
  nerf_train_bwd_tile_kernel<<<unsigned(tiles), THREADS, SMEM_BWD, s>>>(
      prm, st, xyz, dirs, samples_per_dir, dy, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  nerf_train_wgrad_kernel<<<dim3(unsigned(jobs.n_tiles), unsigned(splits)), WG_THREADS, 0, s>>>(
      jobs, st.wpart, slab, n_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long elems = jobs.total + NB;
  nerf_train_reduce_kernel<<<unsigned((elems + 255) / 256), 256, 0, s>>>(
      jobs, gr, st.wpart, splits, st.bias_part, int(tiles));
  return int(cudaGetLastError());
}

}  // extern "C"
