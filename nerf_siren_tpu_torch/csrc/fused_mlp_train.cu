// Fused NeRF training field for Hopper (sm_90a): forward and backward (K2).
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/fused_mlp_train.py::
// _fwd_kernel (fused_train_fwd_t) and ::_bwd_kernel (fused_train_bwd_t).
// The math is that of the plain PyTorch version in
// nerf_siren_tpu_torch/ops/kernels/fused_mlp_train.py (fused_train_fwd_ref /
// fused_train_bwd_ref), on the reference topology: 8 ReLU layers of width
// 256, the skip concat [emb, h] at layer 4, positional encodings of 10 (xyz)
// and 4 (direction) frequencies in reference channel order with precise
// sin/cos, and UNFOLDED heads (xyz_final and dir_layer stay separate,
// because their gradients are separate parameters).
//
// Precision (the TPU kernel's): every product takes bf16 operands and
// accumulates in float32; each ReLU output and `feat` are stored as bf16,
// and the backward's ReLU masks come from those bf16 values; every
// cotangent is rounded to bf16 before it enters a product (dgrad and wgrad
// alike); bias gradients sum the float32 cotangents, and every sum over
// points is taken in a fixed order, so two calls give the same bits.
//
// Forward (nerf_train_fwd_tile_kernel): (N, 4) [rgb, sigma] for N points,
// 593,408 multiply-adds a point, bound by its operations (0.315 ms a
// training step of 65,536 + 196,608 points at the dense bf16 peak; the
// weights are 1.2 MB, read from L2). It is the backward's tile kernel (1.
// below) in its forward mode: the same persistent grid, producer and ring,
// which streams only the recompute's prefix of `k2_stream` (39 slices) and
// has a fourth stage in place of the ReLU masks; the consumers run the
// recompute's own code (embeddings, layer products, epilogues), so h_l,
// feat and hd are the backward's bit for bit, and the ReLU masks the
// backward differentiates are those of the output the loss saw. The heads
// stay in registers: sigma from layer 7's epilogue (each thread dots its
// 64 columns of rows r and r + 8 with w_sigma; a quad sum closes the row),
// rgb from the direction branch's; one float4 store a point. Nothing is
// stashed, no mask is kept and no cotangent is formed.
//
// Backward: every parameter gradient for N points. Per point it recomputes
// the forward (593,408 multiply-adds), runs the dgrad chain (557,696) and
// the weight gradients (593,408): 0.915 TFLOP per training step of 65,536 +
// 196,608 points, 0.925 ms at the dense bf16 peak. That is the function's
// bound (operations). The design adds bytes of its own: the tile kernel
// writes the activations and cotangents the weight gradients contract over
// to a device-memory stash (9,952 bytes a point, 2.6 GB a step), and the
// weight gradients read them back (15,776 bytes a point as counted, some
// of it served by L2): 6.7 GB, a byte floor of ~2.0 ms at 3.35 TB/s, above
// the operations bound. So the design keeps everything else on chip and
// overlaps the stash's traffic with the products. Three kernels:
//  1. nerf_train_bwd_tile_kernel, on the eval field K1's skeleton
//     (csrc/fused_mlp.cu): a persistent grid over 128-point tiles; a
//     producer warpgroup bulk-copies the pack's `k2_stream` (every weight
//     slice of the recompute, then of the dgrad chain cut from W^T, each
//     pre-swizzled for wgmma; ops/kernels/fused_mlp_train.py::k2_schedule)
//     through a 3-stage ring, with an L2 evict_last policy; two consumer
//     warpgroups of 64 points run wgmma m64n256k16 (m64n128k16 in the
//     direction branch). Activations and cotangents live in shared memory
//     feature-major (one 128-byte row of 64 points per feature, the 128-byte
//     swizzle), so the same tile is the next product's A operand (wgmma
//     reads it M-major) and, byte for byte, the stash block the weight
//     gradients read: each is stored with one bulk copy (shared -> global,
//     L2 evict_first: 2.6 GB must not push the weight stream out of L2)
//     under the next layer's products. Epilogues write the accumulators
//     there with stmatrix .trans. The eight ReLU masks stay on chip as bits
//     (16 bytes a thread a layer, 32 KB a tile), so the dgrad chain reads no
//     activation back. Bias gradients: each warp sums its accumulator
//     columns over its rows (a reduce-scatter over the lanes that share a
//     column) and adds them, with reductions it does not wait for, to its
//     own row of partials, which only it touches: a fixed order. Shared
//     memory: 64 KB activations, 16 + 8 KB embeddings, 32 KB masks, 96 KB
//     ring.
//  2. nerf_train_wgrad_kernel: dW = dz^T a over the points, a GEMM whose
//     operands are stash blocks, both K-major (K = the 64 points of a
//     block), so each stage of its 4-stage ring is two 1-D bulk copies (a
//     128-row slice of one operand, all rows of the other). Two consumer
//     warpgroups run wgmma m64nNk16 into 128 x N float32 tiles (N = 256,
//     64, 32 or 16: the head gradients are computed transposed, with the
//     16 head cotangents as the narrow operand). The point blocks are split
//     into up to 32 slabs (~800 CTAs of 25 row tiles); the row tiles of one
//     job and slab are neighbours in the grid, so the operand they share is
//     read from device memory once and from L2 once. Each CTA stores its
//     float32 partial; there is no atomic.
//  3. nerf_train_reduce_kernel: sums the slabs' weight partials and the
//     tile kernel's CTAs' bias partials in a fixed order and writes every
//     gradient.
// The ragged tail of N is masked: inputs are not padded; the stash is
// allocated in whole tiles and rows past N carry zero cotangents.
//
// The stash layout (its plain version: ops/kernels/fused_mlp_train.py::
// block_stash): an array of F features is a sequence of blocks of 64
// points; block b is F rows of 128 bytes (row f: the 64 points' values of
// feature f), 16-byte chunk j of row f stored at chunk j ^ (f % 8). Point
// p, feature f is bf16 element 64 F (p / 64) + 64 f + 8 (((p % 64) / 8) ^
// (f % 8)) + p % 8 of the array.
//
// Plain C interface, loaded with ctypes; launchers return cudaGetLastError().
// The widths and the tile size are in nerf_field_common.cuh, the ring's
// position in nerf_field_sm90.cuh, the PTX wrappers in sm90_async.cuh.

#include "nerf_field_common.cuh"
#include "nerf_field_sm90.cuh"
#include "sm90_async.cuh"

namespace {

using namespace nerf_field;

constexpr int DEPTH = 8;
constexpr int SKIP = 4;
constexpr int HEAD = 16;          // head-cotangent stash features: [dz_r(3), dz_sigma, 0...]
constexpr int N_JOBS = 14;        // weight-gradient products

// row of bias-gradient partial sums: b0..b7, b_feat, b_dir, heads
constexpr int B_FEAT = DEPTH * W;
constexpr int B_DIR = B_FEAT + W;
constexpr int B_HEAD = B_DIR + WD;
constexpr int NB = B_HEAD + HEAD;

// ---- the tile kernel's shape (forward and backward) ---------------------------
constexpr int KS = 64;                           // inputs per weight slice (one swizzle row)
constexpr int SLICE_BYTES = W * KS * 2;          // a slice of 256 rows, 32 KB
constexpr int DSLICE_BYTES = WD * KS * 2;        // a direction-branch slice of 128 rows
constexpr int FWD_SLICES = 1 + (DEPTH - 1) * (W / KS) + 1 + W / KS;  // trunk 30, W_feat 4
constexpr int DIR_SLICES = W / KS + 1;           // W_dfeat's 4, W_ddir's 1 (DSLICE_BYTES)
// W_dfeat^T's, W_feat^T's, W_7^T's .. W_1^T's
constexpr int BWD_SLICES = WD / KS + W / KS + (DEPTH - 1) * (W / KS);
constexpr int STREAM_SLICES = FWD_SLICES + DIR_SLICES + BWD_SLICES;
constexpr long long STREAM_ELEMS =
    (long long)(FWD_SLICES + BWD_SLICES) * W * KS + (long long)DIR_SLICES * WD * KS;
// the recompute's prefix of the stream, all that the forward reads
constexpr long long FWD_STREAM_ELEMS =
    (long long)FWD_SLICES * W * KS + (long long)DIR_SLICES * WD * KS;
constexpr int CONSUMERS = 2;                     // consumer warpgroups of 64 points
constexpr int T_THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;                   // one feature of 64 points
constexpr int ACT_BYTES = W * ROW_BYTES;         // a warpgroup's 64 points x 256 features
constexpr int KSLICE_BYTES = KS * ROW_BYTES;     // 64 features of the activations
constexpr int KSTEP_BYTES = 16 * ROW_BYTES;      // one k16 step of an M-major A operand
constexpr int T_OFF_X = CONSUMERS * ACT_BYTES;
constexpr int T_OFF_D = T_OFF_X + CONSUMERS * EMB_X * ROW_BYTES;
constexpr int T_OFF_MASK = T_OFF_D + CONSUMERS * EMB_D * ROW_BYTES;
constexpr int WARP_ROWS = CONSUMERS * 4;         // bias-partial rows per CTA: one per consumer warp

// The tile kernel in its forward mode (FWD) or its backward mode: the slices
// of the stream a tile takes, the ring's stages and the shared memory. The
// forward keeps no ReLU masks (32 KB), so its ring has a fourth stage there.
template <bool FWD>
struct Tile {
  static constexpr int SLICES = FWD ? FWD_SLICES + DIR_SLICES : STREAM_SLICES;
  static constexpr int STAGES = FWD ? 4 : 3;
  static constexpr int OFF_RING = T_OFF_MASK + (FWD ? 0 : DEPTH * CONSUMERS * 128 * 16);
  static constexpr int OFF_BARS = OFF_RING + STAGES * SLICE_BYTES;
  static constexpr int SMEM = 1024 /* alignment slack */ + OFF_BARS + 2 * STAGES * 8;
  using Ring = StageRing<STAGES, SLICE_BYTES>;
};

// ---- the weight-gradient GEMM's shape --------------------------------------
constexpr int G_STAGES = 4;
constexpr int G_M = 128;                         // gradient rows per CTA: 64 per consumer warpgroup
constexpr int G_A_BYTES = G_M * ROW_BYTES;
constexpr int G_STAGE_BYTES = G_A_BYTES + W * ROW_BYTES;
constexpr int G_THREADS = 128 * (CONSUMERS + 1);
constexpr int G_SMEM = 1024 + G_STAGES * G_STAGE_BYTES + 2 * G_STAGES * 8;

static_assert(Tile<true>::SMEM <= 232448 && Tile<false>::SMEM <= 232448 && G_SMEM <= 232448,
              "shared memory per block");

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

struct Stash {             // device-memory arrays of n_pad points, blocked (header)
  bf16* emb;               // EMB_X features
  bf16* demb;              // EMB_D
  bf16* h[DEPTH];          // W: ReLU outputs
  bf16* feat;              // W
  bf16* hd;                // WD
  bf16* dz[DEPTH];         // W: trunk cotangents (masked)
  bf16* dfeat;             // W
  bf16* dhd;               // WD
  bf16* dhead;             // HEAD
  float* bias_part;        // (bias rows, NB)
  float* wpart;            // (splits, JOB_TOTAL) weight-gradient partials
};

// out[m * out_sm + n * out_sn] = sum over the points of a[p, m] * b[p, n],
// for m < m_rows (a has that many features), n < n (b's features)
struct GJob {
  const bf16* a;
  const bf16* b;
  float* out;
  long long off;           // offset of this job in a partial row
  int m_rows, n, out_sm, out_sn, tile0;
};

struct GJobs {
  GJob j[N_JOBS];
  long long total;         // floats in one partial row
  long long blocks, slab;  // 64-point blocks of the stash, blocks per slab
  int splits, n_tiles;
};

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return bf(__float2bfloat16_rn(v)); }

// ---- the tile kernel: the forward, or the backward's recompute + dgrad ------

__device__ __forceinline__ void st_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void ld_v4(uint32_t addr, uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

// Address of (feature f, point r) in a feature-major swizzled tile whose
// rows (one per feature, 64 points) start at `rows` (1024-byte aligned).
__device__ __forceinline__ uint32_t fm_addr(uint32_t rows, int f, int r) {
  return rows + f * ROW_BYTES + ((((r >> 3) ^ f) & 7) << 4) + (r & 7) * 2;
}

// This lane's stmatrix .trans address for n8 groups g and g + 1 of a
// warpgroup's 64 x N accumulator fragment stored feature-major at `rows`:
// matrix q = lane / 8 is (rows 8 (q % 2) .. + 8 of the warp's 16, group
// g + q / 2), and its column j = lane % 8 is feature 8 (g + q / 2) + j.
__device__ __forceinline__ uint32_t stm_addr(uint32_t rows, int g, int warp, int lane) {
  const int q = lane >> 3, j = lane & 7;
  const int f = 8 * (g + (q >> 1)) + j;
  return rows + f * ROW_BYTES + (((2 * warp + (q & 1)) ^ j) << 4);
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  return bf162_bits(__floats2bfloat162_rn(a, b));
}

// Reference-order embedding [x, sin(2^0 x), cos(2^0 x), ...] of point x
// into column r of a feature-major tile of COLS features, zero past
// 3 (2 N_FREQS + 1); the two threads of a point split the frequencies.
template <int N_FREQS, int COLS>
__device__ __forceinline__ void embed_col(uint32_t rows, const float (&x)[3], int r, int half) {
  static_assert(N_FREQS % 2 == 0, "the two threads of a point take half of the frequencies each");
  constexpr int USED = 3 * (2 * N_FREQS + 1);
  auto put = [&](int f, float v) {
    sm90::st_b16(fm_addr(rows, f, r), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  };
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) put(j, x[j]);
  } else {
#pragma unroll
    for (int f = USED; f < COLS; ++f) put(f, 0.0f);
  }
#pragma unroll 1
  for (int kk = 0; kk < N_FREQS / 2; ++kk) {
    const int k = half * (N_FREQS / 2) + kk;
    const float scale = float(1 << k);  // exact power-of-two scale
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s, c;
      sincosf(x[j] * scale, &s, &c);
      put(3 + 6 * k + j, s);
      put(6 + 6 * k + j, c);
    }
  }
}

// One slot (a layer's products): acc = sum over n_slices ring slices of
// A_j (this warpgroup's 64 points x 64 features, feature-major at
// a_rows(j), read M-major) x slice_j; the last slice takes k_last k16
// steps. Keeps two slices' products in flight and releases each stage once
// its products have retired; on return every product has completed.
template <int N, typename Ring, typename ARows>
__device__ __forceinline__ void run_slot(float (&acc)[N / 2], Ring& ring, int n_slices,
                                         ARows a_rows, int k_last, int lane) {
  int held = -1;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int j = 0; j < n_slices; ++j) {
    sm90::mbar_wait(ring.full(), ring.phase);
    const uint32_t a = a_rows(j), b = ring.slot();
    const int ks = j + 1 < n_slices ? KS / 16 : k_last;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if (kk < ks) {
        const uint64_t da = sm90::desc_sw128(a + KSTEP_BYTES * kk);
        const uint64_t db = sm90::desc_sw128(b + 32 * kk);
        if constexpr (N == W)
          sm90::wgmma_m64n256k16<1>(acc, da, db, j > 0 || kk > 0);
        else
          sm90::wgmma_m64n128k16<1>(acc, da, db, j > 0 || kk > 0);
      }
    }
    sm90::wgmma_commit();
    sm90::fence_operand(acc);
    sm90::wgmma_wait<1>();
    sm90::fence_operand(acc);
    if (held >= 0 && lane == 0) sm90::mbar_arrive(ring.empty(held));
    held = ring.stage;
    ring.advance();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);
  if (lane == 0) sm90::mbar_arrive(ring.empty(held));
}

// One step of colsum_out's reduce-scatter: lanes across `BIT` trade halves
// of their first 2 WIDTH sums, each keeping WIDTH.
template <int WIDTH, int BIT, int C>
__device__ __forceinline__ void scatter_step(float (&cs)[C], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) {
    const float recv = __shfl_xor_sync(0xffffffffu, up ? cs[k] : cs[k + WIDTH], BIT);
    cs[k] = (up ? cs[k + WIDTH] : cs[k]) + recv;
  }
}

// Into a warp's row of bias partials (zeroed before the launch), a running
// sum over its CTA's tiles, added with a reduction the thread does not wait
// for. Only this lane ever adds to the address, so the order of the sums
// is fixed.
__device__ __forceinline__ void bias_add(float* p, float v) { atomicAdd(p, v); }

// Column sums of a warp's 16 rows into its row of bias partials: cs[2 g + b]
// is this thread's two-row sum of column 8 g + 2 (lane % 4) + b. A
// reduce-scatter over the 8 lanes that share lane % 4 (xor 16, 8, 4) leaves
// each lane C / 8 of the warp's column sums, which it adds to brow[at +
// column] (bias_add).
template <int C>
__device__ __forceinline__ void colsum_out(float (&cs)[C], float* __restrict__ brow, int at,
                                           int lane) {
  scatter_step<C / 2, 16>(cs, lane);
  scatter_step<C / 4, 8>(cs, lane);
  scatter_step<C / 8, 4>(cs, lane);
  const int base = (lane & 16 ? C / 2 : 0) + (lane & 8 ? C / 4 : 0) + (lane & 4 ? C / 8 : 0);
#pragma unroll
  for (int k = 0; k < C / 8; ++k) {
    const int idx = base + k;
    bias_add(brow + at + 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1), cs[k]);
  }
}

// Forward epilogue of a 64 x W fragment: bf16(acc + bias), after ReLU when
// RELU, stored feature-major at `act`. MASKS: the ReLU mask bits (bit
// 4 (g % 8) + e of word g / 8 for element 4 g + e) go to this thread's 16
// bytes at mask_slot. SIGMA: s0 / s1 gain the dot of the thread's columns of
// its rows r and r + 8 (the stored bf16 values) with w_sigma.
template <bool RELU, bool MASKS, bool SIGMA>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[W / 2],
                                             const float* __restrict__ bias, uint32_t act,
                                             uint32_t mask_slot, const bf16* __restrict__ w_sigma,
                                             float& s0, float& s1, int warp, int lane) {
  static_assert(RELU || !MASKS, "masks are those of a ReLU");
  const int cq = 2 * (lane & 3);
  uint32_t m[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int g = 0; g < W / 8; g += 2) {
    uint32_t r[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gg = g + h;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * gg + cq));
      float x0 = acc[4 * gg] + bb.x, x1 = acc[4 * gg + 1] + bb.y;
      float x2 = acc[4 * gg + 2] + bb.x, x3 = acc[4 * gg + 3] + bb.y;
      if (RELU) {
        x0 = fmaxf(x0, 0.0f);
        x1 = fmaxf(x1, 0.0f);
        x2 = fmaxf(x2, 0.0f);
        x3 = fmaxf(x3, 0.0f);
      }
      const __nv_bfloat162 h0 = __floats2bfloat162_rn(x0, x1), h1 = __floats2bfloat162_rn(x2, x3);
      if (SIGMA) {
        const float2 ws = ldg_bf162(w_sigma + 8 * gg + cq);
        s0 += __low2float(h0) * ws.x + __high2float(h0) * ws.y;
        s1 += __low2float(h1) * ws.x + __high2float(h1) * ws.y;
      }
      if (MASKS) {
        const uint32_t bits = uint32_t(__low2float(h0) > 0.0f) |
                              (uint32_t(__high2float(h0) > 0.0f) << 1) |
                              (uint32_t(__low2float(h1) > 0.0f) << 2) |
                              (uint32_t(__high2float(h1) > 0.0f) << 3);
        m[gg >> 3] |= bits << (4 * (gg & 7));
      }
      r[2 * h] = bf162_bits(h0);
      r[2 * h + 1] = bf162_bits(h1);
    }
    sm90::stmatrix_x4_trans(stm_addr(act, g, warp, lane), r[0], r[1], r[2], r[3]);
  }
  if (MASKS) st_v4(mask_slot, m);
}

// Dgrad epilogue of a 64 x W fragment: dz = v masked by the bits at
// mask_slot (MASK), where v = acc (+ dzs * w_sigma[c] when SIGMA: the sigma
// head's term of dh_7); bf16(dz) stored feature-major at `act`; the float
// column sums added into brow[at ..].
template <bool MASK, bool SIGMA>
__device__ __forceinline__ void bwd_epilogue(const float (&acc)[W / 2], uint32_t mask_slot,
                                             float dzs0, float dzs1,
                                             const bf16* __restrict__ w_sigma, uint32_t act,
                                             float* __restrict__ brow, int at, int warp,
                                             int lane) {
  const int cq = 2 * (lane & 3);
  uint32_t m[4] = {~0u, ~0u, ~0u, ~0u};
  if (MASK) ld_v4(mask_slot, m);
  float cs[W / 4];
#pragma unroll
  for (int g = 0; g < W / 8; g += 2) {
    uint32_t r[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gg = g + h;
      float x0 = acc[4 * gg], x1 = acc[4 * gg + 1], x2 = acc[4 * gg + 2], x3 = acc[4 * gg + 3];
      if (SIGMA) {
        const float2 ws = ldg_bf162(w_sigma + 8 * gg + cq);
        x0 += dzs0 * ws.x;
        x1 += dzs0 * ws.y;
        x2 += dzs1 * ws.x;
        x3 += dzs1 * ws.y;
      }
      if (MASK) {
        const uint32_t bits = m[gg >> 3] >> (4 * (gg & 7));
        x0 = bits & 1u ? x0 : 0.0f;
        x1 = bits & 2u ? x1 : 0.0f;
        x2 = bits & 4u ? x2 : 0.0f;
        x3 = bits & 8u ? x3 : 0.0f;
      }
      r[2 * h] = pack_bf2(x0, x1);
      r[2 * h + 1] = pack_bf2(x2, x3);
      cs[2 * gg] = x0 + x2;
      cs[2 * gg + 1] = x1 + x3;
    }
    sm90::stmatrix_x4_trans(stm_addr(act, g, warp, lane), r[0], r[1], r[2], r[3]);
  }
  colsum_out(cs, brow, at, lane);
}

struct TileArgs {
  Weights prm;
  Stash st;                // the backward's
  const float* xyz;
  const float* dirs;
  const float* dy;         // the backward's
  float* out;              // the forward's (n_points, 4) [rgb, sigma]
  long long samples_per_dir, n_points, n_tiles;
};

// The first `slices` slices of the stream, for every tile of this CTA.
template <typename Ring>
__device__ __forceinline__ void produce_tile(const unsigned char* __restrict__ stream, Ring ring,
                                             long long n_tiles, int slices) {
  const uint64_t keep = sm90::policy_evict_last();  // every CTA reads the stream every tile
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const unsigned char* src = stream;
    for (int j = 0; j < slices; ++j) {
      const uint32_t bytes =
          j >= FWD_SLICES && j < FWD_SLICES + DIR_SLICES ? DSLICE_BYTES : SLICE_BYTES;
      sm90::mbar_wait(ring.empty(ring.stage), ring.phase ^ 1u);
      sm90::mbar_arrive_expect_tx(ring.full(), bytes);
      sm90::bulk_copy_g2s_hint(ring.slot(), src, bytes, ring.full(), keep);
      src += bytes;
      ring.advance();
    }
  }
}

// A consumer warpgroup's tiles. FWD: the forward (the recompute without the
// masks, with the heads, to A.out); else the backward's recompute and dgrad
// chain, to the stash and the bias partials.
template <bool FWD, typename Ring>
__device__ __forceinline__ void consume_tile(const TileArgs& A, Ring ring, uint32_t base) {
  const Weights& prm = A.prm;
  const Stash& st = A.st;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const uint32_t bar_id = 1 + wg;
  const uint32_t act = base + wg * ACT_BYTES;
  const uint32_t xemb = base + T_OFF_X + wg * EMB_X * ROW_BYTES;
  const uint32_t demb = base + T_OFF_D + wg * EMB_D * ROW_BYTES;
  auto mask_slot = [&](int l) {
    return base + T_OFF_MASK + ((l * CONSUMERS + wg) * 128 + t) * 16;
  };
  const int er = t >> 1, half = t & 1;          // embedding: two threads per point
  const int r = warp * 16 + (lane >> 2);        // accumulator rows r and r + 8
  const int cq = 2 * (lane & 3);
  const bool issuer = !FWD && t == 0;           // issues this warpgroup's bulk stores
  float* brow = FWD ? nullptr
                    : st.bias_part + ((long long)blockIdx.x * WARP_ROWS + wg * 4 + warp) * NB;

  // The two warpgroups take their epilogues independently: ordered turns (as
  // in csrc/fused_mlp.cu) made this kernel slower (k2_ablation).
  auto wg_sync = [&] { sm90::named_bar_sync(bar_id, 128); };
  // Before an epilogue: every warp of ours has retired the products that read
  // the tile, and no bulk store still reads shared memory the epilogue rewrites.
  auto begin_epilogue = [&] {
    if (issuer) sm90::bulk_wait_read<0>();
    wg_sync();
  };
  // After it: its writes are visible to the async proxy (wgmma, bulk stores).
  auto end_epilogue = [&] {
    sm90::fence_proxy_async();
    wg_sync();
  };
  // the stash streams through L2 (2.6 GB a step): evicted first, so that it
  // does not push out the weight stream
  const uint64_t stream_out = sm90::policy_evict_first();
  auto store = [&](bf16* dst, uint32_t src, uint32_t bytes) {  // by the issuer
    sm90::bulk_copy_s2g(dst, src, bytes, stream_out);
  };
  float acc[W / 2];
  for (long long tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const long long blk = tile * CONSUMERS + wg;  // this warpgroup's 64-point stash block
    if (issuer) sm90::bulk_wait_read<0>();
    wg_sync();  // the last tile's products and stores have read the embeddings
    {
      const long long pe = blk * 64 + er;
      float x[3];
      load3(A.xyz, pe, pe < A.n_points, x);
      embed_col<10, EMB_X>(xemb, x, er, half);
      load3(A.dirs, pe / A.samples_per_dir, pe < A.n_points, x);
      embed_col<4, EMB_D>(demb, x, er, half);
    }
    sm90::fence_proxy_async();
    wg_sync();
    if (issuer) {  // the backward's only, as every store below
      store(st.emb + blk * EMB_X * 64, xemb, EMB_X * ROW_BYTES);
      store(st.demb + blk * EMB_D * 64, demb, EMB_D * ROW_BYTES);
      sm90::bulk_commit();
    }

    // recompute: h_l = bf16(relu(W_l h_{l-1} (+ W_le emb) + b_l)), the
    // backward's masks kept as bits; the forward's sigma partials from h_7
    float sig0 = 0.0f, sig1 = 0.0f;
    for (int l = 0; l < DEPTH; ++l) {
      const int n_h = l ? W / KS : 0;
      run_slot<W>(acc, ring, n_h + int(l == 0 || l == SKIP),
                  [&](int j) { return j < n_h ? act + j * KSLICE_BYTES : xemb; }, KS / 16, lane);
      begin_epilogue();
      if (FWD && l == DEPTH - 1)
        fwd_epilogue<true, false, true>(acc, prm.b[l], act, 0u, prm.w_sigma, sig0, sig1, warp,
                                        lane);
      else
        fwd_epilogue<true, !FWD, false>(acc, prm.b[l], act, mask_slot(l), prm.w_sigma, sig0,
                                        sig1, warp, lane);
      end_epilogue();
      if (issuer) {
        store(st.h[l] + blk * W * 64, act, ACT_BYTES);
        sm90::bulk_commit();
      }
    }
    // feat = bf16(W_feat h_7 + b_feat)
    run_slot<W>(acc, ring, W / KS, [&](int j) { return act + j * KSLICE_BYTES; }, KS / 16, lane);
    begin_epilogue();
    fwd_epilogue<false, false, false>(acc, prm.b_feat, act, 0u, prm.w_sigma, sig0, sig1, warp,
                                      lane);
    end_epilogue();
    if (issuer) {
      store(st.feat + blk * W * 64, act, ACT_BYTES);
      sm90::bulk_commit();
    }

    // hd = bf16(relu(W_dfeat feat + W_ddir demb + b_dir)) and the rgb head's
    // sums; the backward then forms the first cotangents: hd to rows WD.. of
    // act, dz_hd to rows 0..WD
    const long long p = blk * 64 + r;  // this thread's points p, p + 8
    {
      float acc2[WD / 2];
      run_slot<WD>(acc2, ring, DIR_SLICES,
                   [&](int j) { return j < W / KS ? act + j * KSLICE_BYTES : demb; }, EMB_D / 16,
                   lane);
      if (!FWD) begin_epilogue();
      uint32_t hm[2] = {0u, 0u};
      float c0[3] = {0.0f, 0.0f, 0.0f}, c1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int g = 0; g < WD / 8; g += 2) {
        uint32_t rr[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gg = g + h, c = 8 * gg + cq;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(prm.b_dir + c));
          const __nv_bfloat162 h0 = __floats2bfloat162_rn(fmaxf(acc2[4 * gg] + bb.x, 0.0f),
                                                          fmaxf(acc2[4 * gg + 1] + bb.y, 0.0f));
          const __nv_bfloat162 h1 = __floats2bfloat162_rn(fmaxf(acc2[4 * gg + 2] + bb.x, 0.0f),
                                                          fmaxf(acc2[4 * gg + 3] + bb.y, 0.0f));
          if (!FWD) {
            const uint32_t bits = uint32_t(__low2float(h0) > 0.0f) |
                                  (uint32_t(__high2float(h0) > 0.0f) << 1) |
                                  (uint32_t(__low2float(h1) > 0.0f) << 2) |
                                  (uint32_t(__high2float(h1) > 0.0f) << 3);
            hm[gg >> 3] |= bits << (4 * (gg & 7));
          }
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float2 w = ldg_bf162(prm.w_rgb + ch * WD + c);
            c0[ch] += __low2float(h0) * w.x + __high2float(h0) * w.y;
            c1[ch] += __low2float(h1) * w.x + __high2float(h1) * w.y;
          }
          rr[2 * h] = bf162_bits(h0);
          rr[2 * h + 1] = bf162_bits(h1);
        }
        if (!FWD)
          sm90::stmatrix_x4_trans(stm_addr(act + WD * ROW_BYTES, g, warp, lane), rr[0], rr[1],
                                  rr[2], rr[3]);
      }
      if constexpr (FWD) {  // the output: a quad's first lane stores row r, its second r + 8
        float v[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float b = __ldg(prm.b_rgb + ch);
          const float g0 = 1.0f / (1.0f + expf(-(quad_sum(c0[ch]) + b)));
          const float g1 = 1.0f / (1.0f + expf(-(quad_sum(c1[ch]) + b)));
          v[ch] = lane & 1 ? g1 : g0;
        }
        const float bs = __ldg(prm.b_sigma);
        const float s0 = quad_sum(sig0) + bs, s1 = quad_sum(sig1) + bs;
        const long long q = p + 8 * (lane & 1);
        if ((lane & 2) == 0 && q < A.n_points)
          *reinterpret_cast<float4*>(A.out + 4 * q) =
              make_float4(v[0], v[1], v[2], lane & 1 ? s1 : s0);
        continue;  // the forward's tile ends here
      }
      // heads: dz_r = dy_rgb rgb (1 - rgb), dz_sigma = dy_sigma (zero past N)
      float dzr0[3], dzr1[3], dzs0, dzs1;
      {
        const bool v0 = p < A.n_points, v1 = p + 8 < A.n_points;
        const float4 d0 = v0 ? __ldg(reinterpret_cast<const float4*>(A.dy) + p)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 d1 = v1 ? __ldg(reinterpret_cast<const float4*>(A.dy) + p + 8)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float dd0[3] = {d0.x, d0.y, d0.z}, dd1[3] = {d1.x, d1.y, d1.z};
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float b = __ldg(prm.b_rgb + ch);
          const float g0 = 1.0f / (1.0f + expf(-(quad_sum(c0[ch]) + b)));
          const float g1 = 1.0f / (1.0f + expf(-(quad_sum(c1[ch]) + b)));
          dzr0[ch] = dd0[ch] * g0 * (1.0f - g0);
          dzr1[ch] = dd1[ch] * g1 * (1.0f - g1);
        }
        dzs0 = d0.w;
        dzs1 = d1.w;
      }
      // dz_hd = (hd > 0) (W_rgb^T bf16(dz_r)) -> act rows 0..WD, b_dir sums
      float cs[WD / 4];
      {
        float z0[3], z1[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          z0[ch] = round_bf(dzr0[ch]);
          z1[ch] = round_bf(dzr1[ch]);
        }
#pragma unroll
        for (int g = 0; g < WD / 8; g += 2) {
          uint32_t rr[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gg = g + h, c = 8 * gg + cq;
            float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              const float2 w = ldg_bf162(prm.w_rgb + ch * WD + c);
              x0 += z0[ch] * w.x;
              x1 += z0[ch] * w.y;
              x2 += z1[ch] * w.x;
              x3 += z1[ch] * w.y;
            }
            const uint32_t bits = hm[gg >> 3] >> (4 * (gg & 7));
            x0 = bits & 1u ? x0 : 0.0f;
            x1 = bits & 2u ? x1 : 0.0f;
            x2 = bits & 4u ? x2 : 0.0f;
            x3 = bits & 8u ? x3 : 0.0f;
            rr[2 * h] = pack_bf2(x0, x1);
            rr[2 * h + 1] = pack_bf2(x2, x3);
            cs[2 * gg] = x0 + x2;
            cs[2 * gg + 1] = x1 + x3;
          }
          sm90::stmatrix_x4_trans(stm_addr(act, g, warp, lane), rr[0], rr[1], rr[2], rr[3]);
        }
      }
      colsum_out(cs, brow, B_DIR, lane);
      // the head cotangents' block (features 0..2 dz_r, 3 dz_sigma, zeros) in
      // demb's place, which the products above have read; b_rgb, b_sigma sums
      if ((lane & 3) == 0) {
        const float z0[4] = {dzr0[0], dzr0[1], dzr0[2], dzs0};
        const float z1[4] = {dzr1[0], dzr1[1], dzr1[2], dzs1};
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          sm90::st_b16(fm_addr(demb, f, r), __bfloat16_as_ushort(__float2bfloat16_rn(z0[f])));
          sm90::st_b16(fm_addr(demb, f, r + 8), __bfloat16_as_ushort(__float2bfloat16_rn(z1[f])));
        }
      }
      if (t < (HEAD - 4) * 8) sm90::st_zero16(demb + (4 + (t >> 3)) * ROW_BYTES + (t & 7) * 16);
      float hs[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        hs[f] = (lane & 3) == 0 ? (f < 3 ? dzr0[f] + dzr1[f] : dzs0 + dzs1) : 0.0f;
        hs[f] += __shfl_xor_sync(0xffffffffu, hs[f], 4);
        hs[f] += __shfl_xor_sync(0xffffffffu, hs[f], 8);
        hs[f] += __shfl_xor_sync(0xffffffffu, hs[f], 16);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < 4; ++f) bias_add(brow + B_HEAD + f, hs[f]);
      }
      end_epilogue();
      if (issuer) {
        store(st.hd + blk * WD * 64, act + WD * ROW_BYTES, WD * ROW_BYTES);
        store(st.dhd + blk * WD * 64, act, WD * ROW_BYTES);
        store(st.dhead + blk * HEAD * 64, demb, HEAD * ROW_BYTES);
        sm90::bulk_commit();
      }
    }

    // dfeat = W_dfeat^T bf16(dz_hd)
    run_slot<W>(acc, ring, WD / KS, [&](int j) { return act + j * KSLICE_BYTES; }, KS / 16, lane);
    begin_epilogue();
    bwd_epilogue<false, false>(acc, 0u, 0.0f, 0.0f, prm.w_sigma, act, brow, B_FEAT, warp, lane);
    end_epilogue();
    if (issuer) {
      store(st.dfeat + blk * W * 64, act, ACT_BYTES);
      sm90::bulk_commit();
    }
    // dz_7 = (h_7 > 0) (W_feat^T bf16(dfeat) + w_sigma bf16(dz_sigma)); then
    // dz_{l-1} = (h_{l-1} > 0) W_l^T bf16(dz_l) for l = 7 .. 1
    for (int l = DEPTH; l >= 1; --l) {
      run_slot<W>(acc, ring, W / KS, [&](int j) { return act + j * KSLICE_BYTES; }, KS / 16, lane);
      begin_epilogue();
      if (l == DEPTH) {  // dz_sigma read again: kept, it cost the dfeat products a spill
        const float s0 = p < A.n_points ? round_bf(__ldg(A.dy + 4 * p + 3)) : 0.0f;
        const float s1 = p + 8 < A.n_points ? round_bf(__ldg(A.dy + 4 * (p + 8) + 3)) : 0.0f;
        bwd_epilogue<true, true>(acc, mask_slot(l - 1), s0, s1, prm.w_sigma, act, brow,
                                 (l - 1) * W, warp, lane);
      } else {
        bwd_epilogue<true, false>(acc, mask_slot(l - 1), 0.0f, 0.0f, prm.w_sigma, act, brow,
                                  (l - 1) * W, warp, lane);
      }
      end_epilogue();
      if (issuer) {
        store(st.dz[l - 1] + blk * W * 64, act, ACT_BYTES);
        sm90::bulk_commit();
      }
    }
  }
  if (FWD) return;
  // the CTA's eight warp rows of bias partials summed into its first, in order
  __threadfence();  // this thread's reductions have landed
  sm90::named_bar_sync(3, CONSUMERS * 128);
  float* rows = st.bias_part + (long long)blockIdx.x * WARP_ROWS * NB;
  for (int b = threadIdx.x; b < B_HEAD + 4; b += CONSUMERS * 128) {
    float s = rows[b];
#pragma unroll
    for (int w = 1; w < WARP_ROWS; ++w) s += rows[w * NB + b];
    rows[b] = s;
  }
  if (issuer) sm90::bulk_wait<0>();
}

template <bool FWD>
__device__ __forceinline__ void tile_kernel(const TileArgs& args,
                                            const unsigned char* __restrict__ stream,
                                            unsigned char* smem) {
  using T = Tile<FWD>;
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  const typename T::Ring ring = {base + T::OFF_RING, base + T::OFF_BARS, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      sm90::mbar_init(ring.bars + 8 * s, 1);                            // the producer's arrival
      sm90::mbar_init(ring.bars + 8 * (T::STAGES + s), CONSUMERS * 4);  // one per consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * 128) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) produce_tile(stream, ring, args.n_tiles, T::SLICES);
  } else {
    sm90::reg_alloc<232>();
    consume_tile<FWD>(args, ring, base);
  }
}

__global__ void __launch_bounds__(T_THREADS, 1)
    nerf_train_fwd_tile_kernel(const TileArgs args, const unsigned char* __restrict__ stream) {
  extern __shared__ __align__(1024) unsigned char smem[];
  tile_kernel<true>(args, stream, smem);
}

__global__ void __launch_bounds__(T_THREADS, 1)
    nerf_train_bwd_tile_kernel(const TileArgs args, const unsigned char* __restrict__ stream) {
  extern __shared__ __align__(1024) unsigned char smem[];
  tile_kernel<false>(args, stream, smem);
}

// ---- weight-gradient GEMM ---------------------------------------------------

using GRing = StageRing<G_STAGES, G_STAGE_BYTES>;

template <int N>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[N / 2], uint64_t a, uint64_t b,
                                             int accumulate) {
  if constexpr (N == 256)
    sm90::wgmma_m64n256k16(d, a, b, accumulate);
  else if constexpr (N == 64)
    sm90::wgmma_m64n64k16(d, a, b, accumulate);
  else if constexpr (N == 32)
    sm90::wgmma_m64n32k16(d, a, b, accumulate);
  else
    sm90::wgmma_m64n16k16(d, a, b, accumulate);
}

// This warpgroup's 64 rows of the CTA's 128 x N partial over blocks [k0, k1),
// stored at row (m, n) of part: part[m * N + n].
template <int N>
__device__ __forceinline__ void gemm_consume(GRing ring, float* __restrict__ part, int m0,
                                             long long k0, long long k1) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int held = -1;
  for (long long k = k0; k < k1; ++k) {
    sm90::mbar_wait(ring.full(), ring.phase);
    const uint32_t a = ring.slot() + wg * (G_A_BYTES / CONSUMERS), b = ring.slot() + G_A_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_kmajor<N>(acc, sm90::desc_sw128(a + 32 * kk), sm90::desc_sw128(b + 32 * kk),
                      k > k0 || kk > 0);
    sm90::wgmma_commit();
    sm90::fence_operand(acc);
    sm90::wgmma_wait<1>();
    sm90::fence_operand(acc);
    if (held >= 0 && lane == 0) sm90::mbar_arrive(ring.empty(held));
    held = ring.stage;
    ring.advance();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_operand(acc);
  if (held >= 0 && lane == 0) sm90::mbar_arrive(ring.empty(held));
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  float* dst = part + (long long)row * N + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(dst + 8 * N + 8 * i) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// One CTA: 128 rows of one job's gradient over one slab of point blocks,
// stored as the slab's float32 partial.
__global__ void __launch_bounds__(G_THREADS, 1)
    nerf_train_wgrad_kernel(const GJobs jobs, float* __restrict__ part) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (sm90::smem_addr(smem) + 1023u) & ~1023u;
  const GRing ring = {base, base + G_STAGES * G_STAGE_BYTES, 0, 0u};
  int jid = 0;
#pragma unroll 1
  for (int q = 1; q < N_JOBS; ++q)
    if ((int)blockIdx.x >= jobs.j[q].tile0 * jobs.splits) jid = q;
  const GJob job = jobs.j[jid];
  // a job's row tiles of one slab are neighbours, so they run together and
  // the second read of their shared operand is served from L2
  const int m_tiles = job.m_rows / G_M, local = blockIdx.x - job.tile0 * jobs.splits;
  const int split = local / m_tiles, m0 = G_M * (local % m_tiles);
  const long long k0 = split * jobs.slab;
  const long long k1 = k0 + jobs.slab < jobs.blocks ? k0 + jobs.slab : jobs.blocks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      sm90::mbar_init(ring.bars + 8 * s, 1);
      sm90::mbar_init(ring.bars + 8 * (G_STAGES + s), CONSUMERS * 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * 128) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      GRing r = ring;
      const uint32_t b_bytes = job.n * ROW_BYTES;
      for (long long k = k0; k < k1; ++k) {
        sm90::mbar_wait(r.empty(r.stage), r.phase ^ 1u);
        sm90::mbar_arrive_expect_tx(r.full(), G_A_BYTES + b_bytes);
        sm90::bulk_copy_g2s(r.slot(), job.a + (k * job.m_rows + m0) * 64, G_A_BYTES, r.full());
        sm90::bulk_copy_g2s(r.slot() + G_A_BYTES, job.b + k * job.n * 64, b_bytes, r.full());
        r.advance();
      }
    }
  } else {
    sm90::reg_alloc<232>();
    float* p = part + split * jobs.total + job.off;
    switch (job.n) {
      case 256: gemm_consume<256>(ring, p, m0, k0, k1); break;
      case 64: gemm_consume<64>(ring, p, m0, k0, k1); break;
      case 32: gemm_consume<32>(ring, p, m0, k0, k1); break;
      default: gemm_consume<16>(ring, p, m0, k0, k1); break;
    }
  }
}

// Sum the slabs' weight partials and the tile kernel's CTAs' bias partials
// (the first of each CTA's rows) in a fixed order and write every gradient.
__global__ void nerf_train_reduce_kernel(const GJobs jobs, Grads g, const float* __restrict__ part,
                                         const float* __restrict__ bias_part, int bias_rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < jobs.total) {
    float s = 0.0f;
    for (int q = 0; q < jobs.splits; ++q) s += part[q * jobs.total + e];
    int jid = 0;
#pragma unroll 1
    for (int q = 1; q < N_JOBS; ++q)
      if (e >= jobs.j[q].off) jid = q;
    const GJob job = jobs.j[jid];
    const long long local = e - job.off;
    const long long m = local / job.n, n = local % job.n;
    job.out[m * job.out_sm + n * job.out_sn] = s;
  } else if (e < jobs.total + NB) {
    const int b = int(e - jobs.total);
    float s = 0.0f;
    for (int r = 0; r < bias_rows; ++r) s += bias_part[(long long)r * WARP_ROWS * NB + b];
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

// weight-gradient slabs: up to 32, each at least 16 blocks of 64 points
void split_plan(long long blocks, long long* slab, int* splits) {
  long long want = blocks / 16;
  want = want < 1 ? 1 : (want > 32 ? 32 : want);
  *slab = (blocks + want - 1) / want;
  *splits = int((blocks + *slab - 1) / *slab);
}

constexpr long long JOB_TOTAL = (long long)(DEPTH - 1) * W * W + 2LL * W * EMB_X + W * W +
                                (long long)WD * W + WD * EMB_D + HEAD * W + HEAD * WD;

// The persistent tile kernel's grid: one CTA per SM, at most one per tile.
cudaError_t tile_grid(long long n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = pad_rows(n) / TP;
  *grid = int(tiles < sms ? tiles : sms);
  return err;
}

// Carve the workspace at `base` (may be null to size it); returns its bytes.
long long layout(long long n, int grid, char* base, Stash* st) {
  const long long n_pad = pad_rows(n);
  long long slab;
  int splits;
  split_plan(n_pad / 64, &slab, &splits);
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  auto arr = [&](int cols) { return reinterpret_cast<bf16*>(take(n_pad * cols * 2)); };
  st->emb = arr(EMB_X);
  st->demb = arr(EMB_D);
  for (int l = 0; l < DEPTH; ++l) st->h[l] = arr(W);
  st->feat = arr(W);
  st->hd = arr(WD);
  for (int l = 0; l < DEPTH; ++l) st->dz[l] = arr(W);
  st->dfeat = arr(W);
  st->dhd = arr(WD);
  st->dhead = arr(HEAD);
  st->bias_part = reinterpret_cast<float*>(take((long long)grid * WARP_ROWS * NB * 4));
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
// k2_stream: the pack's weight stream of stream_elems bf16
// (ops/kernels/fused_mlp_train.py::k2_schedule), of which the forward reads
// the recompute's prefix (nerf_train_forward_stream_elems). xyz: (n, 3) f32;
// dirs: (ceil(n / samples_per_dir), 3) f32, point p takes
// dirs[p / samples_per_dir]; out: (n, 4) f32 [r, g, b, sigma], 16-byte
// aligned. Returns a cudaError_t value.
int nerf_train_forward(const void* const* w, const void* k2_stream, long long stream_elems,
                       const float* xyz, const float* dirs, long long samples_per_dir,
                       float* out, long long n, void* stream) {
  const Weights prm = read_weights(w);
  if (!topology_ok(prm) || samples_per_dir < 1 || n < 0 || stream_elems != STREAM_ELEMS ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  int grid = 0;
  cudaError_t err = tile_grid(n, &grid);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_train_fwd_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<true>::SMEM);
  if (err != cudaSuccess) return int(err);
  TileArgs args = {};
  args.prm = prm;
  args.xyz = xyz;
  args.dirs = dirs;
  args.out = out;
  args.samples_per_dir = samples_per_dir;
  args.n_points = n;
  args.n_tiles = pad_rows(n) / TP;
  nerf_train_fwd_tile_kernel<<<unsigned(grid), T_THREADS, Tile<true>::SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const unsigned char*>(k2_stream));
  return int(cudaGetLastError());
}

// Elements of the k2_stream the backward takes.
long long nerf_train_stream_elems() { return STREAM_ELEMS; }

// Elements of its prefix that the forward reads.
long long nerf_train_forward_stream_elems() { return FWD_STREAM_ELEMS; }

// Dynamic shared memory of the backward's tile (0) and weight-gradient (1)
// kernels and of the forward's tile kernel (2).
int nerf_train_smem_bytes(int which) {
  return which == 2 ? Tile<true>::SMEM : which ? G_SMEM : Tile<false>::SMEM;
}

// Bytes of device workspace nerf_train_backward needs for n points on the
// current device; -1 if the device cannot be queried.
long long nerf_train_workspace_bytes(long long n) {
  int grid = 0;
  if (tile_grid(n < 0 ? 0 : n, &grid) != cudaSuccess) return -1;
  Stash st;
  return layout(n < 0 ? 0 : n, grid, nullptr, &st);
}

// Where nerf_train_backward leaves the forward's bf16 activations in its
// workspace, as byte offsets (12 long): emb (EMB_X features), demb (EMB_D),
// h_0..h_7 (W), feat (W), hd (WD), each n_pad points in the blocked layout
// of the header, with n_pad = n rounded up to whole tiles of 128 points.
// Lets a test read the kernel's own ReLU masks.
void nerf_train_activation_offsets(long long n, long long* offsets) {
  char* const base = reinterpret_cast<char*>(256);  // any aligned base: only differences count
  Stash st;
  layout(n < 0 ? 0 : n, 1, base, &st);
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
// are d w_rgb, gb_rgb. k2_stream: the pack's weight stream of stream_elems
// bf16 (ops/kernels/fused_mlp_train.py::k2_schedule). dy: (n, 4) f32
// cotangent of the forward's output. Every gradient is overwritten (not
// accumulated). Returns a cudaError_t.
int nerf_train_backward(const void* const* w, void* const* g, const void* k2_stream,
                        long long stream_elems, const float* xyz, const float* dirs,
                        long long samples_per_dir, const float* dy, long long n,
                        void* workspace, long long workspace_bytes, void* stream) {
  const Weights prm = read_weights(w);
  if (!topology_ok(prm) || samples_per_dir < 1 || n < 1 || stream_elems != STREAM_ELEMS)
    return int(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err = tile_grid(n, &grid);
  if (err != cudaSuccess) return int(err);
  Stash st;
  if (layout(n, grid, static_cast<char*>(workspace), &st) > workspace_bytes)
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
  GJobs jobs = {};
  jobs.blocks = n_pad / 64;
  split_plan(jobs.blocks, &jobs.slab, &jobs.splits);
  int nj = 0, tile0 = 0;
  long long off = 0;
  // out (m_rows, n) = a^T b, written at out[m * out_sm + n * out_sn]; the
  // jobs of width 256 first, so the last CTAs to start are the short ones
  auto add = [&](const bf16* a, int m_rows, const bf16* b, int n_cols, float* out, int sm,
                 int sn) {
    GJob& j = jobs.j[nj++];
    j.a = a; j.b = b; j.out = out; j.m_rows = m_rows; j.n = n_cols;
    j.out_sm = sm; j.out_sn = sn; j.off = off; j.tile0 = tile0;
    tile0 += m_rows / G_M;
    off += (long long)m_rows * n_cols;
  };
  for (int l = 1; l < DEPTH; ++l) add(st.dz[l], W, st.h[l - 1], W, gr.w_h[l], W, 1);
  add(st.dfeat, W, st.h[DEPTH - 1], W, gr.w_feat, W, 1);
  add(st.dhd, WD, st.feat, W, gr.w_dfeat, W, 1);
  add(st.dz[0], W, st.emb, EMB_X, gr.w_e[0], EMB_X, 1);
  add(st.dz[SKIP], W, st.emb, EMB_X, gr.w_e[SKIP], EMB_X, 1);
  add(st.dhd, WD, st.demb, EMB_D, gr.w_ddir, EMB_D, 1);
  add(st.h[DEPTH - 1], W, st.dhead, HEAD, gr.sigma_rows, 1, W);  // transposed: (HEAD, W) out
  add(st.hd, WD, st.dhead, HEAD, gr.rgb_rows, 1, WD);
  if (nj != N_JOBS || off != JOB_TOTAL) return int(cudaErrorInvalidValue);
  jobs.total = off;
  jobs.n_tiles = tile0;
  if ((long long)jobs.n_tiles * jobs.splits > 0x7fffffffLL) return int(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaFuncSetAttribute(nerf_train_bwd_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<false>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nerf_train_wgrad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return int(err);
  err = cudaMemsetAsync(st.bias_part, 0, (size_t)grid * WARP_ROWS * NB * 4, s);
  if (err != cudaSuccess) return int(err);
  const TileArgs args = {prm, st, xyz, dirs, dy, nullptr, samples_per_dir, n, tiles};
  nerf_train_bwd_tile_kernel<<<unsigned(grid), T_THREADS, Tile<false>::SMEM, s>>>(
      args, static_cast<const unsigned char*>(k2_stream));
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  nerf_train_wgrad_kernel<<<unsigned(jobs.n_tiles * jobs.splits), G_THREADS, G_SMEM, s>>>(
      jobs, st.wpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const long long elems = jobs.total + NB;
  nerf_train_reduce_kernel<<<unsigned((elems + 255) / 256), 256, 0, s>>>(
      jobs, gr, st.wpart, st.bias_part, grid);
  return int(cudaGetLastError());
}

}  // extern "C"
