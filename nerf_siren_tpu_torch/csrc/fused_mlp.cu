// Fused NeRF field evaluation for Hopper (sm_90a), inference only.
//
// Replaces the TPU Pallas kernels nerf_siren_tpu/ops/pallas/fused_mlp.py::
// _sigma_kernel (sigma-only pass) and ::_full_kernel (rgb + sigma pass).
// Per point it computes, exactly as the plain PyTorch version
// nerf_siren_tpu_torch/ops/kernels/fused_mlp.py::fused_sigma_ref/_full_ref:
//   positional encoding of xyz (10 freqs) and of the direction (4 freqs) in
//   reference channel order, sin/cos formed in float32 with the precise
//   sincosf (arguments reach 2^9|x| ~ 2000-5000, where the fast intrinsics
//   lose accuracy; never build this with --use_fast_math);
//   the ReLU trunk (width W = 128, 256, 384 or 512, any depth <= MAX_DEPTH,
//   skip concat [emb, h] at the layers whose embedding weight is given);
//   the sigma head; and in the full pass the folded direction branch
//   relu(W_comb h + W_dir demb + b_comb) -> sigmoid rgb head.
// Every product takes bf16 operands (embedding incl. the raw coordinates,
// hidden activations after ReLU, weights) and accumulates in float32;
// biases, ReLU and the heads' sums are float32.
//
// Bound: compute. At width 256 a point costs ~1 MFLOP (7 256x256 layers, the 64-wide
// embedding inputs, the 128-wide direction branch) against 12-24 bytes of
// input and 4-16 bytes of output, so the tensor cores are the limit, not
// HBM. The weights (~1 MB bf16 per field) stay in the 50 MB L2; per 128
// points they are ~1 MB of L2 reads against ~126 MFLOP, so L2 bandwidth is
// the next limit and every weight byte is read once per 128-point tile.
//
// Design (persistent, warp-specialised, wgmma), as at width 256; the other
// widths below.
// Every width is one instantiation of the kernel template (nerf_field_kernel
// <W, FULL>, the shapes in Shape<W>); the wrapper dispatches on the pack's
// width.
// - Persistent grid: one CTA per SM (the launcher reads the SM count) walks
//   the 128-point tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// - Warpgroup 2 is the producer: one thread streams the weights, K-slice by
//   K-slice, into a ring of STAGES shared-memory stages with one 1-D bulk
//   copy each (cp.async.bulk, completing on the stage's `full` mbarrier),
//   and waits on the stage's `empty` mbarrier (one arrival per consumer
//   warp) before refilling it. Warpgroups 0 and 1 are the consumers: each
//   owns 64 of the tile's points and runs wgmma m64n256k16 (m64n128k16 in
//   the direction branch) with A = its rows of the activations in shared
//   memory and B = the stage. setmaxnreg gives the consumers 232 registers
//   (128 of them accumulators), the producer 40.
// - The weights come pre-swizzled as one stream (the pack's `k1_stream`,
//   ops/kernels/fused_mlp.py::k1_schedule): each slice is 64 inputs of one
//   product for all its outputs, K-major in the 128-byte swizzle wgmma reads
//   (sm90_async.cuh), in the order consumed:
//     for each trunk layer l: 4 hidden slices (inputs 0-63, ..., 192-255;
//       none at layer 0), then 1 embedding slice if layer l takes the
//       embedding (layer 0 always): 256 rows x 64, 32 KB each;
//     then W_comb's 4 slices and W_dir zero-padded to 64 inputs: 128 rows x
//       64, 16 KB each (streamed by the full pass only).
//   The reference field (8 layers, skip at 4): 30 trunk + 5 = 35 slices;
//   depth 3 with the skip at 1: 10 + 5.
// - Activations stay on chip: 128 x 256 bf16 in four 64-column swizzled
//   blocks, rewritten once per layer straight from the accumulators (bias,
//   ReLU, bf16). A warpgroup writes and reads only its own rows, so it syncs
//   on a named barrier of its own 128 threads, never the CTA. Generic-proxy
//   writes are fenced (fence.proxy.async) before wgmma reads them; a stage
//   is released only after wgmma.wait_group has retired its products.
// - Heads without a staging pass: sigma is the dot of the last layer's bf16
//   activations with w_sigma, summed over a quad (from the accumulators in
//   the sigma pass; read back from shared memory in the full pass, where
//   the accumulators beside it would cost spills); the direction branch is
//   one more wgmma chain (n128) over W_comb and W_dir; rgb is summed from
//   its accumulators the same way.
// - The two consumer warpgroups take their epilogues in strict alternation
//   (an ordered pair of named barriers), so they drift half a step apart:
//   one's epilogue, and its embedding of the next tile's points (precise
//   sincosf, at the tile's start, where no accumulator is live), run while
//   the other's products keep the tensor cores busy.
// - The ragged last tile embeds zeros past N and masks its stores.
// Shared memory: 64 KB activations + 4 x 32 KB ring + 16 KB xyz embedding
// (+ 16 KB direction embedding in the full pass) + barriers.
//
// Width 128: the same schedule with m64n128k16 trunk products (64
// accumulators) and an m64n64k16 direction branch; a slice is 16 KB, so the
// ring is 8 stages deep. Shared memory: 32 KB activations + 8 x 16 KB ring
// + 16 (+ 16) KB embeddings.
// Widths 384 and 512 (SPLIT): a layer's output no longer fits one
// warpgroup's registers (wgmma's N stops at 256, and 232 registers a
// thread leave room for 128 accumulators), and 128 points' activations no
// longer fit beside a ring. So both consumer warpgroups work on one tile
// of 64 points, warpgroup g computing the columns [g W/2, (g + 1) W/2) of
// every layer (m64n192k16 or m64n256k16: 96 or 128 accumulators) and of the
// direction branch (m64n96k16 or m64n128k16), both reading the tile's
// activations as A and each its half of a slice's rows as B (a half starts
// at a multiple of 8 rows, so it is itself a swizzled tile). A layer
// overwrites the activations in place, so both warpgroups meet at a named
// barrier of their 256 threads after their products (every read of the
// old activations retired) and again after their epilogues (the new ones
// written and fenced); no turns. The sigma and rgb heads are two partial
// dots, one a warpgroup, which warpgroup 1 hands to warpgroup 0 through
// 1 KB of shared memory. Warpgroup 0 embeds the points, warpgroup 1 the
// directions. Shared memory: width 384, 48 KB activations + 3 x 48 KB ring
// + 8 (+ 8) KB embeddings + 1 KB; width 512, 64 KB + 2 x 64 KB + 8 (+ 8)
// KB + 1 KB, 210 KB of the 227 KB a block may use at most. Above 512 the
// activations of even 64 points (64 W bytes) beside a two-stage ring of
// slices (2 x 128 W bytes) leave no room below 227 KB.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError() so the caller can raise on a refused launch. The tile
// and head shapes come from nerf_field_common.cuh (shared with K2 and K4),
// the ring's position, the embedding, the trunk epilogue and the heads from
// nerf_field_sm90.cuh (shared with K4), the PTX building blocks from
// sm90_async.cuh.

#include "nerf_field_common.cuh"
#include "nerf_field_sm90.cuh"
#include "sm90_async.cuh"

namespace {

using namespace nerf_field;

constexpr int MAX_DEPTH = 16;
constexpr int KS = 64;                             // inputs per weight slice (one swizzle row)
constexpr int CONSUMERS = 2;                       // consumer warpgroups
constexpr int K1_THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int XCH_BYTES = 64 * 4 * 4;              // SPLIT: a row's 3 rgb and 1 sigma partials

// The kernel's shapes at trunk width WIDTH (the header's designs).
template <int WIDTH>
struct Shape {
  static constexpr int W = WIDTH;                     // trunk width
  static constexpr int WD = WIDTH / 2;                // direction-branch width
  static constexpr bool SPLIT = WIDTH > 256;          // both consumers on a tile, W / 2 each
  static constexpr int TPT = SPLIT ? 64 : TP;         // points per tile
  static constexpr int NC = SPLIT ? W / 2 : W;        // trunk columns a consumer computes
  static constexpr int NDC = SPLIT ? WD / 2 : WD;     // direction-branch columns a consumer takes
  static constexpr int WG_ROWS = SPLIT ? TPT : TPT / CONSUMERS;  // a consumer's points
  static constexpr int BLOCK_BYTES = TPT * KS * 2;    // 64 columns of the tile
  static constexpr int WG_BLOCK_BYTES = SPLIT ? 0 : WG_ROWS * KS * 2;  // a consumer's rows' offset
  static constexpr int SLICE_BYTES = W * KS * 2;      // trunk slice: W output rows
  static constexpr int DSLICE_BYTES = WD * KS * 2;    // direction-branch slice: WD output rows
  static constexpr int DIR_SLICES = W / KS + 1;       // W_comb's, then W_dir's
  static constexpr int STAGES = W == 128 ? 8 : W == 256 ? 4 : W == 384 ? 3 : 2;
  static constexpr int SMEM_ACT = (W / KS) * BLOCK_BYTES;
  static constexpr int SMEM_RING = STAGES * SLICE_BYTES;
  static_assert(W % 128 == 0 && W >= 128 && W <= 512, "K1 takes widths 128, 256, 384, 512");

  // the barriers after the activations, the ring and the embeddings; then
  // SPLIT's exchange rows
  __host__ __device__ static constexpr int bars(bool full) {
    return SMEM_ACT + SMEM_RING + BLOCK_BYTES * (full ? 2 : 1);
  }
  __host__ __device__ static constexpr int smem_bytes(bool full) {
    return 1024 /* alignment slack */ + bars(full) + 2 * STAGES * 8 + (SPLIT ? XCH_BYTES : 0);
  }
};

struct FieldParams {
  const bf16* stream;          // the pack's k1_stream
  const float* b[MAX_DEPTH];   // (W,) per trunk layer
  HeadParams heads;            // w_comb and w_dir unused: they are streamed
  unsigned emb_mask;           // bit l: layer l takes the embedding
  int depth;
  int n_trunk;                 // trunk slices in the stream
};

template <int WIDTH>
using Ring = StageRing<Shape<WIDTH>::STAGES, Shape<WIDTH>::SLICE_BYTES>;

// One slot (a trunk layer, or the direction branch): acc = sum over its
// n_slices ring slices of A_j (this warpgroup's 64 rows x 64 at a_rows(j)) x
// rows [b_row0, b_row0 + N) of slice_j. Keeps two slices' products in
// flight and releases each stage once its products are retired. On return
// every product of the slot has completed.
template <int N, typename R, typename ARows>
__device__ __forceinline__ void run_slot(float (&acc)[N / 2], R& ring, int n_slices,
                                         ARows a_rows, int lane, int b_row0 = 0) {
  int held = -1;  // the stage whose products may still be in flight
  // Real zeros (the first product overwrites them anyway): they end the
  // previous values' live range, which would otherwise reach back through
  // the rest of the tile and cost the full pass its spills.
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int j = 0; j < n_slices; ++j) {
    sm90::mbar_wait(ring.full(), ring.phase);
    const uint32_t a = a_rows(j), b = ring.slot() + b_row0 * 128;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      const uint64_t da = sm90::desc_sw128(a + 32 * kk), db = sm90::desc_sw128(b + 32 * kk);
      sm90::wgmma_ss<N>(acc, da, db, j > 0 || kk > 0);
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

template <int WIDTH>
__device__ __forceinline__ void produce(const FieldParams& prm, Ring<WIDTH> ring, int n_slices,
                                        long long n_tiles) {
  using S = Shape<WIDTH>;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(prm.stream);
    for (int j = 0; j < n_slices; ++j) {
      const uint32_t bytes = j < prm.n_trunk ? S::SLICE_BYTES : S::DSLICE_BYTES;
      sm90::mbar_wait(ring.empty(ring.stage), ring.phase ^ 1u);
      sm90::mbar_arrive_expect_tx(ring.full(), bytes);
      sm90::bulk_copy_g2s(ring.slot(), src, bytes, ring.full());
      src += bytes;
      ring.advance();
    }
  }
}

// Widths 128 and 256: each consumer warpgroup owns 64 of the tile's 128
// points, all columns.
template <int WIDTH, bool FULL>
__device__ __forceinline__ void consume(const FieldParams& prm, Ring<WIDTH> ring, uint32_t base,
                                        const float* __restrict__ xyz,
                                        const float* __restrict__ dirs, unsigned samples_per_dir,
                                        float* __restrict__ out, long long n_points,
                                        long long n_tiles) {
  using S = Shape<WIDTH>;
  constexpr int W = S::W, WD = S::WD, WG_ROWS = S::WG_ROWS, BLOCK_BYTES = S::BLOCK_BYTES;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const uint32_t bar_id = 1 + wg;
  const uint32_t act_rows = base + wg * S::WG_BLOCK_BYTES;
  const uint32_t xemb_rows = base + S::SMEM_ACT + S::SMEM_RING + wg * S::WG_BLOCK_BYTES;
  const uint32_t demb_rows = xemb_rows + BLOCK_BYTES;
  const int er = t >> 1, half = t & 1;  // embedding: two threads per point
  const int r = warp * 16 + (lane >> 2);  // accumulator rows r and r + 8

  // Ordered turns for the epilogues: the two warpgroups take them in
  // alternation (barriers 3 and 4: warpgroup g waits on 3 + g, then lets the
  // other go), so one's epilogue runs under the other's products instead of
  // both idling the tensor cores at once.
  const uint32_t my_turn = 3 + wg, other_turn = 4 - wg;
  auto wg_sync = [&] { sm90::named_bar_sync(bar_id, 128); };
  if (wg == 1) sm90::named_bar_arrive(other_turn, 256);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the embeddings of this warpgroup's points, while the other's products run
    const long long pe = tile * TP + wg * WG_ROWS + er;
    float x[3];
    load3(xyz, pe, pe < n_points, x);
    embed_row<10>(xemb_rows, x, er, half);
    if constexpr (FULL) {
      load3(dirs, unsigned(pe) / samples_per_dir, pe < n_points, x);  // 32-bit: no call
      embed_row<4>(demb_rows, x, er, half);
    }
    sm90::fence_proxy_async();
    wg_sync();

    const long long p = tile * TP + wg * WG_ROWS + r;  // this thread's rows' points p, p + 8
    float acc[W / 2];
    float s0 = 0.0f, s1 = 0.0f;
    for (int l = 0; l < prm.depth; ++l) {
      const int n_h = l ? W / KS : 0;
      run_slot<W>(
          acc, ring, n_h + int((prm.emb_mask >> l) & 1u),
          [&](int j) { return j < n_h ? act_rows + j * BLOCK_BYTES : xemb_rows; }, lane);
      // our turn; every warp of ours has retired the products that read the activations
      sm90::named_bar_sync(my_turn, 256);
      if (FULL || l + 1 < prm.depth)
        trunk_epilogue<true, false, W, BLOCK_BYTES>(acc, prm.b[l], prm.heads.w_sigma, act_rows,
                                                    warp, lane, s0, s1);
      else  // the sigma pass's last layer: its head straight from the accumulators
        trunk_epilogue<false, true, W, BLOCK_BYTES>(acc, prm.b[l], prm.heads.w_sigma, act_rows,
                                                    warp, lane, s0, s1);
      sm90::named_bar_arrive(other_turn, 256);
      sm90::fence_proxy_async();
      wg_sync();
    }
    if constexpr (FULL)  // beside the accumulators it would push the full pass past 232 registers
      sigma_from_smem<W, BLOCK_BYTES>(prm.heads.w_sigma, act_rows, warp, lane, s0, s1);
    const float b_sigma = __ldg(prm.heads.b_sigma);
    s0 = quad_sum(s0) + b_sigma;
    s1 = quad_sum(s1) + b_sigma;

    const int q = lane & 3;
    if constexpr (FULL) {
      float acc2[WD / 2];
      run_slot<WD>(
          acc2, ring, S::DIR_SLICES,
          [&](int j) { return j < W / KS ? act_rows + j * BLOCK_BYTES : demb_rows; }, lane);
      float c0[3], c1[3];
      rgb_epilogue<WD, WD>(acc2, prm.heads, lane, c0, c1);
      if (q < 2 && p + 8 * q < n_points) {
        float rgb[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          rgb[ch] = 1.0f / (1.0f + expf(-((q ? c1[ch] : c0[ch]) + __ldg(prm.heads.b_rgb + ch))));
        reinterpret_cast<float4*>(out)[p + 8 * q] =
            make_float4(rgb[0], rgb[1], rgb[2], q ? s1 : s0);
      }
    } else {
      if (q < 2 && p + 8 * q < n_points) out[p + 8 * q] = q ? s1 : s0;
    }
    wg_sync();  // every product reading this tile's embeddings has retired
  }
  if (wg == 0) sm90::named_bar_sync(my_turn, 256);  // the other's last turn handed over
}

// Widths 384 and 512 (SPLIT): both consumer warpgroups on one tile of 64
// points, warpgroup g computing columns [g NC, (g + 1) NC) of each layer and
// [g NDC, (g + 1) NDC) of the direction branch. `xch`: the exchange rows,
// 4 floats a point.
template <int WIDTH, bool FULL>
__device__ __forceinline__ void consume_split(const FieldParams& prm, Ring<WIDTH> ring,
                                              uint32_t base, float* xch,
                                              const float* __restrict__ xyz,
                                              const float* __restrict__ dirs,
                                              unsigned samples_per_dir, float* __restrict__ out,
                                              long long n_points, long long n_tiles) {
  using S = Shape<WIDTH>;
  constexpr int W = S::W, NC = S::NC, NDC = S::NDC, BLOCK_BYTES = S::BLOCK_BYTES;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int q = lane & 3;
  const uint32_t xemb_rows = base + S::SMEM_ACT + S::SMEM_RING;
  const uint32_t demb_rows = xemb_rows + BLOCK_BYTES;
  const uint32_t my_cols = base + wg * (NC / KS) * BLOCK_BYTES;  // our blocks of the activations
  const int er = t >> 1, half = t & 1;  // embedding: two threads per point
  const int r = warp * 16 + (lane >> 2);  // accumulator rows r and r + 8
  auto both_sync = [] { sm90::named_bar_sync(1, 256); };

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // warpgroup 0 embeds the tile's points, warpgroup 1 their directions
    const long long pe = tile * S::TPT + er;
    float x[3];
    if (wg == 0) {
      load3(xyz, pe, pe < n_points, x);
      embed_row<10>(xemb_rows, x, er, half);
    } else if (FULL) {
      load3(dirs, unsigned(pe) / samples_per_dir, pe < n_points, x);  // 32-bit: no call
      embed_row<4>(demb_rows, x, er, half);
    }
    sm90::fence_proxy_async();
    both_sync();

    const long long p = tile * S::TPT + r;  // this thread's rows' points p, p + 8
    float acc[NC / 2];
    float s0 = 0.0f, s1 = 0.0f;
    for (int l = 0; l < prm.depth; ++l) {
      const int n_h = l ? W / KS : 0;
      run_slot<NC>(
          acc, ring, n_h + int((prm.emb_mask >> l) & 1u),
          [&](int j) { return j < n_h ? base + j * BLOCK_BYTES : xemb_rows; }, lane, wg * NC);
      both_sync();  // both warpgroups' products that read the activations have retired
      if (FULL || l + 1 < prm.depth)
        trunk_epilogue<true, false, NC, BLOCK_BYTES>(acc, prm.b[l] + wg * NC,
                                                     prm.heads.w_sigma + wg * NC, my_cols, warp,
                                                     lane, s0, s1);
      else  // the sigma pass's last layer: its head straight from the accumulators
        trunk_epilogue<false, true, NC, BLOCK_BYTES>(acc, prm.b[l] + wg * NC,
                                                     prm.heads.w_sigma + wg * NC, my_cols, warp,
                                                     lane, s0, s1);
      sm90::fence_proxy_async();
      both_sync();  // the layer's activations are written
    }
    if constexpr (FULL)
      sigma_from_smem<NC, BLOCK_BYTES>(prm.heads.w_sigma + wg * NC, my_cols, warp, lane, s0, s1);
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    float c0[3] = {0.0f, 0.0f, 0.0f}, c1[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (FULL) {
      float acc2[NDC / 2];
      run_slot<NDC>(
          acc2, ring, S::DIR_SLICES,
          [&](int j) { return j < W / KS ? base + j * BLOCK_BYTES : demb_rows; }, lane,
          wg * NDC);
      rgb_epilogue<NDC, S::WD>(acc2, prm.heads, lane, c0, c1, wg * NDC);
    }
    // warpgroup 1's partial heads of rows r (lane q 0) and r + 8 (q 1) to warpgroup 0
    float* x_row = xch + 4 * (r + 8 * q);
    if (wg == 1 && q < 2) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) x_row[ch] = q ? c1[ch] : c0[ch];
      x_row[3] = q ? s1 : s0;
    }
    both_sync();  // also: every product reading this tile's embeddings has retired
    if (wg == 0 && q < 2 && p + 8 * q < n_points) {
      const float sigma = ((q ? s1 : s0) + x_row[3]) + __ldg(prm.heads.b_sigma);
      if constexpr (FULL) {
        float rgb[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          rgb[ch] = 1.0f / (1.0f + expf(-(((q ? c1[ch] : c0[ch]) + x_row[ch]) +
                                          __ldg(prm.heads.b_rgb + ch))));
        reinterpret_cast<float4*>(out)[p + 8 * q] = make_float4(rgb[0], rgb[1], rgb[2], sigma);
      } else {
        out[p + 8 * q] = sigma;
      }
    }
  }
}

template <int WIDTH, bool FULL>
__global__ void __launch_bounds__(K1_THREADS, 1)
    nerf_field_kernel(const FieldParams prm, const float* __restrict__ xyz,
                      const float* __restrict__ dirs, unsigned samples_per_dir,
                      float* __restrict__ out, long long n_points, long long n_tiles) {
  using S = Shape<WIDTH>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = sm90::smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring<WIDTH> ring = {base + S::SMEM_ACT, base + S::bars(FULL), 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      sm90::mbar_init(ring.bars + 8 * s, 1);                            // the producer's arrival
      sm90::mbar_init(ring.bars + 8 * (S::STAGES + s), CONSUMERS * 4);  // one per consumer warp
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128)
      produce<WIDTH>(prm, ring, prm.n_trunk + (FULL ? S::DIR_SLICES : 0), n_tiles);
  } else {
    sm90::reg_alloc<232>();
    if constexpr (S::SPLIT) {
      const int xch_at = (base - raw) + S::bars(FULL) + 2 * S::STAGES * 8;  // after the barriers
      float* xch = reinterpret_cast<float*>(smem + xch_at);
      consume_split<WIDTH, FULL>(prm, ring, base, xch, xyz, dirs, samples_per_dir, out, n_points,
                                 n_tiles);
    } else {
      consume<WIDTH, FULL>(prm, ring, base, xyz, dirs, samples_per_dir, out, n_points, n_tiles);
    }
  }
}

template <int WIDTH, bool FULL>
cudaError_t launch(const FieldParams& prm, const float* xyz, const float* dirs,
                   unsigned samples_per_dir, float* out, long long n_points, cudaStream_t s) {
  const int smem = Shape<WIDTH>::smem_bytes(FULL);
  cudaError_t err = cudaFuncSetAttribute(nerf_field_kernel<WIDTH, FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_points + Shape<WIDTH>::TPT - 1) / Shape<WIDTH>::TPT;
  const unsigned grid = unsigned(n_tiles < sms ? n_tiles : sms);
  nerf_field_kernel<WIDTH, FULL><<<grid, K1_THREADS, smem, s>>>(prm, xyz, dirs, samples_per_dir,
                                                                out, n_points, n_tiles);
  return cudaGetLastError();
}

template <int WIDTH>
cudaError_t launch_pass(bool full, const FieldParams& prm, const float* xyz, const float* dirs,
                        unsigned samples_per_dir, float* out, long long n_points, cudaStream_t s) {
  return full ? launch<WIDTH, true>(prm, xyz, dirs, samples_per_dir, out, n_points, s)
              : launch<WIDTH, false>(prm, xyz, dirs, samples_per_dir, out, n_points, s);
}

int smem_bytes(int width, bool full) {
  switch (width) {
    case 128: return Shape<128>::smem_bytes(full);
    case 256: return Shape<256>::smem_bytes(full);
    case 384: return Shape<384>::smem_bytes(full);
    case 512: return Shape<512>::smem_bytes(full);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of the full (1) or sigma-only (0) kernel
// at trunk width `width` (-1 for a width it does not take).
int nerf_field_smem_bytes(int width, int full) { return smem_bytes(width, full != 0); }

// k1_stream: the pack's bf16 weight stream of `stream_elems` elements, in the
// order the header gives for `depth` layers and `emb_mask` (bit l: layer l
// takes the embedding; bit 0 must be set) at trunk width `width` (128, 256,
// 384 or 512). Pointer table `ptrs` (device addresses), depth + 7 long:
// b[0..depth), then w_sigma, b_sigma, w_comb, w_dir, b_comb, w_rgb, b_rgb
// (w_comb and w_dir are read from the stream). xyz: (n_points, 3) f32,
// n_points < 2^31. dirs: (ceil(n_points / samples_per_dir), 3) f32, read
// only when `full`. out: (n_points, 1) f32 sigma, or (n_points, 4) f32 [r,
// g, b, sigma] when `full`. Returns a cudaError_t value.
int nerf_field_forward(const void* k1_stream, long long stream_elems, const void* const* ptrs,
                       int depth, unsigned emb_mask, int width, const float* xyz,
                       const float* dirs, long long samples_per_dir, float* out,
                       long long n_points, int full, void* stream) {
  if (smem_bytes(width, false) < 0 || depth < 1 || depth > MAX_DEPTH || samples_per_dir < 1 ||
      n_points < 0 || n_points > 0x7fffffffLL || !(emb_mask & 1u) || (emb_mask >> depth) != 0u)
    return int(cudaErrorInvalidValue);
  // point indices fit 32 bits, and so does the direction index's divisor
  const unsigned spd = unsigned(samples_per_dir < n_points ? samples_per_dir : n_points);
  FieldParams prm = {};
  prm.stream = static_cast<const bf16*>(k1_stream);
  prm.emb_mask = emb_mask;
  prm.depth = depth;
  for (int l = 0; l < depth; ++l) {
    prm.b[l] = static_cast<const float*>(ptrs[l]);
    prm.n_trunk += (l ? width / KS : 0) + int((emb_mask >> l) & 1u);
  }
  prm.heads = head_params(ptrs + depth);
  if (stream_elems !=
      (long long)prm.n_trunk * width * KS + (long long)(width / KS + 1) * (width / 2) * KS)
    return int(cudaErrorInvalidValue);
  if (n_points == 0) return int(cudaSuccess);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = full != 0;
  switch (width) {
    case 128: return int(launch_pass<128>(f, prm, xyz, dirs, spd, out, n_points, s));
    case 256: return int(launch_pass<256>(f, prm, xyz, dirs, spd, out, n_points, s));
    case 384: return int(launch_pass<384>(f, prm, xyz, dirs, spd, out, n_points, s));
    default: return int(launch_pass<512>(f, prm, xyz, dirs, spd, out, n_points, s));
  }
}

}  // extern "C"
