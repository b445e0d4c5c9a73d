// The eval NeRF fields at any trunk width that is a multiple of 128 and any
// depth, for Hopper (sm_90a), inference only: K1's bf16 field and K4's int8
// field where their resident kernels (csrc/fused_mlp.cu,
// csrc/fused_mlp_int8.cu) cannot hold a tile: trunk widths above 512, and
// fields deeper than their kernel-argument tables (16 layers) or, for K4 at
// widths 128 and 256, than its per-column constants in shared memory.
//
// Replaces, at those shapes, the TPU Pallas kernels
// nerf_siren_tpu/ops/pallas/fused_mlp.py::_sigma_kernel / ::_full_kernel
// (bf16) and nerf_siren_tpu/ops/pallas/fused_mlp_int8.py::_sigma_kernel_int8 /
// ::_full_kernel_int8 (int8), whose pack asserts only width % 128 == 0. Per
// point it computes exactly the function of the resident kernels and of
// their plain PyTorch versions (ops/kernels/fused_mlp.py::fused_sigma_ref /
// fused_full_ref, ops/kernels/fused_mlp_int8.py::fused_sigma_int8_ref /
// fused_full_int8_ref): the embedding, the ReLU trunk with its skip layers,
// the sigma head, and in the full pass the folded direction branch and the
// sigmoid rgb head; bf16 operands with float32 sums (K1), or int8 products
// with exact int32 sums, per-row weight scales and per-point dynamic
// activation scales, every float32 step rounded where the plain version
// rounds it (K4; see csrc/fused_mlp_int8.cu).
//
// Bound: operations. At width 1024 a point costs ~16 MFLOP (7 1024 x 1024
// layers) against 12-24 bytes in and 4-16 bytes out.
//
// Design: no width or depth is refused for shared memory, because no layer's
// activations stay on chip.
// - Persistent grid (one CTA per SM) over tiles of 128 points; consumer
//   warpgroups 0 and 1 own 64 points each, warpgroup 2 is the producer.
// - A layer's input and output activations live in a per-CTA scratch in
//   global memory that the wrapper allocates (two buffers that the layers
//   alternate, in the swizzled 8 KB blocks wgmma reads: block (j, g) holds
//   warpgroup g's 64 rows of columns [64 j, 64 j + 64) in bf16, or
//   [128 j, 128 j + 128) in int8). At width 1024 the 132 CTAs' bf16
//   buffers are 132 x 2 x 128 x 1024 x 2 B = 69 MB; a CTA touches its own
//   512 KB, much of it still in L2 when it is read back.
// - A layer is computed in column blocks of 256 (the widest wgmma; a last
//   block of 128 where W % 256 == 128; the direction branch's last block
//   64, 128 or 192). For each block and each 64-input (bf16) or 128-input
//   (int8) slice, the producer bulk-copies one ring stage: the slice's rows
//   of that column block from the pack's weight stream (`k1_stream` /
//   `k4_stream` unchanged: a column block of a slice is a contiguous run of
//   its rows, itself a swizzled tile because it starts at a multiple of 8
//   rows) beside the two warpgroups' 8 KB blocks of the layer's input from
//   the scratch. Each consumer accumulates the block in registers
//   (m64n256k16 bf16, or m64n256k32 s8: 128 accumulators) and writes its
//   epilogue to the output buffer. The embedding slices' A (xyz or sin/cos,
//   and the direction embedding) is made in shared memory at the tile's
//   start, as the resident kernels make it.
// - Layer order: the next layer's input copies must read what every
//   consumer wrote. Each consumer thread fences its global writes for the
//   async proxy (fence.proxy.async.global) and each warp then arrives on an
//   mbarrier (8 arrivals); the producer waits on it before the next
//   layer's first copy, so the ring drains once a layer.
// - The per-layer tables (bias pointers and the embedding flags; K4's
//   scales and coordinate columns) are in device memory, one row a layer,
//   so any depth fits; the heads' 7 pointers are kernel arguments.
// - K4's per-point scale is the absmax over the whole row. A consumer
//   thread holds its two rows' columns of every column block, so it keeps
//   the row maxima in registers across the blocks (a quad's shuffles
//   finish them), writes each block's float32 activations after bias and
//   ReLU to a scratch of its own (coalesced: element e of thread t at e x
//   256 + t), and once the row's scale is known quantises them from there
//   into the int8 input blocks of the next layer. The last layer is bf16
//   into the bf16 layout, as in the resident kernels.
// - The heads: sigma summed over the column blocks in registers; rgb the
//   same over the direction branch's blocks; the quads' shuffles finish
//   both.
// Shared memory: a 4-stage ring of 48 KB stages (32 KB of weight rows, 16 KB
// of activations), 16 KB of xyz (or sin/cos) embedding, 16 KB of direction
// embedding, the barriers: 225 KB at every width and depth.
//
// Plain C interface, loaded with ctypes; the launcher returns
// cudaGetLastError().

#include "nerf_field_common.cuh"
#include "nerf_field_sm90.cuh"
#include "sm90_async.cuh"

namespace {

using namespace nerf_field;

constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int TILE_PTS = 64 * CONSUMERS;        // points a tile
constexpr int NB = 256;                         // output columns of a block
constexpr int ROW = 128;                        // bytes of a slice row (one swizzle row)
constexpr int BLOCK = 64 * ROW;                 // a warpgroup's rows of a 128-byte column block
constexpr int A_BYTES = CONSUMERS * BLOCK;      // both warpgroups' blocks: one copy a stage
constexpr int B_BYTES = NB * ROW;               // a slice's rows of one column block
constexpr int STAGE = B_BYTES + A_BYTES;        // 48 KB, a multiple of 1024
constexpr int STAGES = 4;
constexpr int EMB = STAGES * STAGE;  // the xyz (K1) or sin/cos (K4) embedding blocks
constexpr int DEMB = EMB + A_BYTES;  // the direction embedding blocks
constexpr int BARS = DEMB + A_BYTES;  // full[s], empty[s], then `ready`
constexpr int SMEM = 1024 /* alignment slack */ + BARS + (2 * STAGES + 1) * 8;
constexpr int K1_FIELDS = 2;  // per layer in the table: bias, emb flag
constexpr int K4_FIELDS = 6;  // per layer: b, f_h, q_x, f_x, f_s, emb flag

struct WideParams {
  const unsigned char* stream;  // k1_stream or k4_stream
  const long long* layers;      // device table, one row of K1_FIELDS / K4_FIELDS a layer
  HeadParams heads;             // w_comb and w_dir unused: they are streamed
  int depth, width, n_trunk;
  unsigned char* scratch;  // the CTAs' scratch, cta_bytes each
  long long cta_bytes;
};

// Per-CTA scratch: K1 two bf16 activation buffers (W / 64 blocks of A_BYTES
// each); K4 two int8 buffers (W / 128 blocks), the bf16 last layer (W / 64
// blocks) and the float32 activations of the 256 consumer threads (W / 2
// each).
__host__ __device__ constexpr long long act_bytes(int w) { return (long long)(w / 64) * A_BYTES; }
__host__ __device__ constexpr long long q_bytes(int w) { return (long long)(w / 128) * A_BYTES; }
long long cta_bytes(bool int8, int w) {
  return int8 ? 2 * q_bytes(w) + act_bytes(w) + (long long)w / 2 * 256 * 4 : 2 * act_bytes(w);
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The 3 int8 coordinate weights of column c, packed as quant_coords packs a point.
__device__ __forceinline__ int qx_word(const int8_t* q_x, int c) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(q_x) + 3 * c;
  return int(__ldg(p)) | (int(__ldg(p + 1)) << 8) | (int(__ldg(p + 2)) << 16);
}

// ---- the ring -----------------------------------------------------------------

using Ring = StageRing<STAGES, STAGE>;

// The mbarrier on which the consumers publish a layer (after the ring's).
__device__ __forceinline__ uint32_t ready_bar(const Ring& ring) { return ring.bars + 16 * STAGES; }

__device__ __forceinline__ const long long* layer_row(const WideParams& p, int l, int fields) {
  return p.layers + (long long)l * fields;
}

// The producer: every stage in the order the consumers take them (see the
// header), waiting on `ready` before each layer that reads the scratch.
template <bool INT8, bool FULL>
__device__ void produce(const WideParams& p, Ring ring, long long n_tiles) {
  const int W = p.width, WD = W / 2, fields = INT8 ? K4_FIELDS : K1_FIELDS;
  const int n_hidden = INT8 ? W / 128 : W / 64;
  const long long trunk_slice = (long long)W * ROW, dir_slice = (long long)WD * ROW;
  unsigned char* cta = p.scratch + (long long)blockIdx.x * p.cta_bytes;
  uint32_t ready_phase = 0;
  auto issue = [&](const unsigned char* b, int rows, const unsigned char* a) {
    sm90::mbar_wait(ring.empty(ring.stage), ring.phase ^ 1u);
    sm90::mbar_arrive_expect_tx(ring.full(), rows * ROW + (a ? A_BYTES : 0));
    sm90::bulk_copy_g2s(ring.slot(), b, rows * ROW, ring.full());
    if (a) sm90::bulk_copy_g2s(ring.slot() + B_BYTES, a, A_BYTES, ring.full());
    ring.advance();
  };
  auto wait_ready = [&] {
    sm90::mbar_wait(ready_bar(ring), ready_phase);
    ready_phase ^= 1u;
  };
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const unsigned char* src = p.stream;
    for (int l = 0; l < p.depth; ++l) {
      const bool emb = __ldg(layer_row(p, l, fields) + fields - 1) != 0;
      const int nk = l ? n_hidden : 0;
      if (l) wait_ready();
      const unsigned char* in = cta + ((l - 1) & 1) * (INT8 ? q_bytes(W) : act_bytes(W));
      for (int c0 = 0; c0 < W; c0 += NB) {
        const int rows = min(NB, W - c0);
        for (int k = 0; k < nk; ++k)
          issue(src + k * trunk_slice + c0 * ROW, rows, in + k * A_BYTES);
        if (emb) issue(src + nk * trunk_slice + c0 * ROW, rows, nullptr);
      }
      src += (nk + int(emb)) * trunk_slice;
    }
    if (FULL) {  // the direction branch: W_comb's slices on the last layer, then W_dir's
      wait_ready();
      const unsigned char* h =
          INT8 ? cta + 2 * q_bytes(W) : cta + ((p.depth - 1) & 1) * act_bytes(W);
      for (int c0 = 0; c0 < WD; c0 += NB) {
        const int rows = min(NB, WD - c0);
        for (int k = 0; k < W / 64; ++k)
          issue(src + k * dir_slice + c0 * ROW, rows, h + k * A_BYTES);
        issue(src + (W / 64) * dir_slice + c0 * ROW, rows, nullptr);
      }
    }
  }
}

// acc = sum over n ring stages of A_j x (the stage's first N rows), A_j at
// a_of(j, stage address); KSTEPS wgmma k-steps of 32 bytes a stage, two
// stages' products in flight, each stage released once they retire.
template <int KSTEPS, typename T, int N2, typename AOf, typename Product>
__device__ __forceinline__ void run_stages(T (&acc)[N2], Ring& ring, int n, AOf a_of,
                                           Product product, int lane) {
  int held = -1;
#pragma unroll
  for (int i = 0; i < N2; ++i) acc[i] = T(0);
  for (int j = 0; j < n; ++j) {
    sm90::mbar_wait(ring.full(), ring.phase);
    const uint32_t a = a_of(j, ring.slot()), b = ring.slot();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      product(acc, sm90::desc_sw128(a + 32 * kk), sm90::desc_sw128(b + 32 * kk), j > 0 || kk > 0);
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
}

// Byte offset, in a bf16 activation buffer, of the pair of columns (c, c + 1)
// of row r (r % 8 == g) of warpgroup wg's rows.
__device__ __forceinline__ long long bf16_at(int c, int wg, int r, int g) {
  return (long long)(c >> 6) * A_BYTES + wg * BLOCK + r * 128 + ((((c >> 3) & 7) ^ g) << 4) +
         (c & 7) * 2;
}

// The same in an int8 buffer.
__device__ __forceinline__ long long int8_at(int c, int wg, int r, int g) {
  return (long long)(c >> 7) * A_BYTES + wg * BLOCK + r * 128 + ((((c >> 4) & 7) ^ g) << 4) +
         (c & 15);
}

__device__ __forceinline__ void st_global_b32(unsigned char* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// bf16(relu(y + bias)) of the thread's two rows of an N-column block from
// column c0: stored to `out` (a bf16 buffer) when given; with SIGMA, s0 / s1
// gain the partial dots with w_sigma.
template <int N, bool SIGMA, typename Y>
__device__ __forceinline__ void bf16_epilogue(const Y& y, const float* __restrict__ bias,
                                              const bf16* __restrict__ w_sigma, int c0,
                                              unsigned char* out, int wg, int r, int lane,
                                              float& s0, float& s1) {
  const int q = lane & 3, g = lane >> 2;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = c0 + 8 * i + 2 * q;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + c));
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(fmaxf(__fadd_rn(y[4 * i], bb.x), 0.0f),
                                                    fmaxf(__fadd_rn(y[4 * i + 1], bb.y), 0.0f));
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(fmaxf(__fadd_rn(y[4 * i + 2], bb.x), 0.0f),
                                                    fmaxf(__fadd_rn(y[4 * i + 3], bb.y), 0.0f));
    if (out) {
      unsigned char* a = out + bf16_at(c, wg, r, g);
      st_global_b32(a, bf162_bits(h0));
      st_global_b32(a + 8 * 128, bf162_bits(h1));
    }
    if (SIGMA) {
      const float2 ws = ldg_bf162(w_sigma + c);
      s0 += __low2float(h0) * ws.x + __high2float(h0) * ws.y;
      s1 += __low2float(h1) * ws.x + __high2float(h1) * ws.y;
    }
  }
}

// The direction branch's N-column block from column d0 (of WD): c0 / c1
// gain the thread's partial rgb sums of its two rows.
template <int N>
__device__ __forceinline__ void rgb_partial(const float (&acc)[N / 2], const HeadParams& hp,
                                            int d0, int wd, int lane, float (&c0)[3],
                                            float (&c1)[3]) {
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = d0 + 8 * i + 2 * q;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(hp.b_comb + c));
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(fmaxf(acc[4 * i] + bb.x, 0.0f),
                                                    fmaxf(acc[4 * i + 1] + bb.y, 0.0f));
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(fmaxf(acc[4 * i + 2] + bb.x, 0.0f),
                                                    fmaxf(acc[4 * i + 3] + bb.y, 0.0f));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float2 w = ldg_bf162(hp.w_rgb + ch * wd + c);
      c0[ch] += __low2float(h0) * w.x + __high2float(h0) * w.y;
      c1[ch] += __low2float(h1) * w.x + __high2float(h1) * w.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void dir_block(Ring& ring, int W, uint32_t demb_rows, int wg,
                                          const HeadParams& hp, int d0, int lane, float (&c0)[3],
                                          float (&c1)[3]) {
  float acc[N / 2];
  run_stages<4>(
      acc, ring, W / 64 + 1,
      [&](int j, uint32_t slot) { return j < W / 64 ? slot + B_BYTES + wg * BLOCK : demb_rows; },
      [](float(&d)[N / 2], uint64_t a, uint64_t b, int acc_) { sm90::wgmma_ss<N>(d, a, b, acc_); },
      lane);
  rgb_partial<N>(acc, hp, d0, W / 2, lane, c0, c1);
}

// The direction branch and the outputs of the thread's rows p and p + 8.
template <bool FULL>
__device__ __forceinline__ void heads_out(Ring& ring, const WideParams& prm, uint32_t demb_rows,
                                          int wg, int lane, float s0, float s1, long long p,
                                          long long n_points, float* __restrict__ out) {
  const int q = lane & 3, W = prm.width, WD = W / 2;
  const float b_sigma = __ldg(prm.heads.b_sigma);
  s0 = quad_sum(s0) + b_sigma;
  s1 = quad_sum(s1) + b_sigma;
  if constexpr (FULL) {
    float c0[3] = {0.0f, 0.0f, 0.0f}, c1[3] = {0.0f, 0.0f, 0.0f};
    for (int d0 = 0; d0 < WD; d0 += NB) {
      switch (min(NB, WD - d0)) {
        case 256: dir_block<256>(ring, W, demb_rows, wg, prm.heads, d0, lane, c0, c1); break;
        case 192: dir_block<192>(ring, W, demb_rows, wg, prm.heads, d0, lane, c0, c1); break;
        case 128: dir_block<128>(ring, W, demb_rows, wg, prm.heads, d0, lane, c0, c1); break;
        default: dir_block<64>(ring, W, demb_rows, wg, prm.heads, d0, lane, c0, c1); break;
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      c0[ch] = quad_sum(c0[ch]);
      c1[ch] = quad_sum(c1[ch]);
    }
    if (q < 2 && p + 8 * q < n_points) {
      float rgb[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        rgb[ch] = 1.0f / (1.0f + expf(-((q ? c1[ch] : c0[ch]) + __ldg(prm.heads.b_rgb + ch))));
      reinterpret_cast<float4*>(out)[p + 8 * q] = make_float4(rgb[0], rgb[1], rgb[2], q ? s1 : s0);
    }
  } else {
    if (q < 2 && p + 8 * q < n_points) out[p + 8 * q] = q ? s1 : s0;
  }
}

// Every consumer thread's global writes of a layer made visible to the
// producer's copies: a fence each, then one arrival a warp on `ready`.
__device__ __forceinline__ void publish(const Ring& ring, int lane) {
  fence_proxy_async_global();
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(ready_bar(ring));
}

// ---- K1 (bf16) ----------------------------------------------------------------

template <int N>
__device__ __forceinline__ void k1_block(Ring& ring, int nk, bool emb, uint32_t xemb_rows,
                                         const float* bias, const bf16* w_sigma, int c0,
                                         unsigned char* out, bool sigma, int wg, int r, int lane,
                                         float& s0, float& s1) {
  float acc[N / 2];
  run_stages<4>(
      acc, ring, nk + int(emb),
      [&](int j, uint32_t slot) { return j < nk ? slot + B_BYTES + wg * BLOCK : xemb_rows; },
      [](float(&d)[N / 2], uint64_t a, uint64_t b, int acc_) { sm90::wgmma_ss<N>(d, a, b, acc_); },
      lane);
  if (sigma)
    bf16_epilogue<N, true>(acc, bias, w_sigma, c0, out, wg, r, lane, s0, s1);
  else
    bf16_epilogue<N, false>(acc, bias, w_sigma, c0, out, wg, r, lane, s0, s1);
}

template <bool FULL>
__device__ void consume_k1(const WideParams& prm, Ring ring, uint32_t base,
                           const float* __restrict__ xyz, const float* __restrict__ dirs,
                           unsigned samples_per_dir, float* __restrict__ out, long long n_points,
                           long long n_tiles) {
  const int W = prm.width, depth = prm.depth;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int r = warp * 16 + (lane >> 2);
  const uint32_t xemb_rows = base + EMB + wg * BLOCK, demb_rows = base + DEMB + wg * BLOCK;
  const int er = t >> 1, half = t & 1;
  unsigned char* cta = prm.scratch + (long long)blockIdx.x * prm.cta_bytes;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long pe = tile * TILE_PTS + wg * 64 + er;
    float x[3];
    load3(xyz, pe, pe < n_points, x);
    embed_row<10>(xemb_rows, x, er, half);
    if constexpr (FULL) {
      load3(dirs, unsigned(pe) / samples_per_dir, pe < n_points, x);
      embed_row<4>(demb_rows, x, er, half);
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + wg, 128);

    float s0 = 0.0f, s1 = 0.0f;
    for (int l = 0; l < depth; ++l) {
      const long long* row = layer_row(prm, l, K1_FIELDS);
      const float* bias = reinterpret_cast<const float*>(__ldg(row));
      const bool emb = __ldg(row + 1) != 0, last = l + 1 == depth;
      const int nk = l ? W / 64 : 0;
      unsigned char* dst = (!last || FULL) ? cta + (l & 1) * act_bytes(W) : nullptr;
      for (int c0 = 0; c0 < W; c0 += NB) {
        if (W - c0 >= 256)
          k1_block<256>(ring, nk, emb, xemb_rows, bias, prm.heads.w_sigma, c0, dst, last, wg, r,
                        lane, s0, s1);
        else
          k1_block<128>(ring, nk, emb, xemb_rows, bias, prm.heads.w_sigma, c0, dst, last, wg, r,
                        lane, s0, s1);
      }
      if (!last || FULL) publish(ring, lane);
    }
    heads_out<FULL>(ring, prm, demb_rows, wg, lane, s0, s1, tile * TILE_PTS + wg * 64 + r,
                    n_points, out);
    sm90::named_bar_sync(1 + wg, 128);  // every product reading this tile's embeddings retired
  }
}

// ---- K4 (int8) ----------------------------------------------------------------

// One layer's N-column block from column c0: the products, then in the plain
// version's order (acc f_h) s_h [+ (q_x . x_q) f_x s_x] [+ (sin/cos) f_s]
// (layer 0: the x-term, then the sin/cos term), + b, ReLU. Not the last
// layer: the values go to the thread's float32 scratch `ys` and the row
// maxima m0 / m1 grow; the last: bf16 into `hout` (when given) and the
// sigma partials.
template <int N>
__device__ __forceinline__ void k4_block(Ring& ring, int l, int nk, bool emb, bool last,
                                         uint32_t sc_rows, const long long* trow,
                                         const bf16* w_sigma, int c0, const float (&sh)[2],
                                         const float (&sx)[2], const int (&xq)[2], float* ys,
                                         unsigned char* hout, int wg, int r, int lane, float& m0,
                                         float& m1, float& s0, float& s1) {
  const int q = lane & 3;
  const float* b = reinterpret_cast<const float*>(__ldg(trow));
  const float* f_h = reinterpret_cast<const float*>(__ldg(trow + 1));
  const int8_t* q_x = reinterpret_cast<const int8_t*>(__ldg(trow + 2));
  const float* f_x = reinterpret_cast<const float*>(__ldg(trow + 3));
  const float* f_s = reinterpret_cast<const float*>(__ldg(trow + 4));
  auto s8 = [](int(&d)[N / 2], uint64_t a, uint64_t bb, int acc_) {
    sm90::wgmma_s8<N>(d, a, bb, acc_);
  };
  int acc[N / 2];
  float y[N / 2];
  if (l == 0)
    run_stages<2>(acc, ring, 1, [&](int, uint32_t) { return sc_rows; }, s8, lane);
  else
    run_stages<4>(acc, ring, nk, [&](int, uint32_t slot) { return slot + B_BYTES + wg * BLOCK; },
                  s8, lane);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = c0 + 8 * i + 2 * q;
    float2 fh = {}, fx = {}, fs = {};
    int qx0 = 0, qx1 = 0;
    if (l) fh = __ldg(reinterpret_cast<const float2*>(f_h + c));
    if (emb) {
      fx = __ldg(reinterpret_cast<const float2*>(f_x + c));
      qx0 = qx_word(q_x, c);
      qx1 = qx_word(q_x, c + 1);
    }
    if (l == 0) fs = __ldg(reinterpret_cast<const float2*>(f_s + c));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      const bool odd = e & 1;
      float v = 0.0f;
      if (l) v = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + e]), odd ? fh.y : fh.x), sh[row]);
      if (emb) {
        const int dx = __dp4a(xq[row], odd ? qx1 : qx0, 0);
        const float tx = __fmul_rn(__fmul_rn(__int2float_rn(dx), odd ? fx.y : fx.x), sx[row]);
        v = l ? __fadd_rn(v, tx) : tx;
      }
      if (l == 0) v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc[4 * i + e]), odd ? fs.y : fs.x));
      y[4 * i + e] = v;
    }
  }
  if (l && emb) {  // the skip layer's sin/cos product, 32 columns at a time
    sm90::mbar_wait(ring.full(), ring.phase);
    const uint32_t bslot = ring.slot();
#pragma unroll  // y's registers are indexed by j: a rolled loop would put y in local memory
    for (int j = 0; j < N / 32; ++j) {
      int d[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = 0;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_m64n32k32_s8(d, sm90::desc_sw128(sc_rows + 32 * kk),
                                 sm90::desc_sw128(bslot + j * 32 * ROW + 32 * kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operand(d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __ldg(reinterpret_cast<const float2*>(f_s + c0 + 32 * j + 8 * i + 2 * q));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = y[16 * j + 4 * i + e];
          v = __fadd_rn(v, __fmul_rn(__int2float_rn(d[4 * i + e]), (e & 1) ? f.y : f.x));
        }
      }
    }
    if (lane == 0) sm90::mbar_arrive(ring.empty(ring.stage));
    ring.advance();
  }
  if (last) {
    bf16_epilogue<N, true>(y, b, w_sigma, c0, hout, wg, r, lane, s0, s1);
    return;
  }
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c0 + 8 * i + 2 * q));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = fmaxf(__fadd_rn(y[4 * i + e], (e & 1) ? bb.y : bb.x), 0.0f);
      ys[(c0 / 2 + 4 * i + e) * 256] = v;
      if (e < 2) m0 = fmaxf(m0, v);
      else m1 = fmaxf(m1, v);
    }
  }
}

// The int8 input of the next layer from the scratch, at the rows' scales.
template <int N>
__device__ __forceinline__ void k4_quantise(const float* ys, int c0, const float (&sh)[2],
                                            const float (&rc)[2], unsigned char* qout, int wg,
                                            int r, int lane, int8_t* d0, int8_t* d1) {
  const int q = lane & 3, g = lane >> 2;
#pragma unroll 4
  for (int i = 0; i < N / 8; ++i) {
    const int c = c0 + 8 * i + 2 * q;
    const float* v = ys + (c0 / 2 + 4 * i) * 256;
    const uint32_t v0 = __byte_perm(quant_pos(v[0], sh[0], rc[0]), quant_pos(v[256], sh[0], rc[0]),
                                    0x40);
    const uint32_t v1 = __byte_perm(quant_pos(v[512], sh[1], rc[1]),
                                    quant_pos(v[768], sh[1], rc[1]), 0x40);
    unsigned char* a = qout + int8_at(c, wg, r, g);
    *reinterpret_cast<uint16_t*>(a) = uint16_t(v0);
    *reinterpret_cast<uint16_t*>(a + 8 * 128) = uint16_t(v1);
    if (d0) *reinterpret_cast<uint16_t*>(d0 + c) = uint16_t(v0);
    if (d1) *reinterpret_cast<uint16_t*>(d1 + c) = uint16_t(v1);
  }
}

template <bool FULL>
__device__ void consume_k4(const WideParams& prm, Ring ring, uint32_t base,
                           const float* __restrict__ xyz, const float* __restrict__ dirs,
                           unsigned samples_per_dir, float* __restrict__ out, long long n_points,
                           long long n_tiles, int8_t* __restrict__ dump) {
  const int W = prm.width, depth = prm.depth;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int q = lane & 3, r = warp * 16 + (lane >> 2);
  const uint32_t sc_rows = base + EMB + wg * BLOCK, demb_rows = base + DEMB + wg * BLOCK;
  const int er = t >> 1, half = t & 1;
  unsigned char* cta = prm.scratch + (long long)blockIdx.x * prm.cta_bytes;
  unsigned char* hbuf = cta + 2 * q_bytes(W);
  float* ys = reinterpret_cast<float*>(hbuf + act_bytes(W)) + threadIdx.x;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p0 = tile * TILE_PTS + wg * 64, pe = p0 + er, p = p0 + r;
    float x[3];
    load3(xyz, pe, pe < n_points, x);
    embed_sincos(sc_rows, x, er, half, dump && pe < n_points ? dump + pe * W : nullptr);
    if constexpr (FULL) {
      load3(dirs, unsigned(pe) / samples_per_dir, pe < n_points, x);
      embed_row<4>(demb_rows, x, er, half);
    }
    float sx[2], sh[2] = {0.0f, 0.0f};
    int xq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      quant_coords(xyz, p + 8 * h, p + 8 * h < n_points, sx[h], xq[h]);
      if (dump && q == 0 && p + 8 * h < n_points) {
#pragma unroll
        for (int j = 0; j < 3; ++j) dump[(p + 8 * h) * W + j] = int8_t(xq[h] >> (8 * j));
      }
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + wg, 128);

    float s0 = 0.0f, s1 = 0.0f;
    for (int l = 0; l < depth; ++l) {
      const long long* trow = layer_row(prm, l, K4_FIELDS);
      const bool emb = __ldg(trow + 5) != 0, last = l + 1 == depth;
      const int nk = l ? W / 128 : 0;
      float m0 = 0.0f, m1 = 0.0f;
      unsigned char* hout = last && FULL ? hbuf : nullptr;
      for (int c0 = 0; c0 < W; c0 += NB) {
        if (W - c0 >= 256)
          k4_block<256>(ring, l, nk, emb, last, sc_rows, trow, prm.heads.w_sigma, c0, sh, sx, xq,
                        ys, hout, wg, r, lane, m0, m1, s0, s1);
        else
          k4_block<128>(ring, l, nk, emb, last, sc_rows, trow, prm.heads.w_sigma, c0, sh, sx, xq,
                        ys, hout, wg, r, lane, m0, m1, s0, s1);
      }
      if (!last) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        sh[0] = __fmul_rn(fmaxf(m0, 1e-9f), INV127);
        sh[1] = __fmul_rn(fmaxf(m1, 1e-9f), INV127);
        const float rc[2] = {rcp_refined(sh[0]), rcp_refined(sh[1])};
        unsigned char* qout = cta + (l & 1) * q_bytes(W);
        int8_t* slot = dump ? dump + (long long)(l + 1) * n_points * W : nullptr;
        int8_t* d0 = slot && p < n_points ? slot + p * W : nullptr;
        int8_t* d1 = slot && p + 8 < n_points ? slot + (p + 8) * W : nullptr;
        for (int c0 = 0; c0 < W; c0 += NB) {
          if (W - c0 >= 256)
            k4_quantise<256>(ys, c0, sh, rc, qout, wg, r, lane, d0, d1);
          else
            k4_quantise<128>(ys, c0, sh, rc, qout, wg, r, lane, d0, d1);
        }
      }
      if (!last || FULL) publish(ring, lane);
    }
    heads_out<FULL>(ring, prm, demb_rows, wg, lane, s0, s1, p, n_points, out);
    sm90::named_bar_sync(1 + wg, 128);
  }
}

template <bool INT8, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
    nerf_field_wide_kernel(const WideParams prm, const float* __restrict__ xyz,
                           const float* __restrict__ dirs, unsigned samples_per_dir,
                           float* __restrict__ out, long long n_points, long long n_tiles,
                           int8_t* __restrict__ dump) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = sm90::smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const Ring ring = {base, base + BARS, 0, 0u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(ring.bars + 8 * s, 1);                          // the producer's arrival
      sm90::mbar_init(ring.bars + 8 * (STAGES + s), CONSUMERS * 4);  // one per consumer warp
    }
    sm90::mbar_init(ready_bar(ring), CONSUMERS * 4);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * 128) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS * 128) produce<INT8, FULL>(prm, ring, n_tiles);
  } else {
    sm90::reg_alloc<232>();
    if constexpr (INT8)
      consume_k4<FULL>(prm, ring, base, xyz, dirs, samples_per_dir, out, n_points, n_tiles, dump);
    else
      consume_k1<FULL>(prm, ring, base, xyz, dirs, samples_per_dir, out, n_points, n_tiles);
  }
}

template <bool INT8, bool FULL>
cudaError_t launch(const WideParams& prm, int grid, const float* xyz, const float* dirs,
                   unsigned spd, float* out, long long n_points, int8_t* dump, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(nerf_field_wide_kernel<INT8, FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_points + TILE_PTS - 1) / TILE_PTS;
  nerf_field_wide_kernel<INT8, FULL><<<unsigned(grid < n_tiles ? grid : n_tiles), THREADS, SMEM,
                                       s>>>(prm, xyz, dirs, spd, out, n_points, n_tiles, dump);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one CTA's scratch (int8: K4, else K1) at trunk width `width`.
long long nerf_field_wide_cta_bytes(int int8, int width) {
  if (width < 128 || width % 128) return -1;
  return cta_bytes(int8 != 0, width);
}

// Dynamic shared memory of one CTA, at every width and depth.
int nerf_field_wide_smem_bytes() { return SMEM; }

// int8: 0 for K1 (`stream` the pack's k1_stream), 1 for K4 (its k4_stream),
// of `stream_bytes` bytes holding `n_trunk` trunk slices (W rows of 128
// bytes each) and the direction branch's W / 64 + 1 slices (W / 2 rows).
// layers: device table of depth rows, K1 {bias, emb} and K4 {b, f_h, q_x,
// f_x, f_s, emb} (device addresses as int64, 0 where absent; emb 1 where the
// layer takes the embedding, row 0's must). heads: host array of the 7 head
// pointers (HeadParams order). scratch: `grid` x nerf_field_wide_cta_bytes
// bytes; at most `grid` CTAs run. xyz (n_points, 3) f32, n_points < 2^31;
// dirs (ceil(n_points / samples_per_dir), 3) f32 when `full`; out (n_points,
// 1) f32 sigma or (n_points, 4) f32 [r, g, b, sigma]; dump (K4 only): null
// or (depth, n_points, width) int8 zero-filled, each layer's int8 input.
// Returns a cudaError_t value.
int nerf_field_wide_forward(int int8, const void* stream_w, long long stream_bytes,
                            const long long* layers, int depth, int width, int n_trunk,
                            const void* const* heads, const float* xyz, const float* dirs,
                            long long samples_per_dir, float* out, long long n_points, int full,
                            void* dump, void* scratch, int grid, void* stream) {
  if (width < 128 || width % 128 || depth < 1 || n_trunk < 1 || samples_per_dir < 1 ||
      n_points < 0 || n_points > 0x7fffffffLL || grid < 1 || !layers || !scratch ||
      (dump && !int8))
    return int(cudaErrorInvalidValue);
  if (stream_bytes !=
      (long long)n_trunk * width * ROW + (long long)(width / 64 + 1) * (width / 2) * ROW)
    return int(cudaErrorInvalidValue);
  if (n_points == 0) return int(cudaSuccess);
  WideParams prm = {};
  prm.stream = static_cast<const unsigned char*>(stream_w);
  prm.layers = layers;
  prm.heads = head_params(heads);
  prm.depth = depth;
  prm.width = width;
  prm.n_trunk = n_trunk;
  prm.scratch = static_cast<unsigned char*>(scratch);
  prm.cta_bytes = cta_bytes(int8 != 0, width);
  const unsigned spd = unsigned(samples_per_dir < n_points ? samples_per_dir : n_points);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* d = static_cast<int8_t*>(dump);
  if (int8)
    return int(full ? launch<true, true>(prm, grid, xyz, dirs, spd, out, n_points, d, s)
                    : launch<true, false>(prm, grid, xyz, dirs, spd, out, n_points, d, s));
  return int(full ? launch<false, true>(prm, grid, xyz, dirs, spd, out, n_points, nullptr, s)
                  : launch<false, false>(prm, grid, xyz, dirs, spd, out, n_points, nullptr, s));
}

}  // extern "C"
