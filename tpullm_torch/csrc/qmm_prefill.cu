// Kernels B and F: the prefill dequant-GEMM over K-major weights,
// y[m, n] = sum_k x[m, k] * bf16(dequant(W)[n, k]), on Hopper's wgmma, and
// its grouped form over expert-sorted rows.
//
// B replaces tpullm/ops/qmm.py:239 _build_qmm (pallas_call :294).
// F replaces tpullm/ops/moe_gmm.py:33 _build_gmm (pallas_call :109), the MoE
// prefill's MUL_MAT_ID: rows arrive sorted by routed expert and padded per
// expert to whole 256-row tiles (ops/moe_gmm.py:sort_by_expert), and row
// tile t multiplies by expert tile_expert[t]'s weight. Both run one body
// (qmm_tile); F puts an expert indirection in front of it.
//
// Bound on this card: operations. At the engine's prefill (M = 2048) a
// weight byte feeds ~2048 flops, far above the ~295 flop/byte where the
// tensor cores become the limit: 2 M N K / 989 TFLOP/s, 0.49 ms for
// gateup (28672 x 4096). F at the Mixtral prefill (4096 assignments of
// 2048 tokens to 8 experts, ~512 rows an expert) feeds ~512 flops a weight
// byte: also operations, 0.49 ms for a gate or up call.
//
// What the design does about it. The tensor cores should not wait for the
// dequant, and the dequant is paid as rarely as possible:
// - A block owns a 256-row x 128-column output tile, so each dequantized
//   64 x 128 weight chunk feeds 256 rows (wgmma's M is the tokens, its N
//   the weight columns). Blocks of one column tile run side by side (the
//   grid's fast axis is the row tile), so the weight bytes come from HBM
//   about once and x stays in L2.
// - Warp specialisation, 384 threads. One producer warpgroup, which
//   setmaxnreg leaves with 120 registers, dequantizes: per chunk it
//   computes the (group, column) scales once from the staged scale rows
//   and writes the bf16 weight tile into the 128-byte swizzled K-major
//   layout that the wgmma descriptor names; its thread 0 also asks TMA for
//   the x tile (256 x 64 bf16, 128-byte swizzled, rows past M arriving as
//   zeros). Two consumer warpgroups (128 rows each, two m64n128 f32
//   accumulators = 128 registers a thread) issue wgmma.mma_async
//   m64n128k16 from shared memory with one chunk of products kept in
//   flight, and the raw chunks' TMA copies, R chunks ahead: the quantized
//   chunk (64 x 128 bytes: one nibble plane for u4) and its scale rows,
//   in four shares. Issuing a TMA copy stalls the issuing warp for
//   hundreds of cycles, and the consumers have that time to spare.
// - Rings: S stages of (x tile, weight tile) with a full and an empty
//   mbarrier each, R raw stages with one mbarrier each. A raw stage is
//   refilled once full[kc] shows the producer done with it.
// - A stored integer becomes a float with one byte permute and one exact
//   add (0x4B0000bb is 2^23 + bb); val * scale + bias in rounded steps and
//   one rounding to bf16, bit-exact with dequant_kmajor_torch.
// - F's weights are one (L?, E, rows, Npad) stack: each array's TMA map
//   covers the whole stack as (slots x rows, Npad), and a block moves every
//   weight coordinate to its expert's rows, (layer x E + expert) x rows + r,
//   read from tile_expert[blockIdx.x] (the TPU kernel's scalar prefetch).
//   A 64-deep chunk never crosses into the next slot's rows. A tile at or
//   past the live count writes its zeros and returns before any barrier
//   exists.
// No split-K and no atomics: each output element is summed over K in one
// fixed order, so repeats are bit-identical. The epilogue stores pairs of
// adjacent columns straight from the accumulators, masking rows >= M and
// columns >= Nout.

#include "hopper.cuh"
#include "kmajor.cuh"

using namespace tph;
using namespace tpk;

namespace {

constexpr int BM = 256, BN = 128, BK = 64;
constexpr int S = 3;                   // stages of the x / weight-tile ring
constexpr int R = 5;                   // stages of the raw-chunk ring
constexpr int X_BYTES = BM * BK * 2;   // x tile: 256 rows of 128 B
constexpr int W_BYTES = BN * BK * 2;   // weight tile: 128 rows (columns n) of 128 B
constexpr int Q_BYTES = BK * BN;       // raw chunk: 64 rows of 128 bytes
constexpr int MAXG = 4;                // scale groups in a chunk (gs >= 16)
// staged scale rows of a chunk: d, then dmin or bm (f32 x 128 each), s8, m8
constexpr int META_D = 0, META_B = MAXG * BN * 4, META_S8 = 2 * MAXG * BN * 4,
              META_M8 = META_S8 + MAXG * BN, META_BYTES = META_M8 + MAXG * BN;
constexpr int RAW_BYTES = Q_BYTES + META_BYTES;
constexpr int THREADS = 384;           // producer warpgroup, then two consumer warpgroups
constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;
constexpr int SMEM = 1024 + S * (X_BYTES + W_BYTES) + R * RAW_BYTES + (2 * S + R) * 8 + 64;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "register file");
static_assert(RAW_BYTES % 1024 == 0, "raw stages keep the ring 1024-aligned");

// One octet (8 consecutive k) x 4 columns of the weight tile: v[i] holds the
// 4 columns' stored integers of row i as bytes (u4: one nibble a byte;
// i8: the value xor 0x80). The dequantized weight is bit-exact with
// dequant_kmajor_torch: val * scale, then + bias, rounded steps, one
// rounding to bf16 (kmajor.cuh: km_val's byte-permute int-to-float, km_dq).
template <int MODE>
__device__ __forceinline__ void dequant_octet(const uint32_t (&v)[8], const float (&sc)[4],
                                              const float (&bi)[4], float offc,
                                              const float* lut, uint8_t* wt, int oct, int nl) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float f[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = km_dq<MODE>(km_val<MODE>(v[i], c, offc, lut), sc[c], bi[c]);
    const int n = nl + c;
    uint4 p = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                         pack_bf16(f[6], f[7]));
    *reinterpret_cast<uint4*>(wt + n * 128 + ((oct ^ (n & 7)) << 4)) = p;
  }
}

// the 64 accumulators of one m64n128 half -> out rows [mrow, mrow + 64),
// pairs of adjacent columns per store; rows >= M and columns >= Nout masked
__device__ __forceinline__ void store_half(const float (&d)[64], int mrow, int n0, int M,
                                           int Nout, void* out, int out_bf16) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = mrow + (t / 32) * 16 + lane / 4;
  const int c0 = n0 + (lane % 4) * 2;
  const bool pairs = (Nout & 1) == 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = c0 + 8 * j;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = r0 + 8 * hh;
      const float a = d[4 * j + 2 * hh], b = d[4 * j + 2 * hh + 1];
      if (m >= M || n >= Nout) continue;
      const size_t o = (size_t)m * Nout + n;
      if (out_bf16) {
        __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(out) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
        } else {
          y[0] = __float2bfloat16_rn(a);
          if (n + 1 < Nout) y[1] = __float2bfloat16_rn(b);
        }
      } else {
        float* y = reinterpret_cast<float*>(out) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(y) = make_float2(a, b);
        } else {
          y[0] = a;
          if (n + 1 < Nout) y[1] = b;
        }
      }
    }
  }
}


// TMA maps of a weight's arrays: q rows, d rows, dmin (per d row) or bm
// (per group) rows, s8 and m8 rows; a box is one chunk's rows x 128 columns
struct WMaps {
  CUtensorMap q, d, b, s8, m8;
};

// Share `part` (0-3) of raw chunk kc's copies into a raw stage by TMA: the
// q rows of its plane; its d rows; its dmin or bm rows; its s8 and m8 rows;
// all of weight `slot` of the stack the maps cover. Each share's issuing
// thread arrives once on bar (count 4) with its bytes, so the stage
// completes when all four shares have landed.
__device__ __forceinline__ void load_raw(const WMaps& wm, const KmW& w, int part, int kc, int n0,
                                         int Kr, int lgs, int lds, int slot, uint32_t raw,
                                         uint32_t bar) {
  const int k0 = kc * BK;
  const int ks = slot * w.K + k0;  // K is whole d rows and scale groups
  const int drows = lds >= 6 ? 1 : BK >> lds, grows = lgs >= 6 ? 1 : BK >> lgs;
  if (part == 0) {
    mbar_expect_tx(bar, Q_BYTES);
    tma_2d(raw, &wm.q, bar, n0, slot * Kr + k0 - (k0 / Kr) * Kr);
  } else if (part == 1) {
    mbar_expect_tx(bar, drows * BN * 4);
    tma_2d(raw + Q_BYTES + META_D, &wm.d, bar, n0, ks >> lds);
  } else if (part == 2) {
    const bool by_d = w.bias == BIAS_I8D;
    mbar_expect_tx(bar, w.bias == BIAS_NONE ? 0 : (by_d ? drows : grows) * BN * 4);
    if (w.bias != BIAS_NONE)
      tma_2d(raw + Q_BYTES + META_B, &wm.b, bar, n0, ks >> (by_d ? lds : lgs));
  } else {
    mbar_expect_tx(bar, ((w.sb ? 1 : 0) + (w.bias == BIAS_I8D ? 1 : 0)) * grows * BN);
    if (w.sb) tma_2d(raw + Q_BYTES + META_S8, &wm.s8, bar, n0, ks >> lgs);
    if (w.bias == BIAS_I8D) tma_2d(raw + Q_BYTES + META_M8, &wm.m8, bar, n0, ks >> lgs);
  }
}

// Producer: the scales and biases of 4 columns [nl, nl + 4) from the staged
// rows: dl is the d row in the chunk, gl the group
__device__ __forceinline__ void stage_scales(const KmW& w, const uint8_t* meta, int dl, int gl,
                                             int nl, float (&sc)[4], float (&bi)[4]) {
  const float4 d = *reinterpret_cast<const float4*>(meta + META_D + dl * 512 + nl * 4);
  sc[0] = d.x, sc[1] = d.y, sc[2] = d.z, sc[3] = d.w;
  bi[0] = bi[1] = bi[2] = bi[3] = 0.f;
  if (w.sb) {
    const uint32_t s = *reinterpret_cast<const uint32_t*>(meta + META_S8 + gl * 128 + nl);
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[c] = __fmul_rn(i8_to_f32(s, c), sc[c]);
  }
  if (w.bias != BIAS_NONE) {
    const int bl = w.bias == BIAS_I8D ? dl : gl;
    const float4 b = *reinterpret_cast<const float4*>(meta + META_B + bl * 512 + nl * 4);
    bi[0] = b.x, bi[1] = b.y, bi[2] = b.z, bi[3] = b.w;
  }
  if (w.bias == BIAS_I8D) {
    const uint32_t m = *reinterpret_cast<const uint32_t*>(meta + META_M8 + gl * 128 + nl);
#pragma unroll
    for (int c = 0; c < 4; ++c) bi[c] = -__fmul_rn(i8_to_f32(m, c), bi[c]);
  }
}

// Producer thread t's share of a chunk: two octets x 4 columns [nl, nl + 4)
// of the weight tile, from the raw stage to the swizzled bf16 tile. Lanes of
// one warp take different octets (xor of lane bits 1-2), so that any 8
// neighbouring lanes store to 8 distinct 16-byte slots of the swizzled rows:
// no bank conflicts. Both octets' loads come before their arithmetic.
template <int KIND, int MODE>
__device__ __forceinline__ void dequant_chunk(const KmW& w, const uint8_t* raw, uint8_t* wt,
                                              int k0, int plane, int lgs, int lds, int t,
                                              float offc, const float* lut) {
  const int lane = t % 32, nl = lane * 4;
  int oct[2];
  float sc[2][4], bi[2][4];
  uint32_t v[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    oct[h] = (t / 32 + 4 * h) ^ ((lane >> 1) & 3);
    const int k = k0 + oct[h] * 8;
    stage_scales(w, raw + Q_BYTES, (k >> lds) - (k0 >> lds), (k >> lgs) - (k0 >> lgs), nl,
                 sc[h], bi[h]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[h][i] = to_bytes<KIND>(
          *reinterpret_cast<const uint32_t*>(raw + (oct[h] * 8 + i) * 128 + nl), plane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) dequant_octet<MODE>(v[h], sc[h], bi[h], offc, lut, wt, oct[h], nl);
}

// The block's 256 x 128 output tile, out[m0:, n0:] = x[m0:] @ W[slot]^T,
// with (m0, n0) from the block's place in the grid: B's whole kernel and
// F's live tiles.
template <int KIND>
__device__ __forceinline__ void qmm_tile(const CUtensorMap& xmap, const WMaps& wm, int M,
                                         const KmW& w, void* out, int Nout, int out_bf16,
                                         int lgs, int lds, int slot) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (saddr(smem_raw) & 1023u)) & 1023u;
  uint8_t* ring = smem_raw + pad;                  // S x (x tile, weight tile)
  uint8_t* raws = ring + S * (X_BYTES + W_BYTES);  // R x (raw chunk, scale rows)
  uint64_t* full = reinterpret_cast<uint64_t*>(raws + R * RAW_BYTES);
  uint64_t* empty = full + S;
  uint64_t* rfull = empty + S;  // R: a raw stage has landed
  float* lut = reinterpret_cast<float*>(rfull + R);
  const uint32_t ring_a = saddr(ring);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nK = w.K / BK;
  const int Kr = w.K / (KIND == KIND_U4 ? 2 : 1);  // rows of a q plane
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(saddr(full + s), 128 + 1);  // producer threads + the x TMA's expect_tx
      mbar_init(saddr(empty + s), 2);       // one thread of each consumer warpgroup
    }
    for (int r = 0; r < R; ++r) mbar_init(saddr(rfull + r), 4);  // one per share
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < 16) lut[tid] = w.lut[tid];
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int t = tid;
    const uint32_t rfull_a = saddr(rfull);
    const int mode = km_mode(w);
    const float offc = km_offc<KIND>(w.off);
    if (t == 0) prefetch_map(&xmap);  // thread 0 issues the x tiles' copies
#pragma unroll 1
    for (int kc = 0; kc < nK; ++kc) {
      const int s = kc % S;
      mbar_wait(saddr(empty + s), ((kc / S) & 1) ^ 1);  // chunk kc - S consumed
      uint8_t* stage = ring + s * (X_BYTES + W_BYTES);
      if (t == 0) {
        mbar_expect_tx(saddr(full + s), X_BYTES);
        tma_2d(saddr(stage), &xmap, saddr(full + s), kc * BK, m0);
      }
      mbar_wait(rfull_a + (kc % R) * 8, (kc / R) & 1);  // raw chunk kc has landed
      const int k0 = kc * BK;
      const int plane = k0 / Kr;
      const uint8_t* raw = raws + (kc % R) * RAW_BYTES;
      uint8_t* wt = stage + X_BYTES;
      if (mode == MODE_LUT)
        dequant_chunk<KIND, MODE_LUT>(w, raw, wt, k0, plane, lgs, lds, t, offc, lut);
      else if (mode == MODE_BIAS)
        dequant_chunk<KIND, MODE_BIAS>(w, raw, wt, k0, plane, lgs, lds, t, offc, lut);
      else
        dequant_chunk<KIND, MODE_OFF>(w, raw, wt, k0, plane, lgs, lds, t, offc, lut);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // tile -> wgmma's view
      mbar_arrive(saddr(full + s));
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = tid / 128 - 1;  // rows [128 cw, 128 cw + 128) of the tile
    // Lane 0 of the first two warps of each consumer warpgroup issues one
    // share of the raw chunks' copies: chunk kc + R into chunk kc's raw stage
    // once full[kc] shows the producer done with it. This keeps the TMA
    // issue, which stalls the issuing warp, off the producer's path.
    const int part = cw * 2 + (tid / 32) % 4;
    const bool loader = tid % 32 == 0 && (tid / 32) % 4 < 2;
    const uint32_t raws_a = saddr(raws), rfull_a = saddr(rfull);
    if (loader) {
      if (part == 0) prefetch_map(&wm.q);
      if (part == 1) prefetch_map(&wm.d);
      if (part == 2 && w.bias != BIAS_NONE) prefetch_map(&wm.b);
      if (part == 3 && w.sb) prefetch_map(&wm.s8);
      if (part == 3 && w.bias == BIAS_I8D) prefetch_map(&wm.m8);
      for (int c = 0; c < R && c < nK; ++c)
        load_raw(wm, w, part, c, n0, Kr, lgs, lds, slot, raws_a + c * RAW_BYTES,
                 rfull_a + c * 8);
    }
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < nK; ++kc) {
      const int s = kc % S;
      mbar_wait(saddr(full + s), (kc / S) & 1);
      const uint32_t xa = ring_a + s * (X_BYTES + W_BYTES) + cw * 128 * 128;
      const uint32_t wa = ring_a + s * (X_BYTES + W_BYTES) + X_BYTES;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t db = sw128_desc(wa + k * 32);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_m64n128k16(acc[h], sw128_desc(xa + h * 64 * 128 + k * 32), db);
      }
      wgmma_commit();
      if (loader && kc + R < nK)
        load_raw(wm, w, part, kc + R, n0, Kr, lgs, lds, slot, raws_a + (kc % R) * RAW_BYTES,
                 rfull_a + (kc % R) * 8);
      wgmma_wait<1>();  // chunk kc - 1's products are done: release its stage
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (kc > 0 && tid % 128 == 0) mbar_arrive(saddr(empty + (kc - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_half(acc[h], m0 + cw * 128 + h * 64, n0, M, Nout, out, out_bf16);
  }
}

// B: x (M, K) @ W^T, one 256 x 128 tile a block
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ WMaps wm,
                 int M, KmW w, void* out, int Nout, int out_bf16, int lgs, int lds) {
  qmm_tile<KIND>(xmap, wm, M, w, out, Nout, out_bf16, lgs, lds, 0);
}

// F's expert indirection: row tile t multiplies by weight
// layer * E + tile_expert[t] of the stack; tiles at or past *live (when
// given) hold no row
struct Moe {
  const int* tile_expert;
  const int* live;
  int layer, E;
};

// bf16 zeros over out[m0:m0 + 256, n0:n0 + 128], columns >= Nout masked
__device__ __forceinline__ void store_zeros(int m0, int n0, int Nout, __nv_bfloat16* out) {
  if (Nout % 8 == 0) {  // 16-byte stores: rows start 16-byte aligned
    for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
      const int n = n0 + (i % (BN / 8)) * 8;
      if (n < Nout)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + i / (BN / 8)) * Nout + n) =
            make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int n = n0 + i % BN;
      if (n < Nout) out[(size_t)(m0 + i / BN) * Nout + n] = __float2bfloat16_rn(0.f);
    }
  }
}

// F: xs (Mp, K) expert-sorted rows @ W[layer, tile_expert[t]]^T per row
// tile, bf16 out. A dead tile returns before the body's barriers exist, all
// of its threads together, so no warp waits on a barrier that never
// completes.
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ WMaps wm,
               int M, KmW w, void* out, int Nout, int lgs, int lds, Moe moe) {
  const int t = blockIdx.x;
  if (moe.live != nullptr && t >= __ldg(moe.live)) {
    store_zeros(t * BM, blockIdx.y * BN, Nout, reinterpret_cast<__nv_bfloat16*>(out));
    return;
  }
  qmm_tile<KIND>(xmap, wm, M, w, out, Nout, 1, lgs, lds,
                 moe.layer * moe.E + __ldg(moe.tile_expert + t));
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The body's shape rule: N in whole tiles, each 64-deep chunk inside one
// plane (and so inside one weight of a stack), K in whole d rows, scale
// groups of 16 to 256 and power-of-two group and d-row sizes, 16-byte x rows
bool takes(const KmW& w, int M, int K, int Nout) {
  const int P = w.kind == KIND_U4 ? 2 : 1;
  return M >= 1 && w.K == K && w.Npad % BN == 0 && (K / P) % BK == 0 && K % 8 == 0 &&
         K % w.ds == 0 && Nout <= w.Npad && w.gs >= 16 && pow2(w.gs) && pow2(w.ds) &&
         w.ds >= w.gs;
}

// Maps over a stack of `slots` weights (1 for B), then B's kernel, or F's
// when moe is given
template <int KIND>
int launch(const void* x, int M, const KmW& w, int slots, void* out, int Nout, int out_bf16,
           const Moe* moe, cudaStream_t st) {
  const int P = KIND == KIND_U4 ? 2 : 1;
  const int K = w.K, N = w.Npad;
  int lgs = 0, lds = 0;
  while ((1 << lgs) < w.gs) ++lgs;
  while ((1 << lds) < w.ds) ++lds;
  const int drows = w.ds >= BK ? 1 : BK / w.ds;  // d rows in a chunk
  const int grows = w.gs >= BK ? 1 : BK / w.gs;  // scale groups in a chunk
  const long long SK = (long long)slots * K;
  const CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap xmap;
  WMaps wm{};  // maps of absent arrays stay zero and unused
  int err = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, BK, BM,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  err = err ? err : make_map(&wm.q, U8, 1, w.q, N, SK / P, BN, BK, NONE);
  err = err ? err : make_map(&wm.d, F32, 4, w.d, N, SK / w.ds, BN, drows, NONE);
  if (w.bias == BIAS_I8D) {
    err = err ? err : make_map(&wm.b, F32, 4, w.dmin, N, SK / w.ds, BN, drows, NONE);
    err = err ? err : make_map(&wm.m8, U8, 1, w.m8, N, SK / w.gs, BN, grows, NONE);
  } else if (w.bias == BIAS_F32) {
    err = err ? err : make_map(&wm.b, F32, 4, w.bm, N, SK / w.gs, BN, grows, NONE);
  }
  if (w.sb) err = err ? err : make_map(&wm.s8, U8, 1, w.s8, N, SK / w.gs, BN, grows, NONE);
  if (err) return err;
  dim3 grid((M + BM - 1) / BM, N / BN);
  cudaError_t e;
  if (moe) {
    e = cudaFuncSetAttribute(moe_gmm_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    moe_gmm_kernel<KIND><<<grid, THREADS, SMEM, st>>>(xmap, wm, M, w, out, Nout, lgs, lds,
                                                      *moe);
  } else {
    e = cudaFuncSetAttribute(qmm_wgmma_kernel<KIND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    qmm_wgmma_kernel<KIND><<<grid, THREADS, SMEM, st>>>(xmap, wm, M, w, out, Nout, out_bf16,
                                                        lgs, lds);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B: x (M, K) bf16 -> out (M, Nout), bf16 or f32.
int tpq_qmm(const void* x, int M, int K, const unsigned long long* wp, const int* wi,
            const float* wf, void* out, int Nout, int out_bf16, void* stream) {
  cudaGetLastError();
  KmW w = make_kmw(wp, wi, wf);
  if (!takes(w, M, K, Nout)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return w.kind == KIND_U4 ? launch<KIND_U4>(x, M, w, 1, out, Nout, out_bf16, nullptr, st)
                           : launch<KIND_I8>(x, M, w, 1, out, Nout, out_bf16, nullptr, st);
}

// F: xs (Mp, K) bf16 expert-sorted rows, tile_expert (Mp / 256,) int32,
// live (1,) int32 or null, weights a contiguous stack of `slots` (L?, E)
// weights of (rows, Npad) arrays, layer (0 without L) -> out (Mp, Nout) bf16.
int tpq_moe_gmm(const void* x, int Mp, int K, const unsigned long long* wp, const int* wi,
                const float* wf, const void* tile_expert, const void* live, int layer, int E,
                int slots, void* out, int Nout, void* stream) {
  cudaGetLastError();
  KmW w = make_kmw(wp, wi, wf);
  if (!takes(w, Mp, K, Nout) || Mp % BM || E < 1 || layer < 0 || (layer + 1) * E > slots)
    return (int)cudaErrorInvalidValue;
  const Moe moe{reinterpret_cast<const int*>(tile_expert), reinterpret_cast<const int*>(live),
                layer, E};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return w.kind == KIND_U4 ? launch<KIND_U4>(x, Mp, w, slots, out, Nout, 1, &moe, st)
                           : launch<KIND_I8>(x, Mp, w, slots, out, Nout, 1, &moe, st);
}

}  // extern "C"
