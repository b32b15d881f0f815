// The split-K slab body shared by kernel A (qmm.cu, one work item a block)
// and kernel D (layer_kernel.cu, a persistent grid walking the items of each
// phase): one work item is the f32 product of x's rows with the columns
// [n0, n0 + 256 / WK) of a K-major weight over one K slab of whole scale
// groups, stored as that slab's partial sums.
//
// - The products run on the tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   sums): the dequantized weights are the A operand (16 columns x 16 k), x
//   the B operand (16 k x 8 batch rows; MT = 8, 16, 32 take 1, 2, 4 n8
//   tiles). The order of k and of columns inside a fragment is free as long
//   as x's fragment and the store follow it, so each lane fills its A
//   fragment straight from the 8-byte loads of its own 8 columns: for u4 a
//   byte's two nibble planes (k = r and r + K/2) are one k pair, for i8 two
//   packed rows are; of a lane's 8 columns, two are rows g and g + 8 of each
//   of 4 products. No weight passes through shared memory.
// - x's slab is staged once in shared memory as those B fragments (bf16
//   pairs in the same k order), read as one 8-byte load a lane. Where x comes
//   from is the caller's (a Stager): kernel A reads bf16 rows, kernel D also
//   applies the rmsnorm while it stages.
// - A weight costs a byte permute and an exact add (int to float), a
//   multiply by the scale, an add of the bias (affine kinds only), half a
//   bf16x2 pack, and no branch: the body is templated on the kind and the
//   dequant mode (kmajor.cuh), bit-exact with dequant_kmajor_torch.
// - Items are short (8-32 k16 steps a warp), so nothing waits once the loop
//   runs: the slab's raw scale rows come into shared memory by cp.async
//   beside the first weight loads, and each group's scales are computed from
//   there; a lane issues the next k step's loads before it dequantizes the
//   current one's. Warps hide the latency: registers are held to 85 at
//   MT = 8 so that an SM holds 6 blocks (24 warps).
// - WK is the number of warps along K. WK = 1 (kernel A): the 4 warps take
//   64 neighbouring columns each over the whole slab. WK = 2 (kernel D): a
//   block takes 128 columns, and the 2 warps of a column group each take
//   half the slab's k steps; their sums meet in shared memory, added in
//   warp order. Narrower, deeper items cut the slab partials a column tile
//   leaves to be reduced.
#pragma once

#include "hopper.cuh"
#include "kmajor.cuh"

namespace tps {

using namespace tph;
using namespace tpk;

constexpr int SK_WARPS = 4;             // a block: 4 warps of 64 columns (WK = 1)
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_COLS = 64 * SK_WARPS;  // ops/qmm.py SPLITK_COLS
constexpr int STAGE = 4;                // staging entries a thread loads at once
constexpr int MIN_BLOCKS = 6;           // blocks an SM holds at MT = 8: caps registers at 85

// 8 bytes of q (a lane's 8 columns of one packed row), streamed: no L1
// allocation, and L2 fetches the LB-byte span of the row that the block's
// warps share (256 / WK columns)
template <int LB>
__device__ __forceinline__ uint2 ld_q(const uint8_t* p) {
  static_assert(LB == 256 || LB == 128, "an item spans 256 or 128 columns");
  uint2 v;
  if constexpr (LB == 256)
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y)
                 : "l"(p));
  else
    asm volatile("ld.global.nc.L1::no_allocate.L2::128B.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y)
                 : "l"(p));
  return v;
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A 16-byte copy from global to shared memory that does not hold the thread
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}

// Rows [row0, row0 + rows) of a (rows, Npad) array of EB-byte elements, the
// block's COLS columns from n0, copied to dst (rows packed) by cp16
template <int EB, int COLS>
__device__ __forceinline__ void stage_rows(void* dst, const void* base, size_t row0, int rows,
                                           int N, int n0) {
  constexpr int CH = COLS * EB / 16;  // 16-byte chunks a row
  const uint8_t* src = reinterpret_cast<const uint8_t*>(base) + (row0 * N + n0) * EB;
  for (int i = threadIdx.x; i < rows * CH; i += SK_THREADS)
    cp16(reinterpret_cast<uint8_t*>(dst) + i * 16, src + (size_t)(i / CH) * N * EB + i % CH * 16);
}

// Byte offsets of a block's shared memory: x's B fragments, then the raw
// scale rows of its slab, plane by plane: d rows (nd of them a plane; a
// slab of whole groups may straddle d rows), dmin rows (i8d) or bm rows
// (f32, one a group), s8 rows and m8 rows (one a group). With WK > 1 the
// same bytes later hold the sums the warps pass to warp 0 of their column
// group; total covers both.
struct SlabSmem {
  int nd, d, b, s8, m8, total;
};

__host__ __device__ inline SlabSmem slab_smem(const KmW& w, int gps, int MT, int WK) {
  const int P = w.kind == KIND_U4 ? 2 : 1, nr = gps * w.gs, cols = SK_COLS / WK;
  SlabSmem o;
  o.nd = (nr + w.ds - 1) / w.ds + 1;
  o.d = nr * P * MT * 2;
  o.b = o.d + P * o.nd * cols * 4;
  o.s8 = o.b + (w.bias == BIAS_I8D ? P * o.nd : w.bias == BIAS_F32 ? P * gps : 0) * cols * 4;
  o.m8 = o.s8 + (w.sb ? P * gps * cols : 0);
  o.total = o.m8 + (w.bias == BIAS_I8D ? P * gps * cols : 0);
  const int pass = (WK - 1) * SK_THREADS / WK * 16 * (MT / 8) * 4;  // acc of warps wk > 0
  if (o.total < pass) o.total = pass;
  return o;
}

// Scales and biases of the slab's group gl, plane p, at the lane's 8
// columns [nl, nl + 8) of the block, from the staged rows; dl is the
// group's d row in the slab's copy. The arithmetic is km_group's.
template <int MODE, int COLS>
__device__ __forceinline__ void group_scales(const KmW& w, const uint8_t* sm, const SlabSmem& o,
                                             int gps, int gl, int p, int dl, int nl,
                                             float (&sc)[8], float (&bi)[8]) {
  const int drow = (p * o.nd + dl) * COLS + nl, grow = (p * gps + gl) * COLS + nl;
  const float4 d0 = *reinterpret_cast<const float4*>(sm + o.d + drow * 4);
  const float4 d1 = *reinterpret_cast<const float4*>(sm + o.d + drow * 4 + 16);
  const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  if (w.sb) {
    const uint2 s8 = *reinterpret_cast<const uint2*>(sm + o.s8 + grow);
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[c] = __fmul_rn(i8_to_f32(c < 4 ? s8.x : s8.y, c % 4), d[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) sc[c] = d[c];
  }
  if (MODE != MODE_BIAS) return;
  const bool i8d = w.bias == BIAS_I8D;
  const uint8_t* br = sm + o.b + (i8d ? drow : grow) * 4;
  const float4 b0 = *reinterpret_cast<const float4*>(br);
  const float4 b1 = *reinterpret_cast<const float4*>(br + 16);
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  if (i8d) {
    const uint2 m8 = *reinterpret_cast<const uint2*>(sm + o.m8 + grow);
#pragma unroll
    for (int c = 0; c < 8; ++c) bi[c] = -__fmul_rn(i8_to_f32(c < 4 ? m8.x : m8.y, c % 4), b[c]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) bi[c] = b[c];
  }
}

// x as read-only bf16 rows (M, ld). An x source's row(m) is a cursor over
// row m: cursor + k moves it, cursor[k] gives the bf16 bits of x[m, k + ...].
struct LdgRow {
  const uint16_t* p;
  __device__ __forceinline__ LdgRow operator+(int k) const { return {p + k}; }
  __device__ __forceinline__ uint32_t operator[](int k) const { return __ldg(p + k); }
};
struct XRows {
  const uint16_t* x;
  int ld;
  __device__ __forceinline__ LdgRow row(int m) const { return {x + (size_t)m * ld}; }
};

// x's slab (packed rows [r0, r0 + nks * KR) of each plane) as B fragments in
// xf: [k step][n8 tile][lane], STAGE entries a thread at a time so that
// their loads are in flight together; xs is an x source (XRows).
template <int MT, int P, class XS>
__device__ __forceinline__ void stage_x(uint2* xf, const XS& xs, int M, int Kr, int r0,
                                        int nks) {
  constexpr int NT = MT / 8;  // n8 tiles of batch rows
  constexpr int KR = 16 / P;  // packed rows of a k16 step
  const int nx = nks * NT * 32;
  for (int i0 = threadIdx.x; i0 < nx; i0 += STAGE * SK_THREADS) {
    uint2 e[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const int i = i0 + u * SK_THREADS;
      const int l = i % 32, t = i / 32 % NT, ks = i / (32 * NT);
      const int m = t * 8 + l / 4;
      uint32_t h[4] = {0u, 0u, 0u, 0u};  // logical k 2tq, 2tq + 1, 2tq + 8, 2tq + 9
      if (i < nx && m < M) {
        const auto xr = xs.row(m) + (r0 + ks * KR + l % 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = xr[P == 2 ? (j / 2) * 4 + (j % 2) * Kr : 4 * j];
      }
      e[u] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (i0 + u * SK_THREADS < nx) xf[i0 + u * SK_THREADS] = e[u];
  }
}

// One work item: columns [n0, n0 + 256 / WK) of w over K slab s (gps scale
// groups from group s * gps), the f32 sums of rows m < M stored to part
// (nS, M, Npad). stager.template run<MT, P>(xf, M, Kr, r0, nks) stages x's
// slab; sm is the block's dynamic shared memory (slab_smem(w, gps, MT,
// WK).total bytes, 16-byte aligned) and lut 16 floats of shared memory. The
// caller syncs the block before an item reuses either.
//
// Lane (gq = lane / 4, tq = lane % 4) of a warp, k step ks of the slab: the
// A fragment of product i holds columns n + 2i (row gq) and n + 2i + 1 (row
// gq + 8); its k pair 0 (logical k 2tq, 2tq + 1) and pair 1 (2tq + 8,
// 2tq + 9) are, for u4, the two nibble planes of packed rows tq and tq + 4
// of the step, for i8 packed rows (tq, tq + 4) and (tq + 8, tq + 12). x's B
// fragment follows the same k order, and the C fragment gives column n + 2i
// (c0, c1) and n + 2i + 1 (c2, c3) at batch rows 2tq and 2tq + 1.
template <int MT, int KIND, int MODE, int WK, class Stager>
__device__ __forceinline__ void slab_item(const KmW& w, int M, int n0, int s, int gps,
                                          float* __restrict__ part, uint8_t* sm, float* lut,
                                          const Stager& stager) {
  constexpr int P = KIND == KIND_U4 ? 2 : 1;
  constexpr int NT = MT / 8;           // n8 tiles of batch rows
  constexpr int KR = 16 / P;           // packed rows of a k16 step
  constexpr int NR = KR / 4;           // of them a lane's: rows tq + 4j
  constexpr int WN = SK_WARPS / WK;    // column groups of 64
  constexpr int COLS = 64 * WN;        // columns of the item
  uint2* xf = reinterpret_cast<uint2*>(sm);  // x's B fragments: [k step][n8 tile][lane]
  const int K = w.K, N = w.Npad, gs = w.gs;
  const int Kr = K / P, G = Kr / gs;
  const int g0 = s * gps, r0 = g0 * gs;
  const int nks = gps * gs / KR, kpg = gs / KR;  // k steps in the slab, in a group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int wk = WK == 1 ? 0 : warp / WN;
  const int kb = wk * nks / WK, ke = (wk + 1) * nks / WK;  // the warp's k steps
  const int nl = warp % WN * 64 + gq * 8;
  const int lds = 31 - __clz(w.ds);
  const size_t step = (size_t)KR * N;  // bytes of q between k steps
  const uint8_t* qn = w.q + (size_t)(r0 + kb * KR + tq) * N + n0 + nl;

  uint2 buf[NR];  // the first k step's loads go out before anything else
  if (WK == 1 || kb < ke) {
#pragma unroll
    for (int j = 0; j < NR; ++j) buf[j] = ld_q<COLS>(qn + (size_t)4 * j * N);
  }

  // The slab's raw scale rows by cp.async, in flight beside those loads
  const SlabSmem o = slab_smem(w, gps, MT, WK);
  const int dlo = r0 >> lds, nd = ((r0 + gps * gs - 1) >> lds) - dlo + 1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t dp = (size_t)((p * Kr) >> lds) + dlo, gp = (size_t)p * G + g0;
    stage_rows<4, COLS>(sm + o.d + p * o.nd * COLS * 4, w.d, dp, nd, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_I8D)
      stage_rows<4, COLS>(sm + o.b + p * o.nd * COLS * 4, w.dmin, dp, nd, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_F32)
      stage_rows<4, COLS>(sm + o.b + p * gps * COLS * 4, w.bm, gp, gps, N, n0);
    if (w.sb) stage_rows<1, COLS>(sm + o.s8 + p * gps * COLS, w.s8, gp, gps, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_I8D)
      stage_rows<1, COLS>(sm + o.m8 + p * gps * COLS, w.m8, gp, gps, N, n0);
  }

  if (MODE == MODE_LUT && threadIdx.x < 16) lut[threadIdx.x] = w.lut[threadIdx.x];
  stager.template run<MT, P>(xf, M, Kr, r0, nks);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const float offc = km_offc<KIND>(w.off);
  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][t][c] = 0.f;
  float sc[P][8], bi[P][8];
  int gl = WK == 1 ? -1 : kb / kpg - 1;  // the slab's scale group of the current k step
#pragma unroll 1
  for (int ks = kb; ks < ke; ++ks) {
    // v[pair][element][half]: the stored integers as bytes, half 0 the
    // columns nl..nl+3, half 1 nl+4..nl+7
    uint32_t v[2][2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint2 word = buf[P == 2 ? q : 2 * q + e];
        v[q][e][0] = to_bytes<KIND>(word.x, P == 2 ? e : 0);
        v[q][e][1] = to_bytes<KIND>(word.y, P == 2 ? e : 0);
      }
    if (ks + 1 < ke) {  // the next k step's loads, in flight while this one computes
      qn += step;
#pragma unroll
      for (int j = 0; j < NR; ++j) buf[j] = ld_q<COLS>(qn + (size_t)4 * j * N);
    }
    // a new scale group (for WK > 1 also the warp's first step, which may
    // fall inside a group)
    if ((ks & (kpg - 1)) == 0 || (WK > 1 && ks == kb)) {
      gl = WK == 1 ? gl + 1 : ks / kpg;
      const int dl = ((r0 + gl * gs) >> lds) - dlo;
#pragma unroll
      for (int p = 0; p < P; ++p)
        group_scales<MODE, COLS>(w, sm, o, gps, gl, p, dl, nl, sc[p], bi[p]);
    }
    uint2 b[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) b[t] = xf[(ks * NT + t) * 32 + lane];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = 2 * mi + cc;
          float f[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = P == 2 ? e : 0;
            f[e] = km_dq<MODE>(km_val<MODE>(v[q][e][c / 4], c % 4, offc, lut), sc[p][c],
                               bi[p][c]);
          }
          a[2 * q + cc] = pack_bf16(f[0], f[1]);
        }
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_16816(acc[mi][t], a, b[t]);
    }
  }
  if constexpr (WK > 1) {
    // warps wk > 0 pass their sums through shared memory to warp 0 of their
    // column group, which adds them in warp order
    __syncthreads();  // every warp is done with x's fragments
    float* pass = reinterpret_cast<float*>(sm);
    constexpr int AN = 16 * NT;  // sums a thread holds
    if (wk > 0) {
      float* dst = pass + ((wk - 1) * WN * 32 + warp % WN * 32 + lane) * AN;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t)
          *reinterpret_cast<float4*>(dst + (i * NT + t) * 4) =
              make_float4(acc[i][t][0], acc[i][t][1], acc[i][t][2], acc[i][t][3]);
    }
    __syncthreads();
    if (wk > 0) return;
#pragma unroll 1
    for (int j = 1; j < WK; ++j) {
      const float* src = pass + ((j - 1) * WN * 32 + warp * 32 + lane) * AN;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float4 f = *reinterpret_cast<const float4*>(src + (i * NT + t) * 4);
          acc[i][t][0] += f.x;
          acc[i][t][1] += f.y;
          acc[i][t][2] += f.z;
          acc[i][t][3] += f.w;
        }
    }
  }
  const int n = n0 + nl;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = t * 8 + 2 * tq + h;
      if (m < M) {
        float4* out = reinterpret_cast<float4*>(part + ((size_t)s * M + m) * N + n);
        out[0] = make_float4(acc[0][t][h], acc[0][t][2 + h], acc[1][t][h], acc[1][t][2 + h]);
        out[1] = make_float4(acc[2][t][h], acc[2][t][2 + h], acc[3][t][h], acc[3][t][2 + h]);
      }
    }
}

}  // namespace tps
