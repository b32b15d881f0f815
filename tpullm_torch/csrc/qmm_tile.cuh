// One 128 x 128 output tile of y = x @ dequant(W)^T over K-major weights:
// the body of kernel F (moe_gmm.cu) alone, which runs it on one expert's
// weights per row tile.
//
// A block of 8 warps (each 32 x 64) walks K in 64-deep steps. Per step it
// computes the step's (scale group, column) scales and biases once into
// shared memory, dequantizes the (64, 128) weight tile into shared memory as
// bf16 (the _plane_tile counterpart, km_weight of kmajor.cuh), stages the
// (128, 64) x tile, and multiplies with WMMA bf16 tensor-core fragments,
// f32 accumulation. Rows at or past M are masked.
#pragma once

#include <mma.h>

#include "kmajor.cuh"

namespace tpk {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int G_THREADS = 256;
constexpr int XS_LD = BK + 8;   // bf16 elements
constexpr int WS_LD = BN + 8;   // bf16 elements
constexpr int MAXG = 4;         // scale groups per BK chunk (gs >= 16)

// Host-side shape rule of the tile: N in whole tiles, each BK chunk inside
// one plane, 16-byte x rows.
inline bool qmm_tile_ok(const KmW& w, int K) {
  const int P = w.kind == KIND_U4 ? 2 : 1;
  return w.K == K && w.Npad % BN == 0 && (K / P) % BK == 0 && K % 8 == 0;
}

__device__ __forceinline__ void qmm_tile(const __nv_bfloat16* __restrict__ x, int M,
                                         const KmW& w, void* out, int Nout,
                                         int out_bf16, int m0, int n0) {
  using namespace nvcuda;
  // main loop: x tile | weight tile | per-(group, column) scale and bias;
  // epilogue: one 16 x 16 f32 staging tile per warp, over the same bytes
  __shared__ __align__(128) unsigned char
      smem[(BM * XS_LD + BK * WS_LD) * 2 + 2 * MAXG * BN * 4];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + BM * XS_LD;
  float* sc_s = reinterpret_cast<float*>(ws + BK * WS_LD);
  float* bi_s = sc_s + MAXG * BN;

  const int K = w.K, N = w.Npad, gs = w.gs;
  const int P = w.kind == KIND_U4 ? 2 : 1;
  const int Kr = K / P;
  const int ng = BK >= gs ? BK / gs : 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps, 32 x 64 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int wc = (tid % 8) * 16;  // weight tile: thread -> 2 rows x 16 columns

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int g_first = k0 / gs;
    for (int i = tid; i < ng * BN; i += G_THREADS)
      km_group(w, g_first + i / BN, n0 + i % BN, sc_s[i], bi_s[i]);
    for (int i = tid; i < BM * BK / 8; i += G_THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * XS_LD + c) = v;
    }
    __syncthreads();
    // a BK chunk lies in one plane: Kr % BK == 0
    const int j = k0 / Kr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tid / 8 + 32 * h;
      const int k = k0 + row, r = k - j * Kr;
      const int gi = k / gs - g_first;
      const uint4 qv = __ldg(reinterpret_cast<const uint4*>(w.q + (size_t)r * N + n0 + wc));
      const uint8_t* qb = reinterpret_cast<const uint8_t*>(&qv);
      __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int u = P == 2 ? (int)((qb[c] >> (4 * j)) & 15) : (int)(int8_t)qb[c];
        vals[c] = __float2bfloat16_rn(
            km_weight(w, u, sc_s[gi * BN + wc + c], bi_s[gi * BN + wc + c]));
      }
      *reinterpret_cast<uint4*>(ws + row * WS_LD + wc) = *reinterpret_cast<uint4*>(vals);
      *reinterpret_cast<uint4*>(ws + row * WS_LD + wc + 8) = *reinterpret_cast<uint4*>(vals + 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * XS_LD + kk, XS_LD);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        wmma::load_matrix_sync(b[jn], ws + kk * WS_LD + wn * 64 + jn * 16, WS_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) wmma::mma_sync(acc[i][jn], a[i], b[jn], acc[i][jn]);
    }
    __syncthreads();
  }
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      wmma::store_matrix_sync(stage, acc[i][jn], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + i * 16 + e / 16;
        const int n = n0 + wn * 64 + jn * 16 + e % 16;
        if (m < M && n < Nout) {
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(out)[(size_t)m * Nout + n] =
                __float2bfloat16_rn(stage[e]);
          else
            reinterpret_cast<float*>(out)[(size_t)m * Nout + n] = stage[e];
        }
      }
      __syncwarp();
    }
}

}  // namespace tpk
