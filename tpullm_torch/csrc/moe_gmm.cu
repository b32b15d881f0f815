// Grouped (ragged) dequant-GEMM over expert-sorted rows: kernel F.
//
// Replaces tpullm/ops/moe_gmm.py:_build_gmm (pallas_call :109), the MoE
// prefill's MUL_MAT_ID. Rows arrive sorted by routed expert and padded per
// expert to whole 128-row tiles (ops/moe_gmm.py:sort_by_expert); tile t
// multiplies its rows by expert tile_expert[t]'s K-major weights.
//
// Bound on this card: operations. At the Mixtral prefill shape (5120 rows,
// N 14336, K 4096) a tile's 128 rows do 256 flops per weight byte read, and
// the weights of the 8 experts (33 MB each) are read once per row tile.
// Design: kernel B's tile (qmm_tile.cuh: per 64-deep K step, the step's
// scales into shared memory, the weight tile dequantized there as bf16,
// WMMA bf16 fragments with f32 sums) with an expert indirection in front:
// grid (N tiles, row tiles); each block reads its tile's expert id from
// device memory (the TPU kernel's scalar prefetch) and offsets every weight
// array by (layer * E + expert) times that array's per-expert stride.
//
// Tiles past the live range (the static padding, which the TPU kernel
// computes on the last expert's weights over zero rows) are skipped when
// the caller passes the live-tile count in device memory: such a block
// writes its zero output and returns. Every output row is written, so the
// output equals the plain version's over all rows.
// Simple and right first: no pipelining, no wgmma, no weight reuse across
// the row tiles of one expert beyond what L2 gives.
#include "kmajor.cuh"
#include "qmm_tile.cuh"

using namespace tpk;

namespace {

// per-expert element strides of the six K-major arrays (q, d, s8, m8,
// dmin, bm); 0 for an absent array
struct ExpertStrides {
  long long s[6];
};

// two blocks per SM, as kernel B gets at 128 registers: without the bound
// the expert indirection takes the kernel to 132 registers and one block
__global__ void __launch_bounds__(G_THREADS, 2)
moe_gmm_kernel(const __nv_bfloat16* __restrict__ x, int Mp, KmW w, ExpertStrides st,
               const int* __restrict__ tile_expert, const int* __restrict__ live,
               int layer, int E, __nv_bfloat16* __restrict__ out, int Nout) {
  const int mt = blockIdx.y;
  const int m0 = mt * BM, n0 = blockIdx.x * BN;
  if (live != nullptr && mt >= __ldg(live)) {
    for (int i = threadIdx.x; i < BM * BN; i += G_THREADS) {
      const int n = n0 + i % BN;
      if (n < Nout) out[(size_t)(m0 + i / BN) * Nout + n] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const long long slot = (long long)layer * E + __ldg(tile_expert + mt);
  KmW we = w;
  we.q = w.q + slot * st.s[0];
  we.d = w.d + slot * st.s[1];
  if (w.s8) we.s8 = w.s8 + slot * st.s[2];
  if (w.m8) we.m8 = w.m8 + slot * st.s[3];
  if (w.dmin) we.dmin = w.dmin + slot * st.s[4];
  if (w.bm) we.bm = w.bm + slot * st.s[5];
  qmm_tile(x, Mp, we, out, Nout, 1, m0, n0);
}

}  // namespace

extern "C" {

// F: xs (Mp, K) bf16 expert-sorted rows, tile_expert (Mp / 128,) int32,
// live (1,) int32 or null, weights (L?, E, rows, Npad) -> out (Mp, Nout) bf16.
int tpq_moe_gmm(const void* x, int Mp, int K, const unsigned long long* wp, const int* wi,
                const float* wf, const long long* strides, const void* tile_expert,
                const void* live, int layer, int E, void* out, int Nout, void* stream) {
  cudaGetLastError();
  KmW w = make_kmw(wp, wi, wf);
  if (Mp < BM || Mp % BM || E < 1 || layer < 0 || Nout > w.Npad || !qmm_tile_ok(w, K))
    return (int)cudaErrorInvalidValue;
  ExpertStrides st;
  for (int i = 0; i < 6; ++i) st.s[i] = strides[i];
  dim3 grid(w.Npad / BN, Mp / BM);
  moe_gmm_kernel<<<grid, G_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), Mp, w, st,
      reinterpret_cast<const int*>(tile_expert), reinterpret_cast<const int*>(live), layer,
      E, reinterpret_cast<__nv_bfloat16*>(out), Nout);
  return (int)cudaGetLastError();
}

}  // extern "C"
