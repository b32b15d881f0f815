// One decode layer block in one cooperative kernel: wo dequant-matmul,
// residual, rmsnorm, fused gate/up, activation, down, residual, and (folded
// variant) the next layer's attention rmsnorm and fused QKV.
//
// Replaces the Pallas kernel tpullm/ops/layer_kernel.py:_build
// (layer_kernel.py:182, pallas_call :396), entered through ffn_block and
// ffn_block_qkv. On the TPU the kernel exists because switching programs
// costs 25-80 us; on this card the matching cost is one launch per matmul
// per layer plus the small elementwise launches between them.
//
// Bound on this card: bytes (M <= 16 rows, so every weight byte feeds at
// most 32 flops). Design: one persistent cooperative grid (as many blocks as
// can be resident, launched with cudaLaunchCooperativeKernel) walks the
// phases wo, gate/up, down and (folded) the next QKV, with one grid sync
// between two phases. Each phase is split-K, as kernel A is: the blocks
// walk the pool's (column tile, K slab) work items, tile-major, through
// kernel A's slab body (splitk_slab.cuh: mma.sync with the weights
// dequantized straight into the fragments), 128-column tiles with the two
// warps of a column group each taking half the slab's k steps. The slab
// plan (scale groups a slab, slabs a pool) is the wrapper's
// (ops/layer_kernel.py:layer_plan). An item stores its f32 partial sums;
// the last item of a tile to arrive (a per-tile arrival counter, the only
// atomic) sums the tile's slabs in slab order and runs the phase's
// epilogue: the residual and each tile's sums of squares (wo, down), the
// activation (gate/up: gate column n and up column nffp + n share one
// counter, so the block that reduces them holds both), the bf16 stores. So
// the sums are deterministic and no extra pass or sync reduces them. The
// rmsnorm scale is applied while the next phase stages x's slab (each block
// sums the per-tile squares in tile order for rstd). What crosses a sync
// (the f32 residual streams x2 and x_out, bf16 hmid, the sums of squares,
// the partials) lives in the scratch the wrapper allocates and is read
// back through L2 (ld.global.cg). Rounding points follow the TPU kernel:
// the residual stays f32, h2, hmid and the next layer's normed input are
// rounded to bf16. PERF.md (kernel D) has the measurements behind the
// choices.
#include <cooperative_groups.h>

#include "splitk_slab.cuh"

namespace cg = cooperative_groups;
using namespace tps;

namespace {

constexpr int LK = 2;               // warps along K in an item (splitk_slab.cuh WK)
constexpr int L_MIN_BLOCKS = 4;     // blocks an SM: caps registers at 128 (PERF.md, kernel D)
constexpr int TC = SK_COLS / LK;    // columns of a tile; ops/layer_kernel.py LAYER_TILE
constexpr int C4 = TC / 4;          // float4 column groups of a tile
constexpr int MAX_ROWS = 16;
constexpr int MAX_TILES = 1024;     // arrival counters; ops/layer_kernel.py N_COUNTERS

enum { ACT_SILU = 0, ACT_GELU = 1, ACT_SWIGLU_OAI = 2 };
enum { P_WO = 0, P_GU = 1, P_DN = 2, P_QK = 3 };

struct LayerArgs {
  KmW w[4];                  // wo, gateup, down, next layer's qkv
  int gps[4], nS[4];         // each pool's slab plan
  const __nv_bfloat16* att;  // (M, Hd)
  const __nv_bfloat16* res;  // (M, D)
  const float* ffn_norm;     // (D,)
  const float* attn_norm;    // next layer's (D,), folded only
  __nv_bfloat16* out;        // (M, D)
  __nv_bfloat16* qkv;        // (M, qk.Npad), folded only
  float *x2, *xo;            // (M, D) f32 residual streams
  float *ss1, *ss2;          // (D tiles, MAX_ROWS) sums of squares a tile
  __nv_bfloat16* hmid;       // (M, n_ff)
  float* part;               // the phase's slab partials (nS, M, Npad)
  int* cnt;                  // arrival counters, 0 at launch and at exit
  int M, D, Hd, n_ff, nffp, act, fold;
  float eps;
};

// x rows written earlier in this launch (hmid), read through L2
struct CGRow {
  const uint16_t* p;
  __device__ __forceinline__ CGRow operator+(int k) const { return {p + k}; }
  __device__ __forceinline__ uint32_t operator[](int k) const { return __ldcg(p + k); }
};
struct RowsCG {
  const uint16_t* x;
  int ld;
  __device__ __forceinline__ CGRow row(int m) const { return {x + (size_t)m * ld}; }
};

// bf16(x[m, k] * rstd[m] * wn[k]): the rmsnorm of an f32 residual stream
// written earlier in this launch
struct NormRow {
  const float* x;
  const float* wn;
  float r;
  __device__ __forceinline__ NormRow operator+(int k) const { return {x + k, wn + k, r}; }
  __device__ __forceinline__ uint32_t operator[](int k) const {
    return __bfloat16_as_ushort(__float2bfloat16_rn(__ldcg(x + k) * r * __ldg(wn + k)));
  }
};
struct NormRows {
  const float* x;
  const float* wn;
  const float* rstd;
  int ld;
  __device__ __forceinline__ NormRow row(int m) const {
    return {x + (size_t)m * ld, wn, rstd[m]};
  }
};

// Each phase's x: att as it is, h2 = norm(x2), hmid, norm(x_out)
struct LayerStager {
  int p;
  const uint16_t* rows;  // att or hmid
  const float* x;        // x2 or x_out
  const float* wn;       // ffn_norm or attn_norm
  const float* rstd;
  int ld;
  template <int MT, int P>
  __device__ __forceinline__ void run(uint2* xf, int M, int Kr, int r0, int nks) const {
    if (p == P_WO)
      stage_x<MT, P>(xf, XRows{rows, ld}, M, Kr, r0, nks);
    else if (p == P_DN)
      stage_x<MT, P>(xf, RowsCG{rows, ld}, M, Kr, r0, nks);
    else
      stage_x<MT, P>(xf, NormRows{x, wn, rstd, ld}, M, Kr, r0, nks);
  }
};

__device__ __forceinline__ float act_fn(int act, float g, float u) {
  if (act == ACT_SILU) return g / (1.f + expf(-g)) * u;
  if (act == ACT_GELU) {
    const float k = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * g * (1.f + tanhf(k * (g + 0.044715f * g * g * g))) * u;
  }
  g = fminf(g, 7.f);
  u = fminf(fmaxf(u, -7.f), 7.f);
  return g / (1.f + expf(-1.702f * g)) * (u + 1.f);
}

// The tile's sums over the nS slabs, in slab order, of the partials of the
// columns [n0, n0 + TC): the thread's float4 slots f = tid + 128 j (row
// f / C4, columns n0 + 4 (f % C4) ..), U slabs' loads in flight at once.
template <int J>
__device__ __forceinline__ void sum_slabs(const float* part, int nS, int M, int N, int n0,
                                          float4 (&acc)[J]) {
  constexpr int U = 8 / J;
  const int nf = M * C4;
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int s0 = 0; s0 < nS; s0 += U) {
    float4 v[U][J];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int f = threadIdx.x + j * SK_THREADS, s = s0 + u;
        v[u][j] = f < nf && s < nS
                      ? __ldcg(reinterpret_cast<const float4*>(
                            part + ((size_t)s * M + f / C4) * N + n0 + 4 * (f % C4)))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[j].x += v[u][j].x;
        acc[j].y += v[u][j].y;
        acc[j].z += v[u][j].z;
        acc[j].w += v[u][j].w;
      }
  }
}

// A row's sum over the tile of the squares each thread holds (the C4
// threads of a row are neighbouring lanes), in a fixed tree order, stored
// by the row's first lane.
__device__ __forceinline__ void tile_squares(float sq, int f, int M, float* ss) {
#pragma unroll
  for (int o = C4 / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const int m = f / C4;
  if (f % C4 == 0 && m < M) ss[m] = sq;
}

// The last arriving block of tile t (gate/up: of pair t) reduces its slabs
// and runs the phase's epilogue.
template <int J>
__device__ __forceinline__ void finish_tile(const LayerArgs& a, int p, int t, int nS, int N) {
  const int M = a.M, nf = M * C4;
  float4 acc[J];
  sum_slabs<J>(a.part, nS, M, N, t * TC, acc);
  if (p == P_GU) {
    float4 up[J];
    sum_slabs<J>(a.part, nS, M, N, a.nffp + t * TC, up);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = threadIdx.x + j * SK_THREADS;
      if (f >= nf) continue;
      const int m = f / C4, n = t * TC + 4 * (f % C4);
      const float g[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
      const float u[4] = {up[j].x, up[j].y, up[j].z, up[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < a.n_ff)
          a.hmid[(size_t)m * a.n_ff + n + e] = __float2bfloat16_rn(act_fn(a.act, g[e], u[e]));
    }
    return;
  }
  if (p == P_QK) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = threadIdx.x + j * SK_THREADS;
      if (f >= nf) continue;
      const int m = f / C4, n = t * TC + 4 * (f % C4);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(a.qkv + (size_t)m * N + n);
      o[0] = __floats2bfloat162_rn(acc[j].x, acc[j].y);
      o[1] = __floats2bfloat162_rn(acc[j].z, acc[j].w);
    }
    return;
  }
  // wo: x2 = resid + y; down: x_out = x2 + y (and the sums of squares for
  // the next phase's rmsnorm)
  const bool wo = p == P_WO;
  float* dst = wo ? a.x2 : (a.fold ? a.xo : nullptr);
  float* ss = (wo ? a.ss1 : a.ss2) + t * MAX_ROWS;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int f = threadIdx.x + j * SK_THREADS;
    const int m = f / C4, n = t * TC + 4 * (f % C4);
    const float y[4] = {acc[j].x, acc[j].y, acc[j].z, acc[j].w};
    float sq = 0.f;
    if (f < nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e >= a.D) continue;
        const size_t o = (size_t)m * a.D + n + e;
        const float v = (wo ? __bfloat162float(a.res[o]) : __ldcg(a.x2 + o)) + y[e];
        if (dst) dst[o] = v;
        if (!wo) a.out[o] = __float2bfloat16_rn(v);
        sq += v * v;
      }
    }
    if (wo || a.fold) tile_squares(sq, f, M, ss);
  }
}

// rstd[m] = rsqrt(mean over D of the squares) from the per-tile sums,
// summed in tile order by every block alike
template <int MT>
__device__ __forceinline__ void row_rstd(const LayerArgs& a, const float* ss, float* rstd) {
  const int nt = a.w[P_WO].Npad / TC;
  if (threadIdx.x < MT) {
    float s = 0.f;
    for (int t = 0; t < nt; ++t) s += __ldcg(ss + t * MAX_ROWS + threadIdx.x);
    rstd[threadIdx.x] = rsqrtf(s / (float)a.D + a.eps);
  }
}

// What a phase's items read, in shared memory: its pool, its x, its plan
struct Phase {
  KmW w;
  LayerStager st;
  int p, gps, nS;
};

// Phase p's state (constant indices into the kernel's parameters only: a
// run-time index would copy them to local memory)
__device__ __forceinline__ void pick(const LayerArgs& a, int p, const float* rstd, Phase& ph) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i == p) {
      ph.w = a.w[i];
      ph.gps = a.gps[i];
      ph.nS = a.nS[i];
    }
  ph.p = p;
  ph.st = LayerStager{p,
                      reinterpret_cast<const uint16_t*>(p == P_WO ? a.att : a.hmid),
                      p == P_GU ? a.x2 : a.xo,
                      p == P_GU ? a.ffn_norm : a.attn_norm,
                      rstd,
                      p == P_WO ? a.Hd : p == P_DN ? a.n_ff : a.D};
}

// The phase's (tile, slab) items, tile-major over the persistent grid, for
// one kind and dequant mode: each through the shared slab body, then its
// arrival; the tile's last block reduces it. One item loop a mode. Each
// item reads the phase's state from shared memory through a pointer the
// compiler cannot follow, so that the loop holds no more than the item
// index in registers across the body: the body keeps kernel A's register
// budget.
template <int MT, int KIND, int MODE>
__device__ __forceinline__ void phase_items(const LayerArgs& a, const Phase& phase, uint8_t* sm,
                                            float* lut, int* last) {
  const int items = phase.w.Npad / TC * phase.nS;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    __syncthreads();  // the previous item's shared memory
    const Phase* ph = &phase;
    asm volatile("" : "+l"(ph));
    slab_item<MT, KIND, MODE, LK>(ph->w, a.M, it / ph->nS * TC, it % ph->nS, ph->gps, a.part,
                                  sm, lut, ph->st);
    // The arrival: the block's partials are ordered before thread 0's
    // fence by the barrier (a fence is cumulative), so one thread fences,
    // counts, and fences again before the block reads the other slabs.
    __syncthreads();
    const int p = ph->p, nS = ph->nS, t = it / nS;
    const int ct = p == P_GU ? t % (a.nffp / TC) : t;
    if (threadIdx.x == 0) {
      __threadfence();
      *last = atomicAdd(a.cnt + ct, 1) == (p == P_GU ? 2 : 1) * nS - 1;
      __threadfence();
    }
    __syncthreads();
    if (!*last) continue;
    // the float4 slots a thread needs: M * C4 over the block's threads
    const int nf = a.M * C4;
    if (nf <= SK_THREADS) {
      finish_tile<1>(a, p, ct, nS, ph->w.Npad);
    } else if (MT == 8 || nf <= 2 * SK_THREADS) {
      finish_tile<2>(a, p, ct, nS, ph->w.Npad);
    } else {
      if constexpr (MT > 8) finish_tile<4>(a, p, ct, nS, ph->w.Npad);
    }
    if (threadIdx.x == 0) a.cnt[ct] = 0;  // ready for the next phase and launch
  }
}

template <int MT>
__device__ __forceinline__ void run_phase(const LayerArgs& a, const Phase& ph, uint8_t* sm,
                                          float* lut, int* last) {
  const int mode = km_mode(ph.w);
  if (ph.w.kind == KIND_U4) {
    if (mode == MODE_LUT)
      phase_items<MT, KIND_U4, MODE_LUT>(a, ph, sm, lut, last);
    else if (mode == MODE_BIAS)
      phase_items<MT, KIND_U4, MODE_BIAS>(a, ph, sm, lut, last);
    else
      phase_items<MT, KIND_U4, MODE_OFF>(a, ph, sm, lut, last);
  } else {
    if (mode == MODE_BIAS)
      phase_items<MT, KIND_I8, MODE_BIAS>(a, ph, sm, lut, last);
    else
      phase_items<MT, KIND_I8, MODE_OFF>(a, ph, sm, lut, last);
  }
}

template <int MT>
__global__ void __launch_bounds__(SK_THREADS, L_MIN_BLOCKS)
layer_kernel(const __grid_constant__ LayerArgs a) {  // read in place, never copied
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float lut[16];
  __shared__ float rstd[MT];
  __shared__ Phase ph;
  __shared__ int last;
  const int nph = a.fold ? 4 : 3;
  for (int p = 0; p < nph; ++p) {
    if (p) grid.sync();
    if (threadIdx.x == 0) pick(a, p, rstd, ph);
    if (p == P_GU) row_rstd<MT>(a, a.ss1, rstd);
    if (p == P_QK) row_rstd<MT>(a, a.ss2, rstd);
    __syncthreads();
    run_phase<MT>(a, ph, sm, lut, &last);
    __syncthreads();  // done with the phase's state before it is replaced
  }
}

template <int MT>
int launch(LayerArgs& a, cudaStream_t st) {
  static int sms = 0;
  static size_t last_smem = ~(size_t)0;
  static int last_blocks = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(layer_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         96 * 1024);
  }
  size_t smem = 0;
  for (int p = 0; p < (a.fold ? 4 : 3); ++p) {
    const size_t b = slab_smem(a.w[p], a.gps[p], MT, LK).total;
    if (b > smem) smem = b;
  }
  if (smem > 96 * 1024) return (int)cudaErrorInvalidValue;
  if (smem != last_smem) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_kernel<MT>, SK_THREADS, smem);
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    last_smem = smem;
    last_blocks = per_sm * sms;
  }
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((void*)layer_kernel<MT>, dim3(last_blocks),
                                          dim3(SK_THREADS), params, smem, st);
}

size_t align4(size_t n) { return (n + 3) / 4 * 4; }

}  // namespace

// w_ptrs/w_ints/w_floats hold 4 pools (wo, gateup, down, next-layer qkv) as
// built by tpullm_torch/ops/_cuda.py:km_descriptor; the qkv pool is read only
// when fold is set. plan holds each pool's (scale groups a slab, slabs).
// scratch (nscratch floats) is carved as ops/layer_kernel.py:scratch_floats
// says: x2, x_out (M * D each), the two sums of squares (D tiles * 16
// each), hmid (M * n_ff bf16), then the partials (the largest pool's nS * M
// * Npad); each part 16-byte aligned. counters: MAX_TILES ints, zero.
extern "C" int tpq_layer_kernel(const unsigned long long* wp, const int* wi,
                                const float* wf, const int* plan, const void* att,
                                const void* res, const void* ffn_norm, const void* attn_norm,
                                void* out, void* qkv, void* scratch, void* counters, int M,
                                int D, int Hd, int n_ff, int act, int fold, long long nscratch,
                                float eps, void* stream) {
  cudaGetLastError();
  if (M < 1 || M > MAX_ROWS || D % 4) return (int)cudaErrorInvalidValue;
  LayerArgs a;
  const int np = fold ? 4 : 3;
  for (int p = 0; p < 4; ++p) {
    const int q = p < np ? p : 0;  // the plain variant reads no qkv pool
    a.w[p] = make_kmw(wp + 6 * q, wi + 8 * q, wf + 17 * q);
    a.gps[p] = plan[2 * q];
    a.nS[p] = plan[2 * q + 1];
  }
  a.att = reinterpret_cast<const __nv_bfloat16*>(att);
  a.res = reinterpret_cast<const __nv_bfloat16*>(res);
  a.ffn_norm = reinterpret_cast<const float*>(ffn_norm);
  a.attn_norm = reinterpret_cast<const float*>(attn_norm);
  a.out = reinterpret_cast<__nv_bfloat16*>(out);
  a.qkv = reinterpret_cast<__nv_bfloat16*>(qkv);
  a.cnt = reinterpret_cast<int*>(counters);
  a.M = M; a.D = D; a.Hd = Hd; a.n_ff = n_ff;
  a.nffp = (n_ff + 255) / 256 * 256;
  a.act = act; a.fold = fold; a.eps = eps;
  const KmW &wo = a.w[P_WO], &gu = a.w[P_GU], &dn = a.w[P_DN], &qk = a.w[P_QK];
  if (wo.K != Hd || gu.K != D || dn.K != n_ff || gu.Npad != 2 * a.nffp || wo.Npad < D ||
      dn.Npad != wo.Npad || (fold && qk.K != D))
    return (int)cudaErrorInvalidValue;
  size_t part = 0;
  for (int p = 0; p < np; ++p) {
    const KmW& w = a.w[p];
    const int P = w.kind == KIND_U4 ? 2 : 1;
    const int G = w.K / P / w.gs;
    if (w.Npad % TC || w.Npad / TC > MAX_TILES || w.gs % (16 / P) || (w.gs & (w.gs - 1)) ||
        (w.ds & (w.ds - 1)) || a.gps[p] < 1 || a.nS[p] < 1 || a.gps[p] * a.nS[p] != G)
      return (int)cudaErrorInvalidValue;
    const size_t b = (size_t)a.nS[p] * M * w.Npad;
    if (b > part) part = b;
  }
  const size_t nt = wo.Npad / TC;
  float* sp = reinterpret_cast<float*>(scratch);
  a.x2 = sp; sp += align4((size_t)M * D);
  a.xo = sp; sp += align4((size_t)M * D);
  a.ss1 = sp; sp += nt * MAX_ROWS;
  a.ss2 = sp; sp += nt * MAX_ROWS;
  a.hmid = reinterpret_cast<__nv_bfloat16*>(sp); sp += align4(((size_t)M * n_ff + 1) / 2);
  a.part = sp; sp += part;
  if (sp - reinterpret_cast<float*>(scratch) > nscratch) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<8>(a, st);
  return launch<16>(a, st);
}
