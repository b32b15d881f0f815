// Fused dequant-matmul over K-major quantized weights: y = x @ dequant(W)^T.
//
// Kernel A of the two that replace the Pallas kernels of tpullm/ops/qmm.py:
//
// A. qmm_splitk_kernel  <- _build_qmm_splitk (qmm.py:181, pallas_call :226)
//    Decode GEMV, M <= 32 rows. Bound on this card: bytes. Every weight
//    byte is read once and feeds 2 M flops, far below the ~295 flop/byte
//    where the tensor cores would be the limit; what stands between the
//    kernel and the memory rate is the dequant's instructions (~5 a weight)
//    and the latency each warp waits out. Design:
//    - A block of 4 warps owns 256 neighbouring columns (64 a warp, 8 a
//      lane) and one K slab of whole scale groups. K is split so that the
//      grid has ~1000 blocks even for N = 4096; the f32 slabs are summed by
//      a second, deterministic pass (qmm_reduce), not by atomics, so two
//      identical calls give identical bits.
//    - The block's work item is the slab body of splitk_slab.cuh (shared
//      with kernel D): products on mma.sync m16n8k16 with the weights
//      dequantized straight into the A fragments by kmajor.cuh's byte
//      permute, x's slab staged once as B fragments, the slab's scale rows
//      by cp.async, one k step of loads ahead (16 or 32 bytes a lane,
//      streamed past L1 with 256-byte L2 fetches). Blocks are short (8-32
//      k16 steps) and latency-bound: registers are held to 85 at MT = 8 so
//      that an SM holds 6 blocks (24 warps). More loads ahead cost
//      registers, so blocks, and were slower (PERF.md, kernel A).
//    The affine bias is folded per element (the TPU kernel hoists it out
//    as group_sums(x) @ bias; equal up to float order).
//
// A's expert-skip variant, qmm_experts_kernel <- the lax.cond around each
//    expert's kernel-A calls in the JAX decode MoE (tpullm/models/llama.py:
//    447-454), which reads only the experts some row selected. A CUDA graph
//    cannot branch on the routing from the host, so the branch moves onto
//    the device: blockIdx.z is a slot of a fixed-size list of the selected
//    experts (ascending, padded with -1, built on the device), and a padded
//    slot's blocks exit at once. Each live slot runs A's work items on its
//    expert's weight in the (L, E) stack (expert 0's pointers plus the
//    expert's strides) over x's rows, shared by every slot (gate, up) or the
//    slot's own (down). One launch a projection whatever E is, bytes the
//    selected experts' only. A's split plan and reduce order are kept per
//    expert, so each slot's product has the bits of A's call on that expert.
//    Its second pass either writes each slot's product (qmm_experts_reduce)
//    or, for down, folds the slots into the MoE output in ascending expert
//    order, product times routing weight, each step rounded to the output
//    type as the all-expert loop rounds it (qmm_experts_combine): the loop's
//    bits, and no atomics.
//
// B. <- _build_qmm (qmm.py:239, pallas_call :294), the prefill GEMM for
//    M > 32, is qmm_prefill.cu (a warp-specialised wgmma kernel, with the
//    tpq_qmm entry point).
#include "splitk_slab.cuh"

using namespace tps;

namespace {

// kernel A's x: bf16 rows (M, K), staged as they are
struct RowsStager {
  XRows x;
  template <int MT, int P>
  __device__ __forceinline__ void run(uint2* xf, int M, int Kr, int r0, int nks) const {
    stage_x<MT, P>(xf, x, M, Kr, r0, nks);
  }
};

// One block a work item of the shared slab body (splitk_slab.cuh): the
// block's 256 columns over K slab blockIdx.y. Blocks an SM an instance must
// fit: at MT = 8, 6 (85 registers), and 7 (73) for the i8 kind without
// bias, which compiled to 72 before its body was shared and whose long-K
// rows (down, Q6_K) lose 9% at 6 (PERF.md, kernel D's findings).
template <int MT, int KIND, int MODE>
__global__ void __launch_bounds__(
    SK_THREADS, MT == 8 ? (KIND == KIND_I8 && MODE == MODE_OFF ? MIN_BLOCKS + 1 : MIN_BLOCKS) : 1)
qmm_splitk_kernel(const __nv_bfloat16* __restrict__ x, int M, KmW w,
                  float* __restrict__ part, int gps) {
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float lut[16];
  const RowsStager st{{reinterpret_cast<const uint16_t*>(x), w.K}};
  slab_item<MT, KIND, MODE, 1>(w, M, blockIdx.x * SK_COLS, blockIdx.y, gps, part, sm, lut, st);
}

// Byte strides between neighbouring experts of a stack, one per KmW array
// (0 where the type has none); the expert-skip launch's slot list and x.
struct ExpertStrides {
  long long q, d, s8, m8, dmin, bm;
};
struct Experts {
  long long xs;      // elements between two slots' x rows (0: x shared)
  ExpertStrides es;  // w's pointers are expert 0's
  const int* ids;    // (cap,) the experts of the slots, -1 past the last
  int cap, E;
};

template <class T>
__device__ __forceinline__ const T* advanced(const T* p, long long bytes) {
  return reinterpret_cast<const T*>(reinterpret_cast<const uint8_t*>(p) + bytes);
}

// One block a work item of slot blockIdx.z: A's item on expert ids[slot]
// (w is the kernel's own copy of the parameter, moved to that expert), its
// slabs stored to the slot's (nS, M, Npad) part.
template <int MT, int KIND, int MODE>
__global__ void __launch_bounds__(
    SK_THREADS, MT == 8 ? (KIND == KIND_I8 && MODE == MODE_OFF ? MIN_BLOCKS + 1 : MIN_BLOCKS) : 1)
qmm_experts_kernel(const __nv_bfloat16* __restrict__ x, int M, KmW w, Experts ex,
                   float* __restrict__ part, int nS, int gps) {
  const int slot = blockIdx.z;
  const long long e = __ldg(ex.ids + slot);
  if (e < 0 || e >= ex.E) return;
  extern __shared__ __align__(16) uint8_t sm[];
  __shared__ float lut[16];
  w.q = advanced(w.q, e * ex.es.q);
  w.d = advanced(w.d, e * ex.es.d);
  w.s8 = advanced(w.s8, e * ex.es.s8);
  w.m8 = advanced(w.m8, e * ex.es.m8);
  w.dmin = advanced(w.dmin, e * ex.es.dmin);
  w.bm = advanced(w.bm, e * ex.es.bm);
  const RowsStager st{{reinterpret_cast<const uint16_t*>(x + slot * ex.xs), w.K}};
  slab_item<MT, KIND, MODE, 1>(w, M, blockIdx.x * SK_COLS, blockIdx.y, gps,
                               part + (size_t)slot * nS * M * w.Npad, sm, lut, st);
}

__device__ __forceinline__ float rounded(float v, int to_bf16) {
  return to_bf16 ? bf16_round(v) : v;
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v, int out_bf16) {
  if (out_bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(out)[i] = v;
}

// Slot `slot`'s product at row m, column n: its slabs summed in slab order
// (qmm_reduce's order)
__device__ __forceinline__ float slot_sum(const float* __restrict__ part, int slot, int nS, int M,
                                          int N, int m, int n) {
  float acc = 0.f;
  for (int s = 0; s < nS; ++s) acc += part[(((size_t)slot * nS + s) * M + m) * N + n];
  return acc;
}

// out (cap, M, Nout): each live slot's product, 0 in a padded slot's rows
__global__ void qmm_experts_reduce(const float* __restrict__ part, const int* __restrict__ ids,
                                   int cap, int nS, int M, int N, int Nout, void* out,
                                   int out_bf16) {
  const size_t total = (size_t)cap * M * Nout;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % Nout), m = (int)(i / Nout % M), slot = (int)(i / Nout / M);
    store_out(out, i, ids[slot] >= 0 ? slot_sum(part, slot, nS, M, N, m, n) : 0.f, out_bf16);
  }
}

constexpr int CB_OUT = 32;  // outputs a combine block folds

// out (M, Nout), the MoE combine of the down projection: for each live slot
// in order (ascending experts), o = o + de * we, where de is the slot's
// product and we the row's routing weight of the slot's expert (wts at the
// j where top_i (M, used) names it, else 0), each value and step rounded to
// the output type, as the loop of models/llama.py:moe_ffn computes it. The
// block's threads form the slots' terms of its CB_OUT outputs in parallel
// (cap x CB_OUT floats of shared memory), then CB_OUT threads fold them.
__global__ void qmm_experts_combine(const float* __restrict__ part, const int* __restrict__ ids,
                                    int cap, int nS, int M, int N, int Nout, void* out,
                                    int out_bf16, const long long* __restrict__ top_i,
                                    const float* __restrict__ wts, int used) {
  extern __shared__ float terms[];  // [slot][output]
  const size_t total = (size_t)M * Nout, i0 = (size_t)blockIdx.x * CB_OUT;
  for (int k = threadIdx.x; k < cap * CB_OUT; k += blockDim.x) {
    const int slot = k / CB_OUT, o = k % CB_OUT;
    const size_t i = i0 + o;
    const int e = ids[slot];
    float t = 0.f;
    if (e >= 0 && i < total) {
      const int m = (int)(i / Nout), n = (int)(i % Nout);
      // a row may name the expert more than once (grovemoe's chunk ids):
      // its weights add, as the loop's (w * (top_i == e)).sum(-1) adds them
      float we = 0.f;
      for (int j = 0; j < used; ++j)
        if (top_i[(size_t)m * used + j] == e) we = __fadd_rn(we, wts[(size_t)m * used + j]);
      const float de = rounded(slot_sum(part, slot, nS, M, N, m, n), out_bf16);
      t = rounded(__fmul_rn(de, rounded(we, out_bf16)), out_bf16);
    }
    terms[k] = t;
  }
  __syncthreads();
  const size_t i = i0 + threadIdx.x;
  if (threadIdx.x >= CB_OUT || i >= total) return;
  float o = 0.f;
  for (int slot = 0; slot < cap && ids[slot] >= 0; ++slot)
    o = rounded(__fadd_rn(o, terms[slot * CB_OUT + threadIdx.x]), out_bf16);
  store_out(out, i, o, out_bf16);
}

__global__ void qmm_reduce(const float* __restrict__ part, int nS, int M, int N,
                           int Nout, void* out, int out_bf16) {
  const size_t total = (size_t)M * Nout;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / Nout), n = (int)(i % Nout);
    float acc = 0.f;
    for (int s = 0; s < nS; ++s) acc += part[((size_t)s * M + m) * N + n];
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(acc);
    else
      reinterpret_cast<float*>(out)[i] = acc;
  }
}

// A's first launch, or with ex its expert-skip variant's (cap slots of the
// same grid)
template <int MT, int KIND, int MODE>
int launch_splitk(const __nv_bfloat16* x, int M, const KmW& w, float* part,
                  int nS, int gps, const Experts* ex, cudaStream_t st) {
  const size_t smem = slab_smem(w, gps, MT, 1).total;
  static bool attr = false, attr_ex = false;
  if (ex) {
    if (!attr_ex) {
      cudaFuncSetAttribute(qmm_experts_kernel<MT, KIND, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
      attr_ex = true;
    }
    dim3 grid(w.Npad / SK_COLS, nS, ex->cap);
    qmm_experts_kernel<MT, KIND, MODE><<<grid, SK_THREADS, smem, st>>>(x, M, w, *ex, part, nS,
                                                                       gps);
    return 0;
  }
  if (!attr) {
    cudaFuncSetAttribute(qmm_splitk_kernel<MT, KIND, MODE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
    attr = true;
  }
  dim3 grid(w.Npad / SK_COLS, nS);
  qmm_splitk_kernel<MT, KIND, MODE><<<grid, SK_THREADS, smem, st>>>(x, M, w, part, gps);
  return 0;
}

template <int KIND, int MODE>
int splitk_mt(const __nv_bfloat16* x, int M, const KmW& w, float* part, int nS,
              int gps, const Experts* ex, cudaStream_t st) {
  if (M <= 8) return launch_splitk<8, KIND, MODE>(x, M, w, part, nS, gps, ex, st);
  if (M <= 16) return launch_splitk<16, KIND, MODE>(x, M, w, part, nS, gps, ex, st);
  return launch_splitk<32, KIND, MODE>(x, M, w, part, nS, gps, ex, st);
}

template <int KIND>
int splitk_mode(const __nv_bfloat16* x, int M, const KmW& w, float* part, int nS,
                int gps, const Experts* ex, cudaStream_t st) {
  const int mode = km_mode(w);
  if (mode == MODE_LUT) {
    if constexpr (KIND == KIND_U4)
      return splitk_mt<KIND, MODE_LUT>(x, M, w, part, nS, gps, ex, st);
    return (int)cudaErrorInvalidValue;  // no i8 kind has a LUT
  }
  if (mode == MODE_BIAS) return splitk_mt<KIND, MODE_BIAS>(x, M, w, part, nS, gps, ex, st);
  return splitk_mt<KIND, MODE_OFF>(x, M, w, part, nS, gps, ex, st);
}

// A's checks on its weight and rows
bool splitk_takes(const KmW& w, int M, int K) {
  const int kr = w.kind == KIND_U4 ? 8 : 16;  // packed rows of a k16 step
  return !(w.K != K || M < 1 || M > 32 || w.Npad % SK_COLS || w.gs % kr ||
           (w.gs & (w.gs - 1)) || (w.ds & (w.ds - 1)));
}

int splitk(const __nv_bfloat16* x, int M, const KmW& w, float* part, int nS, int gps,
           const Experts* ex, cudaStream_t st) {
  return w.kind == KIND_U4 ? splitk_mode<KIND_U4>(x, M, w, part, nS, gps, ex, st)
                           : splitk_mode<KIND_I8>(x, M, w, part, nS, gps, ex, st);
}

// the second passes' grid: a thread an output, at most 4096 blocks of 256
int grid_of(size_t total) {
  return (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
}

}  // namespace

extern "C" {

const char* tpq_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// A: x (M, K) bf16 -> partial slabs (nS, M, Npad) f32 -> out (M, Nout).
int tpq_qmm_splitk(const void* x, int M, int K, const unsigned long long* wp,
                   const int* wi, const float* wf, void* part, int nS, int gps,
                   void* out, int Nout, int out_bf16, void* stream) {
  cudaGetLastError();
  KmW w = make_kmw(wp, wi, wf);
  if (!splitk_takes(w, M, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* pb = reinterpret_cast<float*>(part);
  const int err =
      splitk(reinterpret_cast<const __nv_bfloat16*>(x), M, w, pb, nS, gps, nullptr, st);
  if (err) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  qmm_reduce<<<grid_of((size_t)M * Nout), 256, 0, st>>>(pb, nS, M, w.Npad, Nout, out, out_bf16);
  return (int)cudaGetLastError();
}

// A's expert-skip variant. x: (M, K) bf16 rows shared by every slot (xs 0)
// or (cap, M, K), xs = M * K; w: expert 0 of the stack's layer, es (6
// values) its expert strides in bytes; ids (cap,) int32 the slots' experts
// (< E, ascending, -1 past the last); part (cap, nS, M, Npad) f32. combine
// 0: out (cap, M, Nout), each slot's product; 1: out (M, Nout), the slots
// folded in order with the routing of top_i (M, used) int64 and wts (M,
// used) f32.
int tpq_qmm_experts(const void* x, long long xs, int M, int K, const unsigned long long* wp,
                    const int* wi, const float* wf, const long long* es, const void* ids,
                    int cap, int E, void* part, int nS, int gps, void* out, int Nout,
                    int out_bf16, const void* top_i, const void* wts, int used, int combine,
                    void* stream) {
  cudaGetLastError();
  KmW w = make_kmw(wp, wi, wf);
  const size_t smem_cb = (size_t)cap * CB_OUT * sizeof(float);
  if (!splitk_takes(w, M, K) || cap < 1 || cap > 65535 || E < 1 ||
      (combine && (used < 1 || !top_i || !wts || smem_cb > 48 * 1024)))
    return (int)cudaErrorInvalidValue;
  const Experts ex{xs, {es[0], es[1], es[2], es[3], es[4], es[5]},
                   reinterpret_cast<const int*>(ids), cap, E};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* pb = reinterpret_cast<float*>(part);
  const int err = splitk(reinterpret_cast<const __nv_bfloat16*>(x), M, w, pb, nS, gps, &ex, st);
  if (err) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (combine) {
    const int blocks = (int)(((size_t)M * Nout + CB_OUT - 1) / CB_OUT);
    qmm_experts_combine<<<blocks, 256, smem_cb, st>>>(
        pb, ex.ids, cap, nS, M, w.Npad, Nout, out, out_bf16,
        reinterpret_cast<const long long*>(top_i), reinterpret_cast<const float*>(wts), used);
  } else {
    qmm_experts_reduce<<<grid_of((size_t)cap * M * Nout), 256, 0, st>>>(
        pb, ex.ids, cap, nS, M, w.Npad, Nout, out, out_bf16);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
