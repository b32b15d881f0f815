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

template <int MT, int KIND, int MODE>
int launch_splitk(const __nv_bfloat16* x, int M, const KmW& w, float* part,
                  int nS, int gps, cudaStream_t st) {
  const size_t smem = slab_smem(w, gps, MT, 1).total;
  static bool attr = false;
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
              int gps, cudaStream_t st) {
  if (M <= 8) return launch_splitk<8, KIND, MODE>(x, M, w, part, nS, gps, st);
  if (M <= 16) return launch_splitk<16, KIND, MODE>(x, M, w, part, nS, gps, st);
  return launch_splitk<32, KIND, MODE>(x, M, w, part, nS, gps, st);
}

template <int KIND>
int splitk_mode(const __nv_bfloat16* x, int M, const KmW& w, float* part, int nS,
                int gps, cudaStream_t st) {
  const int mode = km_mode(w);
  if (mode == MODE_LUT) {
    if constexpr (KIND == KIND_U4) return splitk_mt<KIND, MODE_LUT>(x, M, w, part, nS, gps, st);
    return (int)cudaErrorInvalidValue;  // no i8 kind has a LUT
  }
  if (mode == MODE_BIAS) return splitk_mt<KIND, MODE_BIAS>(x, M, w, part, nS, gps, st);
  return splitk_mt<KIND, MODE_OFF>(x, M, w, part, nS, gps, st);
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
  const int kr = w.kind == KIND_U4 ? 8 : 16;  // packed rows of a k16 step
  if (w.K != K || M < 1 || M > 32 || w.Npad % SK_COLS || w.gs % kr || (w.gs & (w.gs - 1)) ||
      (w.ds & (w.ds - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  float* pb = reinterpret_cast<float*>(part);
  const int err = w.kind == KIND_U4 ? splitk_mode<KIND_U4>(xb, M, w, pb, nS, gps, st)
                                    : splitk_mode<KIND_I8>(xb, M, w, pb, nS, gps, st);
  if (err) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * Nout;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  qmm_reduce<<<blocks, 256, 0, st>>>(pb, nS, M, w.Npad, Nout, out, out_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
