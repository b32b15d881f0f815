// Fused dequant-matmul over K-major quantized weights: y = x @ dequant(W)^T.
//
// Kernel A of the two that replace the Pallas kernels of tpullm/ops/qmm.py:
//
// A. qmm_splitk_kernel  <- _build_qmm_splitk (qmm.py:181, pallas_call :226)
//    Decode GEMV, M <= 32 rows. Bound on this card: bytes. Every weight
//    byte is read once and used for M FMAs, far below the ~295 flop/byte
//    where the tensor cores would start to matter. Design: a block of 64
//    threads owns 256 neighbouring columns (4 per thread, one 32-bit load of
//    q per packed row, so a warp reads 128 contiguous bytes) and one K slab
//    of whole scale groups; the slab of x sits in shared memory as f32, the
//    M x 4 sums sit in registers, and each group's scales are loaded once.
//    A thread issues the loads of 8 (4 at M > 8) packed rows before it uses
//    any, to keep enough bytes in flight for HBM.
//    K is split so that the grid has ~1000 blocks even for N = 4096. The
//    f32 slabs are summed by a second, deterministic pass (qmm_reduce), not
//    by atomics, so two identical calls give identical bits. The affine
//    bias is folded per element (the TPU kernel hoists it out as
//    group_sums(x) @ bias; equal up to float order).
//
// B. <- _build_qmm (qmm.py:239, pallas_call :294), the prefill GEMM for
//    M > 32, is qmm_prefill.cu (a warp-specialised wgmma kernel, with the
//    tpq_qmm entry point).
#include "kmajor.cuh"

using namespace tpk;

namespace {

constexpr int SK_THREADS = 64;   // split-K block: 64 threads x 4 columns
constexpr int SK_COLS = 4 * SK_THREADS;

template <int MT, int KIND>
__global__ void __launch_bounds__(SK_THREADS)
qmm_splitk_kernel(const __nv_bfloat16* __restrict__ x, int M, KmW w,
                  float* __restrict__ part, int gps) {
  constexpr int P = KIND == KIND_U4 ? 2 : 1;
  constexpr int RB = MT >= 16 ? 4 : 8;  // packed rows loaded ahead
  extern __shared__ float xs[];  // [row in slab][plane][MT]
  const int K = w.K, N = w.Npad, gs = w.gs;
  const int Kr = K / P;     // packed rows
  const int G = Kr / gs;    // scale groups per plane
  const int s = blockIdx.y;
  const int g0 = s * gps;
  const int r0 = g0 * gs, nr = gps * gs;

  for (int i = threadIdx.x; i < nr * P * MT; i += SK_THREADS) {
    const int m = i % MT, j = (i / MT) % P, r = i / (MT * P);
    float v = 0.f;
    if (m < M) v = __bfloat162float(x[(size_t)m * K + (size_t)j * Kr + r0 + r]);
    xs[i] = v;
  }
  __syncthreads();

  const int n = blockIdx.x * SK_COLS + threadIdx.x * 4;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int gi = 0; gi < gps; ++gi) {
    const int g = g0 + gi;
    float sc[P][4], bi[P][4];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) km_group(w, g + j * G, n + c, sc[j][c], bi[j][c]);
    // RB packed rows' loads in flight before any is used (gs % 8 == 0)
    for (int rr = 0; rr < gs; rr += RB) {
      uint32_t qv[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i)
        qv[i] = __ldg(reinterpret_cast<const uint32_t*>(w.q + (size_t)(g * gs + rr + i) * N + n));
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float* xr = xs + (size_t)(g * gs + rr + i - r0) * P * MT;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t b = (qv[i] >> (8 * c)) & 0xFFu;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int u = KIND == KIND_U4 ? (int)((b >> (4 * j)) & 15u) : (int)(int8_t)b;
            const float wv = km_weight(w, u, sc[j][c], bi[j][c]);
#pragma unroll
            for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xr[j * MT + m], wv, acc[m][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    float4 v = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    *reinterpret_cast<float4*>(part + ((size_t)s * M + m) * N + n) = v;
  }
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

template <int MT, int KIND>
int launch_splitk(const __nv_bfloat16* x, int M, const KmW& w, float* part,
                  int nS, int gps, cudaStream_t st) {
  constexpr int P = KIND == KIND_U4 ? 2 : 1;
  const size_t smem = (size_t)gps * w.gs * P * MT * sizeof(float);
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(qmm_splitk_kernel<MT, KIND>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
    attr = true;
  }
  dim3 grid(w.Npad / SK_COLS, nS);
  qmm_splitk_kernel<MT, KIND><<<grid, SK_THREADS, smem, st>>>(x, M, w, part, gps);
  return 0;
}

template <int KIND>
int splitk_mt(const __nv_bfloat16* x, int M, const KmW& w, float* part, int nS,
              int gps, cudaStream_t st) {
  if (M <= 4) return launch_splitk<4, KIND>(x, M, w, part, nS, gps, st);
  if (M <= 8) return launch_splitk<8, KIND>(x, M, w, part, nS, gps, st);
  if (M <= 16) return launch_splitk<16, KIND>(x, M, w, part, nS, gps, st);
  return launch_splitk<32, KIND>(x, M, w, part, nS, gps, st);
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
  if (w.K != K || M < 1 || M > 32 || w.Npad % SK_COLS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  float* pb = reinterpret_cast<float*>(part);
  if (w.kind == KIND_U4)
    splitk_mt<KIND_U4>(xb, M, w, pb, nS, gps, st);
  else
    splitk_mt<KIND_I8>(xb, M, w, pb, nS, gps, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * Nout;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  qmm_reduce<<<blocks, 256, 0, st>>>(pb, nS, M, w.Npad, Nout, out, out_bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
