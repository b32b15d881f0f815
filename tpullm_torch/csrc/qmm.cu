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
//    - The products run on the tensor cores, mma.sync m16n8k16 (bf16 in,
//      f32 sums): the dequantized weights are the A operand (16 columns x
//      16 k), x the B operand (16 k x 8 batch rows; M <= 8, 16, 32 take 1,
//      2, 4 n8 tiles). The order of k and of columns inside a fragment is
//      free as long as x's fragment and the store follow it, so each lane
//      fills its A fragment straight from the 8-byte loads of its own 8
//      columns: for u4 a byte's two nibble planes (k = r and r + K/2) are
//      one k pair, for i8 two packed rows are; of a lane's 8 columns, two
//      are rows g and g + 8 of each of 4 products. No weight passes through
//      shared memory.
//    - x's slab is staged once in shared memory as those B fragments (bf16
//      pairs in the same k order), read as one 8-byte load a lane.
//    - A weight costs a byte permute and an exact add (int to float), a
//      multiply by the scale, an add of the bias (affine kinds only), half
//      a bf16x2 pack, and no branch: the kernel is templated on the kind
//      and the dequant mode (kmajor.cuh, shared with kernel B), bit-exact
//      with dequant_kmajor_torch.
//    - Blocks are short (8-32 k16 steps), so nothing waits once the loop
//      runs: the slab's raw scale rows come into shared memory by cp.async
//      beside the first weight loads, and each group's scales are computed
//      from there; a lane issues the next k step's loads (16 or 32 bytes,
//      streamed past L1 with 256-byte L2 fetches) before it dequantizes the
//      current one's. Warps hide the latency: registers are held to 85 at
//      MT = 8 so that an SM holds 6 blocks (24 warps). More loads ahead
//      cost registers, so blocks, and were slower (PERF.md, kernel A).
//    The affine bias is folded per element (the TPU kernel hoists it out
//    as group_sums(x) @ bias; equal up to float order).
//
// B. <- _build_qmm (qmm.py:239, pallas_call :294), the prefill GEMM for
//    M > 32, is qmm_prefill.cu (a warp-specialised wgmma kernel, with the
//    tpq_qmm entry point).
#include "hopper.cuh"
#include "kmajor.cuh"

using namespace tph;
using namespace tpk;

namespace {

constexpr int SK_WARPS = 4;             // split-K block: 4 warps x 64 columns
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_COLS = 64 * SK_WARPS;  // ops/qmm.py SPLITK_COLS
constexpr int STAGE = 4;                // staging entries a thread loads at once
constexpr int MIN_BLOCKS = 6;           // blocks an SM holds at MT = 8: caps registers at 85

// 8 bytes of q (a lane's 8 columns of one packed row), streamed: no L1
// allocation, and L2 fetches the 256-byte line the block's warps share
__device__ __forceinline__ uint2 ld_q(const uint8_t* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];"
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
// block's SK_COLS columns from n0, copied to dst (rows packed) by cp16
template <int EB>
__device__ __forceinline__ void stage_rows(void* dst, const void* base, size_t row0, int rows,
                                           int N, int n0) {
  constexpr int CH = SK_COLS * EB / 16;  // 16-byte chunks a row
  const uint8_t* src = reinterpret_cast<const uint8_t*>(base) + (row0 * N + n0) * EB;
  for (int i = threadIdx.x; i < rows * CH; i += SK_THREADS)
    cp16(reinterpret_cast<uint8_t*>(dst) + i * 16, src + (size_t)(i / CH) * N * EB + i % CH * 16);
}

// Byte offsets of a block's shared memory: x's B fragments, then the raw
// scale rows of its slab, plane by plane: d rows (nd of them a plane; a
// slab of whole groups may straddle d rows), dmin rows (i8d) or bm rows
// (f32, one a group), s8 rows and m8 rows (one a group).
struct SlabSmem {
  int nd, d, b, s8, m8, total;
};

__host__ __device__ inline SlabSmem slab_smem(const KmW& w, int gps, int MT) {
  const int P = w.kind == KIND_U4 ? 2 : 1, nr = gps * w.gs;
  SlabSmem o;
  o.nd = (nr + w.ds - 1) / w.ds + 1;
  o.d = nr * P * MT * 2;
  o.b = o.d + P * o.nd * SK_COLS * 4;
  o.s8 = o.b + (w.bias == BIAS_I8D ? P * o.nd : w.bias == BIAS_F32 ? P * gps : 0) * SK_COLS * 4;
  o.m8 = o.s8 + (w.sb ? P * gps * SK_COLS : 0);
  o.total = o.m8 + (w.bias == BIAS_I8D ? P * gps * SK_COLS : 0);
  return o;
}

// Scales and biases of the slab's group gl, plane p, at the lane's 8
// columns [nl, nl + 8) of the block, from the staged rows; dl is the
// group's d row in the slab's copy. The arithmetic is km_group's.
template <int MODE>
__device__ __forceinline__ void group_scales(const KmW& w, const uint8_t* sm, const SlabSmem& o,
                                             int gps, int gl, int p, int dl, int nl,
                                             float (&sc)[8], float (&bi)[8]) {
  const int drow = (p * o.nd + dl) * SK_COLS + nl, grow = (p * gps + gl) * SK_COLS + nl;
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

// Lane (gq = lane / 4, tq = lane % 4) of a warp, k step ks of the slab:
// the A fragment of product i holds columns n + 2i (row gq) and n + 2i + 1
// (row gq + 8); its k pair 0 (logical k 2tq, 2tq + 1) and pair 1 (2tq + 8,
// 2tq + 9) are, for u4, the two nibble planes of packed rows tq and tq + 4
// of the step, for i8 packed rows (tq, tq + 4) and (tq + 8, tq + 12). x's B
// fragment follows the same k order, and the C fragment gives column n + 2i
// (c0, c1) and n + 2i + 1 (c2, c3) at batch rows 2tq and 2tq + 1.
template <int MT, int KIND, int MODE>
__global__ void __launch_bounds__(SK_THREADS, MT == 8 ? MIN_BLOCKS : 1)
qmm_splitk_kernel(const __nv_bfloat16* __restrict__ x, int M, KmW w,
                  float* __restrict__ part, int gps) {
  constexpr int P = KIND == KIND_U4 ? 2 : 1;
  constexpr int NT = MT / 8;           // n8 tiles of batch rows
  constexpr int KR = 16 / P;           // packed rows of a k16 step
  constexpr int NR = KR / 4;           // of them a lane's: rows tq + 4j
  extern __shared__ __align__(16) uint8_t sm[];
  uint2* xf = reinterpret_cast<uint2*>(sm);  // x's B fragments: [k step][n8 tile][lane]
  __shared__ float lut[16];
  const int K = w.K, N = w.Npad, gs = w.gs;
  const int Kr = K / P, G = Kr / gs;
  const int s = blockIdx.y, g0 = s * gps, r0 = g0 * gs;
  const int nks = gps * gs / KR, kpg = gs / KR;  // k steps in the slab, in a group
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int n0 = blockIdx.x * SK_COLS, nl = threadIdx.x / 32 * 64 + gq * 8;
  const int lds = 31 - __clz(w.ds);
  const size_t step = (size_t)KR * N;  // bytes of q between k steps
  const uint8_t* qn = w.q + (size_t)(r0 + tq) * N + n0 + nl;

  uint2 buf[NR];  // the first k step's loads go out before anything else
#pragma unroll
  for (int j = 0; j < NR; ++j) buf[j] = ld_q(qn + (size_t)4 * j * N);

  // The slab's raw scale rows by cp.async, in flight beside those loads
  const SlabSmem o = slab_smem(w, gps, MT);
  const int dlo = r0 >> lds, nd = ((r0 + gps * gs - 1) >> lds) - dlo + 1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const size_t dp = (size_t)((p * Kr) >> lds) + dlo, gp = (size_t)p * G + g0;
    stage_rows<4>(sm + o.d + p * o.nd * SK_COLS * 4, w.d, dp, nd, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_I8D)
      stage_rows<4>(sm + o.b + p * o.nd * SK_COLS * 4, w.dmin, dp, nd, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_F32)
      stage_rows<4>(sm + o.b + p * gps * SK_COLS * 4, w.bm, gp, gps, N, n0);
    if (w.sb) stage_rows<1>(sm + o.s8 + p * gps * SK_COLS, w.s8, gp, gps, N, n0);
    if (MODE == MODE_BIAS && w.bias == BIAS_I8D)
      stage_rows<1>(sm + o.m8 + p * gps * SK_COLS, w.m8, gp, gps, N, n0);
  }

  // x's slab as B fragments, STAGE entries a thread at a time so that their
  // loads are in flight together
  if (MODE == MODE_LUT && threadIdx.x < 16) lut[threadIdx.x] = w.lut[threadIdx.x];
  const uint16_t* xh = reinterpret_cast<const uint16_t*>(x);
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
        const uint16_t* xr = xh + (size_t)m * K + r0 + ks * KR + l % 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = P == 2 ? xr[(j / 2) * 4 + (j % 2) * Kr] : xr[4 * j];
      }
      e[u] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u)
      if (i0 + u * SK_THREADS < nx) xf[i0 + u * SK_THREADS] = e[u];
  }
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
  int gl = -1;  // the slab's scale group of the current k step
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
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
    if (ks + 1 < nks) {  // the next k step's loads, in flight while this one computes
      qn += step;
#pragma unroll
      for (int j = 0; j < NR; ++j) buf[j] = ld_q(qn + (size_t)4 * j * N);
    }
    if ((ks & (kpg - 1)) == 0) {  // a new scale group
      ++gl;
      const int dl = ((r0 + gl * gs) >> lds) - dlo;
#pragma unroll
      for (int p = 0; p < P; ++p) group_scales<MODE>(w, sm, o, gps, gl, p, dl, nl, sc[p], bi[p]);
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
  const size_t smem = slab_smem(w, gps, MT).total;
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
