// Store one layer's new K and V rows into the KV cache: the port's own kernel.
//
// No Pallas kernel does this work. The JAX package's forward quantizes each
// new row for the int8 cache (_kv_quant, tpullm/models/llama.py:132-138) and
// writes K, V and their scales with a dynamic_update_slice or a scatter
// (_store, llama.py:803-818, 896-910), and XLA fuses all of it into the
// step's program. Eager PyTorch launched each piece (the quantizer twice, a
// scatter per bank). This kernel does the whole store of a layer in one
// launch, K and V together, for the bf16, f32 and int8 caches, in the batch
// engine's layout and the server's (each batch row from its own first slot).
//
// What it computes: for every (batch row b, token t, kv head h), the row of
// K (and of V) goes to bank[b0 + b, h, slot[b] + t]; a slot at or past the
// cache's end is dropped, as the JAX scatter drops it. On an iSWA ring bank
// (ring > 0: the bank holds ring slots) the row goes to slot (slot[b] + t) %
// ring and none is dropped (_store(..., wrap=True), llama.py:894, 913). On the int8 cache the
// row is stored as scale = amax / 127, values clamp(rint(x / scale), -127,
// 127) (round half to even), with the scale in its f32 row-scale bank. The
// arithmetic is the JAX formula's bit for bit: a true IEEE division for the
// scale and for 1 / scale (the build has no fast-math flag), one product and
// rintf for each value.
//
// Bound on this card: bytes. Each value is read once (2 or 4 bytes) and
// written once (1-4 bytes); the amax, the scale and the rounding are a few
// operations a byte. The design is the simple one: one warp a row, its lanes
// over the row's elements (neighbouring lanes on neighbouring addresses), the
// amax a warp shuffle reduction, and the row read a second time for the
// quantized values (it sits in L1 by then). A decode step stores a few
// dozen rows a layer, so what matters there is one launch in place of ~37.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS_WARPS = 4;  // rows (one a warp) a block

struct KsArgs {
  const void* k;  // (B, T, Hkv, Dk) in the compute dtype, element strides below
  const void* v;  // (B, T, Hkv, Dv)
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  void* kb;  // this layer's K bank (B_cache, Hkv, S, Dk), contiguous
  void* vb;  // this layer's V bank (B_cache, Hkv, S, Dv)
  float* ks;  // int8 cache: its row scales (B_cache, Hkv, S)
  float* vs;
  const long long* slot;  // (B,): each batch row's first slot
  int B, T, Hkv, S, Dk, Dv, b0;
  int ring;  // > 0: a ring bank of S = ring slots, written at (slot + t) % ring
};

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename Bank>
__device__ __forceinline__ Bank from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Bank: __nv_bfloat16, float, or int8_t (the int8 cache with row scales)
template <typename In, typename Bank>
__global__ void __launch_bounds__(KS_WARPS * 32) kv_store_kernel(KsArgs a) {
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.B * a.T * a.Hkv;
  long long r = (long long)blockIdx.x * KS_WARPS + (threadIdx.x >> 5);
  if (r >= 2 * rows) return;
  const bool is_v = r >= rows;
  if (is_v) r -= rows;
  const int h = (int)(r % a.Hkv);
  const long long bt = r / a.Hkv;
  const int t = (int)(bt % a.T);
  const int b = (int)(bt / a.T);
  long long s = a.slot[b] + t;
  if (a.ring > 0) s %= a.ring;     // the ring wraps (slots are never negative)
  if (s < 0 || s >= a.S) return;  // past the cache's end: dropped
  const int D = is_v ? a.Dv : a.Dk;
  const In* src = reinterpret_cast<const In*>(is_v ? a.v : a.k) +
                  (is_v ? b * a.v_sb + t * a.v_st + h * a.v_sh
                        : b * a.k_sb + t * a.k_st + h * a.k_sh);
  const long long row = ((long long)(a.b0 + b) * a.Hkv + h) * a.S + s;
  Bank* dst = reinterpret_cast<Bank*>(is_v ? a.vb : a.kb) + row * D;
  if constexpr (sizeof(Bank) == 1) {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
#pragma unroll
    for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = amax / 127.0f;
    const float inv = scale > 0.f ? 1.0f / scale : 0.f;
    for (int d = lane; d < D; d += 32) {
      const float q = fminf(fmaxf(rintf(to_f(src[d]) * inv), -127.f), 127.f);
      dst[d] = (Bank)(int)q;
    }
    if (lane == 0) (is_v ? a.vs : a.ks)[row] = scale;
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = from_f<Bank>(to_f(src[d]));
  }
}

template <typename In, typename Bank>
int launch(const KsArgs& a, cudaStream_t st) {
  const long long rows = 2LL * a.B * a.T * a.Hkv;
  const long long blocks = (rows + KS_WARPS - 1) / KS_WARPS;
  kv_store_kernel<In, Bank><<<(unsigned)blocks, KS_WARPS * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_bank(const KsArgs& a, int bank, cudaStream_t st) {
  if (bank == 0) return launch<In, __nv_bfloat16>(a, st);
  if (bank == 1) return launch<In, float>(a, st);
  return launch<In, int8_t>(a, st);
}

}  // namespace

// in_f32: K/V rows are f32 (else bf16); bank: 0 bf16, 1 f32, 2 int8 with
// f32 row scales ks/vs; ring: 0, or the ring size S of an iSWA ring bank
extern "C" int tpq_kv_store(const void* k, const void* v, long long k_sb, long long k_st,
                            long long k_sh, long long v_sb, long long v_st, long long v_sh,
                            void* kb, void* vb, void* ks, void* vs, const void* slot, int B,
                            int T, int Hkv, int S, int Dk, int Dv, int b0, int in_f32,
                            int bank, int ring, void* stream) {
  cudaGetLastError();
  if (B < 1 || T < 1 || Hkv < 1 || S < 1 || Dk < 1 || Dv < 1 || b0 < 0 || bank < 0 ||
      bank > 2 || (bank == 2 && (!ks || !vs)) || ring < 0 || (ring > 0 && ring != S) ||
      2LL * B * T * Hkv > (long long)KS_WARPS * 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  KsArgs a;
  a.k = k; a.v = v;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.kb = kb; a.vb = vb;
  a.ks = reinterpret_cast<float*>(ks);
  a.vs = reinterpret_cast<float*>(vs);
  a.slot = reinterpret_cast<const long long*>(slot);
  a.B = B; a.T = T; a.Hkv = Hkv; a.S = S; a.Dk = Dk; a.Dv = Dv; a.b0 = b0;
  a.ring = ring;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return in_f32 ? launch_bank<float>(a, bank, st) : launch_bank<__nv_bfloat16>(a, bank, st);
}
