// K-major weight descriptor and the dequant routine shared by the qmm
// kernels (qmm.cu) and the decode layer kernel (layer_kernel.cu).
//
// Counterpart of _plane_tile (tpullm/ops/qmm.py:91-125). The layout is
// tpullm_torch/quant/kmajor.py's: q is (K/2, Npad) u8 half-split nibble
// planes ("u4": element k < K/2 is the lo nibble of row k, element k >= K/2
// the hi nibble of row k - K/2) or (K, Npad) i8 ("i8"); d is one f32 row per
// ds elements; s8 / m8 / bm one row per gs elements. N is the contiguous
// axis of every array, so neighbouring threads take neighbouring columns.
//
//   W[k, n] = val * scale + bias   (rounded f32 steps, no FMA contraction,
//                                   so the dequantized value is bit-exact
//                                   with dequant_kmajor_torch)
//   val   = lut[u] or u + off
//   scale = s8 * d (superblock kinds) or d
//   bias  = -(m8 * dmin) ("i8d"), bm ("f32") or none
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpk {

enum { KIND_U4 = 0, KIND_I8 = 1 };
enum { BIAS_NONE = 0, BIAS_F32 = 1, BIAS_I8D = 2 };

struct KmW {
  const uint8_t* q;
  const float* d;
  const int8_t* s8;
  const int8_t* m8;
  const float* dmin;
  const float* bm;
  int Npad, K, ds, kind, gs, sb, bias, has_lut;
  float off;
  float lut[16];
};

// The flat arrays built by tpullm_torch/ops/_cuda.py:km_descriptor.
inline KmW make_kmw(const unsigned long long* p, const int* iv, const float* fv) {
  KmW w;
  w.q = reinterpret_cast<const uint8_t*>(p[0]);
  w.d = reinterpret_cast<const float*>(p[1]);
  w.s8 = reinterpret_cast<const int8_t*>(p[2]);
  w.m8 = reinterpret_cast<const int8_t*>(p[3]);
  w.dmin = reinterpret_cast<const float*>(p[4]);
  w.bm = reinterpret_cast<const float*>(p[5]);
  w.Npad = iv[0];
  w.K = iv[1];
  w.ds = iv[2];
  w.kind = iv[3];
  w.gs = iv[4];
  w.sb = iv[5];
  w.bias = iv[6];
  w.has_lut = iv[7];
  w.off = fv[0];
  for (int i = 0; i < 16; ++i) w.lut[i] = fv[1 + i];
  return w;
}

// Scale and bias of logical scale group g (elements [g*gs, (g+1)*gs)) at
// column n.
__device__ __forceinline__ void km_group(const KmW& w, int g, int n, float& sc,
                                         float& bi) {
  const size_t N = (size_t)w.Npad;
  const size_t drow = (size_t)(g * w.gs) / w.ds;
  const float d = __ldg(w.d + drow * N + n);
  sc = w.sb ? __fmul_rn((float)__ldg(w.s8 + (size_t)g * N + n), d) : d;
  bi = 0.f;
  if (w.bias == BIAS_I8D)
    bi = -__fmul_rn((float)__ldg(w.m8 + (size_t)g * N + n),
                    __ldg(w.dmin + drow * N + n));
  else if (w.bias == BIAS_F32)
    bi = __ldg(w.bm + (size_t)g * N + n);
}

// Stored integer (nibble index for u4, signed value for i8) -> weight,
// rounded to bf16 as the TPU kernel's dequantized tile is.
__device__ __forceinline__ float km_weight(const KmW& w, int u, float sc, float bi) {
  const float val = w.has_lut ? w.lut[u & 15] : __fadd_rn((float)u, w.off);
  float x = __fmul_rn(val, sc);
  if (w.bias != BIAS_NONE) x = __fadd_rn(x, bi);
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The dequant's three forms, as compile-time modes of the GEMM kernels (A, B
// and F): val from the LUT, or u + off with a bias added after the scale, or
// u + off alone.
enum { MODE_OFF = 0, MODE_BIAS = 1, MODE_LUT = 2 };

__host__ __device__ inline int km_mode(const KmW& w) {
  return w.has_lut ? MODE_LUT : (w.bias != BIAS_NONE ? MODE_BIAS : MODE_OFF);
}

// The stored integers of a q word as one byte each: u4 plane `plane`'s
// nibbles, or the i8 values xor 0x80 (so that each byte is unsigned).
template <int KIND>
__device__ __forceinline__ uint32_t to_bytes(uint32_t word, int plane) {
  return KIND == KIND_U4 ? (word >> (4 * plane)) & 0x0F0F0F0Fu : word ^ 0x80808080u;
}

// The one exact add after the byte-permute int-to-float of km_val: -2^23
// (-2^23 - 128 for i8, whose bytes hold value ^ 0x80) and the kind's offset.
template <int KIND>
__device__ __forceinline__ float km_offc(float off) {
  return __fadd_rn(off, KIND == KIND_U4 ? -8388608.f : -8388736.f);
}

// Byte c of a to_bytes word -> val, exactly: 0x4B0000bb is the float 2^23 +
// bb, and offc takes the 2^23 back off with the offset (or val = lut[u]).
// The exponent bits 0x4B000000 are read off offc (whose magnitude lies in
// [2^23, 2^24)) at run time: a constant there would take the permute's one
// immediate slot, and the compiler then moves the byte selector into a
// register before every permute.
template <int MODE>
__device__ __forceinline__ float km_val(uint32_t bytes, int c, float offc, const float* lut) {
  if (MODE == MODE_LUT) return lut[(bytes >> (8 * c)) & 15u];
  const uint32_t two23 = __float_as_uint(offc) & 0x7F800000u;
  return __fadd_rn(__int_as_float(__byte_perm(bytes, two23, 0x7440u | c)), offc);
}

// val -> the weight before its rounding to bf16: val * scale, then + bias,
// in rounded f32 steps (no FMA contraction), as dequant_kmajor_torch does.
template <int MODE>
__device__ __forceinline__ float km_dq(float val, float sc, float bi) {
  const float x = __fmul_rn(val, sc);
  return MODE == MODE_BIAS ? __fadd_rn(x, bi) : x;
}

// A signed byte c of a word -> float, exactly (the scales' s8 and m8 rows).
__device__ __forceinline__ float i8_to_f32(uint32_t word, int c) {
  return km_val<MODE_OFF>(to_bytes<KIND_I8>(word, 0), c, -8388736.f, nullptr);
}

}  // namespace tpk
