// Decode attention over the head-major KV cache: kernel E.
//
// Replaces the Pallas kernel tpullm/ops/flash_decode.py:_build
// (flash_decode.py:41, pallas_call :183): T <= 8 query tokens per batch row
// against K/V (B, Hkv, S, D), bf16 or int8 with f32 row scales, slot mask
// valid_from <= kv_slot <= q_slot, optional sliding window (plain or
// chunked) on the positions kv_slot - valid_from, logit softcap, and
// per-head sink logits that join the softmax denominator as a value-less
// key. With int8 K/V the K scale folds into the scores and the V scale into
// the probabilities, which are rounded to bf16 before the PV product.
//
// Bound on this card: bytes (each visible K/V row, plus its two f32 scales
// when int8, is read once; the score and PV work is 4*D flops per query and
// key, far below the card's operations per byte). Design: one block per
// (split of E_CH slots, kv head, batch row). The block's G*T query rows
// (every query head of that kv head, every token) share each K/V tile it
// stages in shared memory, so GQA costs no reread. A block reads only the
// slots in [max(split start, valid_from, window start), min(split end,
// newest q_slot + 1)): tiles past a row's newest slot (or before its window)
// are never read, and a split with no such slot exits at once. Each thread
// issues all of its 16-byte loads of a tile before it stores any, so a
// tile's loads are in flight together. Within the block an online softmax
// runs over 64-slot tiles (scores one thread per (row, slot), softmax one
// warp per row, PV one thread per output column). Each split leaves (m, l,
// acc) per row; a second pass, one block per (row, kv head, batch row),
// reduces the splits' (m, l) in a fixed tree order, then sums the weighted
// acc of the splits that saw a key, adds the sink and normalizes, so two
// calls give identical bits. Masked scores use -1e30, and a masked key
// contributes exactly 0: a row with no visible key outputs 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int E_TS = 64;        // slots per tile
constexpr int E_CH = 128;       // slots per split (one block)
constexpr int E_THREADS = 128;
constexpr int E_RMAX = 64;      // query rows (G * T) per kv head
constexpr float E_NEG = -1e30f;

struct FdArgs {
  const __nv_bfloat16* q;  // (B, T, H, D) contiguous
  const unsigned char* k;  // (B, Hkv, S, D) strided, bf16 or int8
  const unsigned char* v;
  const float* ks;         // (B, Hkv, S) row scales, slot stride 1 (int8 only)
  const float* vs;
  const float* sinks;      // (H,) or null
  const int* qslots;       // (B, T)
  const int* qpos;         // (B, T)
  const int* valid_from;   // (B,)
  float* part_ml;          // (B, Hkv, NS, R, 2)
  float* part_acc;         // (B, Hkv, NS, R, D)
  __nv_bfloat16* o;        // (B, T, H, D)
  int B, T, H, Hkv, S, NS;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh;
  float scale, softcap;
  int window, chunked, has_sinks;
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// words of one K row in shared memory: odd, so the threads of a warp that
// read 32 different rows at one column hit 32 different banks
template <int D, bool Q8>
__host__ __device__ constexpr int k_words() { return D * (Q8 ? 1 : 2) / 4 + 1; }

// byte offset of the K tile and of the V tile in shared memory, for R rows
template <int D, bool Q8>
__host__ __device__ size_t kt_offset(int R) {
  return align16(((size_t)2 * R * D + (size_t)R * E_TS + 3 * R + 2 * E_TS) * 4 + (size_t)2 * R * 4);
}

template <int D, bool Q8>
__host__ __device__ size_t vt_offset(int R) {
  return align16(kt_offset<D, Q8>(R) + (size_t)E_TS * k_words<D, Q8>() * 4);
}

template <int D, bool Q8>
__host__ __device__ size_t smem_bytes(int R) {
  return vt_offset<D, Q8>(R) + (size_t)E_TS * D * (Q8 ? 1 : 2);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return (float)(int8_t)((w >> (8 * i)) & 0xffu);
}

template <int D, bool Q8>
__global__ void __launch_bounds__(E_THREADS) flash_decode_kernel(FdArgs a) {
  constexpr int ESZ = Q8 ? 1 : 2;
  constexpr int KW = k_words<D, Q8>();
  constexpr int VEC = D * ESZ / 16;  // 16-byte pieces of one K or V row
  extern __shared__ __align__(16) unsigned char sm[];
  const int T = a.T, G = a.H / a.Hkv, R = G * T;
  float* qs = reinterpret_cast<float*>(sm);  // (R, D) query rows, f32
  float* acc = qs + R * D;                   // (R, D) running PV sums
  float* sc = acc + R * D;                   // (R, E_TS) scores, then p
  float* m_s = sc + R * E_TS;
  float* l_s = m_s + R;
  float* al_s = l_s + R;
  float* ksc = al_s + R;                     // (E_TS) this tile's K scales
  float* vsc = ksc + E_TS;
  int* qslot_s = reinterpret_cast<int*>(vsc + E_TS);
  int* qpos_s = qslot_s + R;
  uint32_t* kt = reinterpret_cast<uint32_t*>(sm + kt_offset<D, Q8>(R));  // (E_TS, KW)
  unsigned char* vt = sm + vt_offset<D, Q8>(R);                          // (E_TS, D)

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // query row r = g * T + t is token t of query head hk * G + g
  for (int r = tid; r < R; r += E_THREADS) {
    qslot_s[r] = a.qslots[b * T + r % T];
    qpos_s[r] = a.qpos[b * T + r % T];
    m_s[r] = E_NEG;
    l_s[r] = 0.f;
  }
  __syncthreads();
  int newest = qslot_s[0], minpos = qpos_s[0];
  for (int t = 1; t < T; ++t) {
    newest = max(newest, qslot_s[t]);
    minpos = min(minpos, qpos_s[t]);
  }
  const int vf = a.valid_from[b];
  int lo = max(sp * E_CH, vf);
  if (a.window > 0) {
    const int wlo = a.chunked ? floordiv(minpos, a.window) * a.window : minpos - a.window + 1;
    lo = max(lo, vf + wlo);
  }
  const int hi = min(min((sp + 1) * E_CH, newest + 1), a.S);
  const size_t prow = ((size_t)(b * a.Hkv + hk) * a.NS + sp) * R;
  if (hi <= lo) {  // nothing this split may read: an empty partial
    for (int r = tid; r < R; r += E_THREADS) {
      a.part_ml[2 * (prow + r)] = E_NEG;
      a.part_ml[2 * (prow + r) + 1] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* qb = a.q + (size_t)b * T * a.H * D;
  for (int i = tid; i < R * D; i += E_THREADS) {
    const int r = i / D, d = i % D;
    qs[i] = __bfloat162float(qb[((size_t)(r % T) * a.H + hk * G + r / T) * D + d]);
    acc[i] = 0.f;
  }
  const unsigned char* kb = a.k + ((size_t)b * a.k_sb + (size_t)hk * a.k_sh) * ESZ;
  const unsigned char* vb = a.v + ((size_t)b * a.v_sb + (size_t)hk * a.v_sh) * ESZ;
  const float* ksb = Q8 ? a.ks + (size_t)b * a.ks_sb + (size_t)hk * a.ks_sh : nullptr;
  const float* vsb = Q8 ? a.vs + (size_t)b * a.vs_sb + (size_t)hk * a.vs_sh : nullptr;

  for (int t0 = lo; t0 < hi; t0 += E_TS) {
    const int nv = min(E_TS, hi - t0);
    __syncthreads();  // the previous tile's readers are done
    {  // K then V: each thread's pieces of the tile are loaded, then stored
      constexpr int PER = E_TS * VEC / E_THREADS;
      uint4 buf[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * E_THREADS, j = i / VEC, c = i % VEC;
        if (j < nv) buf[u] = *reinterpret_cast<const uint4*>(kb + (size_t)(t0 + j) * a.k_ss * ESZ + c * 16);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * E_THREADS, j = i / VEC, c = i % VEC;
        if (j < nv) {
          uint32_t* kd = kt + j * KW + c * 4;
          kd[0] = buf[u].x;
          kd[1] = buf[u].y;
          kd[2] = buf[u].z;
          kd[3] = buf[u].w;
        }
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * E_THREADS, j = i / VEC, c = i % VEC;
        if (j < nv) buf[u] = *reinterpret_cast<const uint4*>(vb + (size_t)(t0 + j) * a.v_ss * ESZ + c * 16);
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * E_THREADS, j = i / VEC, c = i % VEC;
        if (j < nv) *reinterpret_cast<uint4*>(vt + (size_t)j * D * ESZ + c * 16) = buf[u];
      }
    }
    if (Q8) {
      for (int j = tid; j < nv; j += E_THREADS) {
        ksc[j] = ksb[t0 + j];
        vsc[j] = vsb[t0 + j];
      }
    }
    __syncthreads();

    // raw scores q . k, one thread per (row, slot) of the tile
    for (int i = tid; i < R * E_TS; i += E_THREADS) {
      const int r = i / E_TS, j = i % E_TS;
      float s = 0.f;
      if (j < nv) {
        const float* qr = qs + r * D;
        const uint32_t* kr = kt + j * KW;
        if (Q8) {
#pragma unroll 8
          for (int w = 0; w < D / 4; ++w) {
            const uint32_t x = kr[w];
            s += qr[4 * w] * i8_at(x, 0) + qr[4 * w + 1] * i8_at(x, 1) +
                 qr[4 * w + 2] * i8_at(x, 2) + qr[4 * w + 3] * i8_at(x, 3);
          }
        } else {
#pragma unroll 8
          for (int w = 0; w < D / 2; ++w) {
            const uint32_t x = kr[w];
            s += qr[2 * w] * bf16_lo(x) + qr[2 * w + 1] * bf16_hi(x);
          }
        }
      }
      sc[i] = s;
    }
    __syncthreads();

    // scale folds, mask and the online softmax update, one warp per row
    for (int r = warp; r < R; r += E_THREADS / 32) {
      const int qslot = qslot_s[r], qp = qpos_s[r];
      float sv[2];
      bool ok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e, s = t0 + j;
        bool valid = j < nv && s <= qslot && s >= vf;
        if (a.window > 0) {
          const int kp = s - vf;
          valid = valid && (a.chunked ? kp >= floordiv(qp, a.window) * a.window
                                      : kp > qp - a.window);
        }
        float x = sc[r * E_TS + j];
        if (Q8) x *= valid ? ksc[j] : 0.f;
        x *= a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        ok[e] = valid;
        sv[e] = valid ? x : E_NEG;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(sv[0], sv[1])));
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        const float p = ok[e] ? expf(sv[e] - m_new) : 0.f;
        psum += p;
        const float ph = Q8 ? p * (ok[e] ? vsc[j] : 0.f) : p;
        sc[r * E_TS + j] = __bfloat162float(__float2bfloat16_rn(ph));
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, one thread per output column
    for (int d = tid; d < D; d += E_THREADS) {
      for (int r = 0; r < R; ++r) {
        const float* pr = sc + r * E_TS;
        float o = acc[r * D + d] * al_s[r];
        if (Q8) {
          const int8_t* vv = reinterpret_cast<const int8_t*>(vt) + d;
          for (int j = 0; j < nv; ++j) o += pr[j] * (float)vv[j * D];
        } else {
          const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(vt) + d;
          for (int j = 0; j < nv; ++j) o += pr[j] * __bfloat162float(vv[j * D]);
        }
        acc[r * D + d] = o;
      }
    }
  }
  __syncthreads();

  for (int r = tid; r < R; r += E_THREADS) {
    a.part_ml[2 * (prow + r)] = m_s[r];
    a.part_ml[2 * (prow + r) + 1] = l_s[r];
  }
  for (int i = tid; i < R * D; i += E_THREADS) a.part_acc[prow * D + i] = acc[i];
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < E_THREADS / 32; ++w) t = is_max ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

// Merge the splits of one query row of one (batch row, kv head): the
// splits' maxima and sums reduce in a fixed order, each split's weight
// exp(m - M) goes to shared memory, then each thread sums its output
// columns over the splits whose row saw a key (l > 0: the others are zero
// or were never written), adds the sink and normalizes.
template <int D>
__global__ void __launch_bounds__(E_THREADS) flash_decode_merge(FdArgs a) {
  extern __shared__ float w_s[];  // (NS) split weights
  __shared__ float red[E_THREADS / 32];
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int T = a.T, G = a.H / a.Hkv, R = G * T;
  const int h = hk * G + r / T, t = r % T;
  const size_t base = (size_t)(b * a.Hkv + hk) * a.NS;
  float mx = E_NEG;
  for (int s = tid; s < a.NS; s += E_THREADS) {
    const float* ml = a.part_ml + 2 * ((base + s) * R + r);
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  const float M = block_reduce(mx, red, true);
  float lsum = 0.f;
  for (int s = tid; s < a.NS; s += E_THREADS) {
    const float* ml = a.part_ml + 2 * ((base + s) * R + r);
    const float w = ml[1] > 0.f ? expf(ml[0] - M) : 0.f;
    w_s[s] = w;
    lsum += ml[1] > 0.f ? ml[1] * w : 0.f;
  }
  float L = block_reduce(lsum, red, false);  // its barriers also publish w_s
  float out_scale = 1.f;
  if (a.has_sinks) {
    const float sk = a.sinks[h];
    const float M2 = fmaxf(M, sk);
    L = L * expf(M - M2) + expf(sk - M2);
    out_scale = expf(M - M2);
  }
  const float inv = L > 0.f ? out_scale / L : 0.f;
  const float* acc = a.part_acc + (base * R + r) * D;
  for (int d = tid; d < D; d += E_THREADS) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < a.NS; ++s) {
      const float w = w_s[s];
      if (w > 0.f) o += w * acc[(size_t)s * R * D + d];
    }
    a.o[(((size_t)b * T + t) * a.H + h) * D + d] = __float2bfloat16_rn(o * inv);
  }
}

template <int D, bool Q8>
int launch(const FdArgs& a, cudaStream_t stream) {
  const int R = (a.H / a.Hkv) * a.T;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(flash_decode_kernel<D, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_bytes<D, Q8>(E_RMAX));
    attr = true;
  }
  flash_decode_kernel<D, Q8><<<dim3(a.NS, a.Hkv, a.B), E_THREADS, smem_bytes<D, Q8>(R), stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<D><<<dim3(R, a.Hkv, a.B), E_THREADS, a.NS * sizeof(float), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpq_flash_decode(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* sinks, const void* qslots, const void* qpos, const void* valid_from,
    void* part_ml, void* part_acc, void* o, int B, int T, int H, int Hkv, int S, int NS, int D,
    int q8, long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
    float scale, float softcap, int window, int chunked, int has_sinks, void* stream) {
  cudaGetLastError();
  // the caller sized part_ml/part_acc for NS splits: they must be this
  // kernel's E_CH-slot splits of S, or the blocks would write past them
  if (Hkv <= 0 || H % Hkv || (H / Hkv) * T > E_RMAX || T < 1 || (D != 128 && D != 256) ||
      S < 1 || NS != (S + E_CH - 1) / E_CH)
    return (int)cudaErrorInvalidValue;
  FdArgs a;
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = reinterpret_cast<const unsigned char*>(k);
  a.v = reinterpret_cast<const unsigned char*>(v);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vs = reinterpret_cast<const float*>(vs);
  a.sinks = reinterpret_cast<const float*>(sinks);
  a.qslots = reinterpret_cast<const int*>(qslots);
  a.qpos = reinterpret_cast<const int*>(qpos);
  a.valid_from = reinterpret_cast<const int*>(valid_from);
  a.part_ml = reinterpret_cast<float*>(part_ml);
  a.part_acc = reinterpret_cast<float*>(part_acc);
  a.o = reinterpret_cast<__nv_bfloat16*>(o);
  a.B = B; a.T = T; a.H = H; a.Hkv = Hkv; a.S = S; a.NS = NS;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.vs_sb = vs_sb; a.vs_sh = vs_sh;
  a.scale = scale; a.softcap = softcap;
  a.window = window; a.chunked = chunked; a.has_sinks = has_sinks;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128) return q8 ? launch<128, true>(a, st) : launch<128, false>(a, st);
  return q8 ? launch<256, true>(a, st) : launch<256, false>(a, st);
}
