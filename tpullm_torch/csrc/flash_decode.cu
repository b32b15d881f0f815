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
// Bound on this card: bytes. Each visible K/V row (plus its two f32 scales
// when int8) is read once; the score and PV work is 4*D flops a (query row,
// key), some 8 flops a byte at G*T = 4, far below the card's ~295. So the
// design keeps every byte of a split in flight before anything waits on it,
// and spends few issued instructions a byte:
// - One block per (split, kv head, batch row). The block's
//   R = G*T query rows (every query head of that kv head, every token) share
//   each K/V row it stages, so GQA costs no reread. A block reads only the
//   slots in [max(split start, valid_from, window start), min(split end,
//   newest q_slot + 1)); a split with no such slot exits at once, touching
//   nothing (the live splits of a batch row are a range every block can
//   compute). The grid is a function of S alone: no host read of the depths.
// - The 4 warps are (m-tile, slot group) pairs: MT = ceil(R / 16) m-tiles of
//   16 query rows (padded to 1, 2 or 4), and 4 / MT slot groups, each owning
//   every (4 / MT)-th 16-slot chunk of the split. A slot group loads its own
//   chunks and only its warps read them, so warps sync on a named barrier of
//   the group (one warp at R <= 16, the server's shape), never the block.
// - At block start each slot group issues every one of its chunks' K and V
//   rows as 16-byte cp.async copies into shared memory, K before V, chunk by
//   chunk, one commit group each (int8: both scale rows with K; rows past
//   the visible range zero-filled, never read from memory); chunk i is
//   computed while chunks i+1.. land.
//   Strided, layer-stacked views are read in place through their strides.
// - Products on the tensor cores, mma.sync m16n8k16 bf16 -> f32: S = Q K^T
//   with the query rows on the 16-row side, so S's accumulator is already
//   P's A fragment for P V (the FlashAttention-2 layout; the tensor cores are
//   there to cut instructions a byte, not for their rate, so the padding of
//   R = 4 rows to 16 costs nothing that bounds the kernel; wgmma's 64-row
//   tile would be 94% padding). Q's fragments are loaded once per block and
//   held in registers. bf16 K and V fragments come by ldmatrix (.trans for
//   V) from rows swizzled by 16-byte chunk (chunk ^ row % 8), so both reads
//   are free of bank conflicts.
// - int8 K and V are converted to bf16 in registers as the fragments are
//   built (a byte permute into 2^23 + byte and one exact add; exact, as every
//   int8 value is a bf16). The order of k inside an mma is free as long as
//   both operands follow it, so a lane's 16-byte load of a K row holds its B
//   fragments of 4 k steps and Q's fragments take the same order; a lane's
//   4-byte load of a V row holds one slot of 4 n8 tiles (columns permuted
//   within 32, undone at the store). The int8 rows use a swizzle that keeps
//   both of those reads free of bank conflicts.
// - Scores are scaled (K scale, then the softmax scale), softcapped and
//   masked in the accumulator registers; the online softmax runs there, the
//   row max and sum by shuffles across the 4 lanes of a row. p (times the V
//   scale) is rounded to bf16 and packed straight into P V's A fragment.
// - The slot groups' (m, l, acc) meet in shared memory after the last chunk
//   and are summed in group order; each live split leaves (m, l, acc) per
//   row. The merge runs in the same launch (a second launch cost 15-16% of
//   the old E's time), in two levels found by arrival counters (the only
//   atomics; one zeroed buffer a device, which every launch leaves zero):
//   the last of each group of E_GRP live splits to arrive merges the group
//   into its first partial, and the last group merges the groups, adds the
//   sink and normalizes. A merge reads 8 partials' (m, l) and acc at once,
//   one round trip to L2, and sums them in partial order. No atomics touch
//   the sums: two calls give identical bits. Masked scores use -1e30 and a
//   masked key contributes exactly 0: a row with no visible key outputs 0
//   (written by split 0 when the batch row has no visible slot at all).
// - Splits are 128 slots for bf16 K/V (64 KB a block at D = 128, 3 blocks an
//   SM) and 256 for int8 (the same bytes: at the server's shape every live
//   block is resident at once, and the merges halve).
// - Head dims 64 (gpt-oss), 128 and 256 are built, each bf16 and int8 on a
//   plain view and bf16 on a ring. D = 64 keeps D = 128's splits and warps
//   (half the bytes a block): the simple instance, not tuned; its int8 rows
//   take the swizzle cut to their 4 chunks. The JAX package's gate asks
//   Dk % 128 == 0 (tpullm/ops/flash_decode.py:254), so there D = 64 takes
//   the einsum path; E at D = 64 is the port's own route.
// - An iSWA ring bank (ring > 0, S = ring: the SWA layers' window + chunk
//   slots, position p at slot p % ring; tpullm/models/llama.py:80-117,
//   313-324) is read in position space: a query at slot q sees the
//   positions [max(valid_from, q - w + 1), q], w = min(window, ring), which
//   is the JAX ring mask (slot j holds the newest position <= q congruent to
//   j, visible while it is >= valid_from and inside the window). The splits
//   tile that position range, CH positions each, from the split holding the
//   batch row's lowest visible position; each copy reads slot p % ring, so a
//   split that crosses the ring's end follows the wrap row by row, whatever
//   ring is modulo CH. The grid holds ceil((ring + 7) / CH) + 1 splits, as
//   many as a range of up to ring + 7 positions (T <= 8 consecutive query
//   slots) can touch. The ring is a template parameter (bf16 only: the
//   int8 cache has no ring), so a plain view's instances carry none of its
//   arithmetic.
// - ALiBi (slopes set; the port's own route, as the JAX package sends ALiBi
//   to its einsum path, tpullm/models/llama.py:277-279, 301-307): each
//   score gets slope_h * (key position - query position) after the scale,
//   in the split pass, as the scores the merge expects (natural units), one
//   FMA a score. A key's position is its slot - valid_from (never a ring:
//   check_dense keeps ALiBi from windows). Without slopes the kernel
//   computes what it did before, bit for bit; with them no softcap (no
//   arch has both).
// Partials are stored by live index (split - the row's first live split),
// so a ring's splits and a plain view's take the same merges.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using tph::saddr;

// slots per split (one block), bf16 and int8 K/V; ops/flash_decode.py E_CH
template <bool Q8>
constexpr int split_of() { return Q8 ? 256 : 128; }
constexpr int E_CK = 16;      // slots per chunk (one k step of P V)
constexpr int E_THREADS = 128;
constexpr int E_RMAX = 64;    // query rows (G * T) per kv head
constexpr float E_NEG = -1e30f;
constexpr int E_GRP = 8;       // live splits a first-level merge takes; ops/flash_decode.py

struct FdArgs {
  const __nv_bfloat16* q;  // (B, T, H, D) contiguous
  const unsigned char* k;  // (B, Hkv, S, D) strided, bf16 or int8
  const unsigned char* v;
  const float* ks;         // (B, Hkv, S) row scales, slot stride 1 (int8 only)
  const float* vs;
  const float* sinks;      // (H,) or null
  const long long* qslots;      // (B, T)
  const long long* qpos;        // (B, T)
  const long long* valid_from;  // (B,)
  float* part_ml;               // (B, Hkv, NS, R, 2)
  float* part_acc;              // (B, Hkv, NS, R, D)
  int* cnt;                     // (B, Hkv, NS / E_GRP + 2) arrival counters, 0 at launch and exit
  __nv_bfloat16* o;             // (B, T, H, D)
  int B, T, H, Hkv, S, NS;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, ks_sb, ks_sh, vs_sb, vs_sh;
  float scale, softcap;
  int window, chunked, has_sinks;
  int ring;  // > 0: S = ring slots of an iSWA ring bank, read by position
  const float* slopes;  // (H,) ALiBi slopes, or null
};

// Shared memory: K rows (CH x D x esize), V rows, (int8) the K and V
// scales of the split's slots; after the last chunk the same bytes hold each
// warp's acc (4 x 16 rows of D + 4 f32: the pad spreads a store's rows over
// the banks). Then each warp's (m, l) of its 16 rows, the slot groups'
// factors (later a merge's rows' (M, L)) and the arrival flag.
template <int D, bool Q8>
struct Smem {
  static constexpr int CH = split_of<Q8>();
  static constexpr int RB = D * (Q8 ? 1 : 2);  // bytes of one K or V row
  static constexpr int K = 0;
  static constexpr int V = CH * RB;
  static constexpr int KS = 2 * CH * RB;
  static constexpr int VS = KS + (Q8 ? CH * 4 : 0);
  static constexpr int AW = D + 4;             // floats of a row of a warp's acc
  static constexpr int KV_END = VS + (Q8 ? CH * 4 : 0);
  static constexpr int ACC_END = 4 * 16 * AW * 4;
  static constexpr int ML = KV_END > ACC_END ? KV_END : ACC_END;
  static constexpr int FAC = ML + 4 * 16 * 2 * 4;
  static constexpr int LAST = FAC + 4 * E_RMAX * 4;
  static constexpr int BYTES = LAST + 16;
};

// 16-byte chunk c of buffer row j (VEC chunks a row), as stored: bf16 rows
// (read by ldmatrix, 8 rows at one chunk; VEC >= 8) xor the chunk with j %
// 8; int8 rows (read as 16-byte K pieces by 4 lanes on each of 2 rows, and
// as 4-byte V words by 8 lanes on each of 4 rows 2 apart) with a pattern
// that spreads both reads over the 32 banks, cut to the row's VEC chunks
// (the 4 of a 64-wide int8 row: a permutation of them, whatever it costs in
// conflicts; the wider rows' pattern is unchanged)
template <bool Q8, int VEC>
__device__ __forceinline__ int swz(int j, int c) {
  if (!Q8) return c ^ (j & 7);
  return c ^ (((((j >> 1) & 3) << 1) ^ ((j & 1) << 2)) & (VEC - 1));
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// 16 bytes global -> shared, or 16 zero bytes where !ok (nothing is read)
__device__ __forceinline__ void cp16z(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4z(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// waits until at most n of this thread's commit groups are pending (past 15,
// until 15: more than asked, never less)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
#define E_WAIT(i) \
  case i: asm volatile("cp.async.wait_group " #i ";" ::: "memory"); break;
    E_WAIT(0) E_WAIT(1) E_WAIT(2) E_WAIT(3) E_WAIT(4) E_WAIT(5) E_WAIT(6) E_WAIT(7)
    E_WAIT(8) E_WAIT(9) E_WAIT(10) E_WAIT(11) E_WAIT(12) E_WAIT(13) E_WAIT(14)
#undef E_WAIT
    default: asm volatile("cp.async.wait_group 15;" ::: "memory");
  }
}

// the threads of one slot group: named barrier 1 + group, or the warp alone
__device__ __forceinline__ void group_sync(int sg, int nthreads) {
  if (nthreads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + sg), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte c of x (an int8 word xor 0x80808080) -> its int8 value as a float,
// exactly: 0x4B0000bb is 2^23 + bb; two23 holds 0x4B000000 in a register so
// that the selector stays the permute's immediate
__device__ __forceinline__ float i8f(uint32_t x, uint32_t two23, int c) {
  return __fadd_rn(__uint_as_float(__byte_perm(x, two23, 0x7440u | c)), -8388736.f);
}

// the bf16 pair (lo, hi) of two floats that hold small integers (exact: the
// low 16 bits are zero), as one permute of their high halves
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the cache slot of a position (a ring's) or of a slot (a plain view's)
template <bool RING>
__device__ __forceinline__ int slot_of(const FdArgs& a, int p) {
  return RING ? p % a.ring : p;
}

// One split's partial (m, l, acc) of every query row, over the visible
// slots [lo, hi) of split sp (on a ring: positions, read at p % ring)
template <int D, bool Q8, bool RING>
__device__ __forceinline__ void split_partial(const FdArgs& a, unsigned char* sm, int sp, int lo,
                                              int hi, size_t prow) {
  using L = Smem<D, Q8>;
  constexpr int RB = L::RB;
  constexpr int VEC = RB / 16;  // 16-byte pieces of a row
  constexpr int KS = D / 16;    // k steps of Q K^T
  constexpr int NT = D / 8;     // n8 tiles of P V
  const uint32_t sbase = saddr(sm);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int T = a.T, G = a.H / a.Hkv, R = G * T;
  const int MT = (R + 15) / 16, MTp = MT == 3 ? 4 : MT, SG = 4 / MTp;
  const int mt = warp % MTp, sg = warp / MTp, gthreads = 32 * MTp;
  const int vf = (int)a.valid_from[b], s0 = sp * L::CH;
  // this slot group's chunks c = sg + SG * i that hold a slot of [lo, hi)
  const int c_lo = (lo - s0) / E_CK, c_hi = (hi - 1 - s0) / E_CK;
  const int ncw = L::CH / E_CK / SG;

  // Q's A fragments for the warp's rows r0 = 16 mt + g and r0 + 8 (query row
  // r = gq * T + t is token t of query head hk * G + gq), loaded first so
  // that they do not queue behind the K/V copies
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* q0 = a.q + ((size_t)(b * T + r0 % T) * a.H + hk * G + r0 / T) * D;
    const __nv_bfloat16* q1 = a.q + ((size_t)(b * T + r1 % T) * a.H + hk * G + r1 / T) * D;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // logical k 2c + {0, 1} and 2c + 8 + {0, 1} of k step s, at these d
      const int d0 = Q8 ? (s / 4) * 64 + 16 * c + 4 * (s % 4) : 16 * s + 2 * c;
      const int d1 = Q8 ? d0 + 2 : d0 + 8;
      qa[s][0] = r0 < R ? ld_u32(q0 + d0) : 0u;
      qa[s][1] = r1 < R ? ld_u32(q1 + d0) : 0u;
      qa[s][2] = r0 < R ? ld_u32(q0 + d1) : 0u;
      qa[s][3] = r1 < R ? ld_u32(q1 + d1) : 0u;
    }
  }
  // issue every load of the group's chunks: K then V, chunk by chunk
  {
    constexpr int ESZ = Q8 ? 1 : 2;
    const unsigned char* kb = a.k + ((size_t)b * a.k_sb + (size_t)hk * a.k_sh) * ESZ;
    const unsigned char* vb = a.v + ((size_t)b * a.v_sb + (size_t)hk * a.v_sh) * ESZ;
    const float* ksb = Q8 ? a.ks + (size_t)b * a.ks_sb + (size_t)hk * a.ks_sh : nullptr;
    const float* vsb = Q8 ? a.vs + (size_t)b * a.vs_sb + (size_t)hk * a.vs_sh : nullptr;
    const int lt = mt * 32 + lane;
    for (int i = 0; i < ncw; ++i) {
      const int ch = sg + SG * i;
      const bool live = ch >= c_lo && ch <= c_hi;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        if (live) {
          const unsigned char* base = kv ? vb : kb;
          const long long ss = (kv ? a.v_ss : a.k_ss) * ESZ;
          for (int e = lt; e < E_CK * VEC; e += gthreads) {
            const int j = ch * E_CK + e / VEC, piece = e % VEC, slot = s0 + j;
            const bool ok = slot >= lo && slot < hi;
            cp16z(sbase + (kv ? L::V : L::K) + j * RB + swz<Q8, VEC>(j, piece) * 16,
                  base + (size_t)slot_of<RING>(a, ok ? slot : lo) * ss + piece * 16, ok);
          }
          if (Q8 && kv == 0 && lt < 2 * E_CK) {
            // both scale rows come with K: p takes the V scale before P V
            // waits for the V rows
            const int j = ch * E_CK + lt % E_CK, slot = s0 + j;
            const bool ok = slot >= lo && slot < hi;
            cp4z(sbase + (lt < E_CK ? L::KS : L::VS) + j * 4,
                 (lt < E_CK ? ksb : vsb) + slot_of<RING>(a, ok ? slot : lo), ok);
          }
        }
        cp_commit();
      }
    }
  }

  // each of the two rows' visible slots: [slo, shi]
  int slo[2], shi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= R) {
      slo[h] = 0x7fffffff;
      shi[h] = -1;
      continue;
    }
    const int qs = (int)a.qslots[b * T + r % T], qp = (int)a.qpos[b * T + r % T];
    if (RING) {  // positions (q - w, q] from valid_from on
      const int w = a.window > 0 ? min(a.window, a.ring) : a.ring;
      slo[h] = max(vf, qs - w + 1);
      shi[h] = qs;
      continue;
    }
    int l0 = vf;
    if (a.window > 0)
      l0 = max(l0, vf + (a.chunked ? floordiv(qp, a.window) * a.window : qp - a.window + 1));
    slo[h] = l0;
    shi[h] = min(qs, a.S - 1);
  }
  // ALiBi: each row's slope, and -(valid_from + its position): slot s's term
  // is sl * (s + ab)
  float sl[2] = {0.f, 0.f};
  int ab[2] = {0, 0};
  if (a.slopes != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0;
      if (r < R) {
        sl[h] = __ldg(a.slopes + hk * G + r / T);
        ab[h] = -vf - (int)a.qpos[b * T + r % T];
      }
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {E_NEG, E_NEG}, l_run[2] = {0.f, 0.f};
  const uint32_t two23 = 0x4B000000u;
  const float* kss = reinterpret_cast<const float*>(sm + L::KS);
  const float* vss = reinterpret_cast<const float*>(sm + L::VS);

  for (int i = 0; i < ncw; ++i) {
    const int ch = sg + SG * i;
    if (ch < c_lo || ch > c_hi) continue;  // the same for the whole group
    const int j0 = ch * E_CK;  // the chunk's first buffer row
    cp_wait(2 * (ncw - i) - 1);  // this chunk's K rows are in
    group_sync(sg, gthreads);

    // S = Q K^T over the chunk's 16 slots: two n8 tiles of slots
    float sc[2][4];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      sc[jn][0] = sc[jn][1] = sc[jn][2] = sc[jn][3] = 0.f;
      const int jr = j0 + 8 * jn + g;  // this lane's K row in B fragments
      if (Q8) {
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              sm + L::K + jr * RB + swz<true, VEC>(jr, 4 * p + c) * 16);
          const uint32_t wv[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                                  w.w ^ 0x80808080u};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const uint32_t b0 = bf16_pair(i8f(wv[h], two23, 0), i8f(wv[h], two23, 1));
            const uint32_t b1 = bf16_pair(i8f(wv[h], two23, 2), i8f(wv[h], two23, 3));
            mma_16816(sc[jn], qa[4 * p + h], b0, b1);
          }
        }
      } else {
        const int jl = j0 + 8 * jn + (lane & 7);  // the row this lane addresses
#pragma unroll
        for (int s = 0; s < KS; s += 2) {
          uint32_t r[4];
          ldsm_x4(r, sbase + L::K + jl * RB + swz<false, VEC>(jl, 2 * s + (lane >> 3)) * 16);
          mma_16816(sc[jn], qa[s], r[0], r[1]);
          mma_16816(sc[jn], qa[s + 1], r[2], r[3]);
        }
      }
    }

    // scale, softcap and mask in the registers; the chunk's row max
    float mx[2] = {E_NEG, E_NEG};
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int jb = j0 + 8 * jn + 2 * c;  // buffer row of element 0 (and 2)
      float2 ksc = make_float2(1.f, 1.f);
      if (Q8) ksc = *reinterpret_cast<const float2*>(kss + jb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, slot = s0 + jb + (e & 1);
        float x = sc[jn][e];
        if (Q8) x *= (e & 1) ? ksc.y : ksc.x;
        x *= a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        if (a.slopes != nullptr) x = fmaf(sl[h], (float)(slot + ab[h]), x);
        const bool ok = slot >= slo[h] && slot <= shi[h];
        sc[jn][e] = ok ? x : E_NEG;
        mx[h] = fmaxf(mx[h], sc[jn][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
    // p = exp(s - m) on visible keys (0 elsewhere), summed unrounded; p times
    // the V scale, rounded to bf16, is P V's A fragment
    uint32_t pa[4];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      const int jb = j0 + 8 * jn + 2 * c;
      float2 vsc = make_float2(1.f, 1.f);
      if (Q8) vsc = *reinterpret_cast<const float2*>(vss + jb);
      float ph[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = sc[jn][e] > 0.5f * E_NEG ? expf(sc[jn][e] - m_run[h]) : 0.f;
        l_run[h] += p;
        ph[e] = Q8 ? p * ((e & 1) ? vsc.y : vsc.x) : p;
      }
      pa[2 * jn] = tph::pack_bf16(ph[0], ph[1]);
      pa[2 * jn + 1] = tph::pack_bf16(ph[2], ph[3]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    cp_wait(2 * (ncw - i) - 2);  // this chunk's V rows are in
    group_sync(sg, gthreads);

    // acc += P V: k = the chunk's 16 slots
    if (Q8) {
#pragma unroll
      for (int tb = 0; tb < D / 32; ++tb) {
        // one 4-byte word of each of the lane's 4 slots: 4 n8 tiles' bytes
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jr = j0 + 2 * c + (u & 1) + 8 * (u >> 1);
          w[u] = *reinterpret_cast<const uint32_t*>(
                     sm + L::V + jr * RB + swz<true, VEC>(jr, 2 * tb + (g >> 2)) * 16 + (g & 3) * 4) ^
                 0x80808080u;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t b0 = bf16_pair(i8f(w[0], two23, u), i8f(w[1], two23, u));
          const uint32_t b1 = bf16_pair(i8f(w[2], two23, u), i8f(w[3], two23, u));
          mma_16816(acc[4 * tb + u], pa, b0, b1);
        }
      }
    } else {
      // lanes 0-7 / 8-15 address slots 0-7 / 8-15 of d chunk n, 16-31 chunk n + 1
      const int jl = j0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, sbase + L::V + jl * RB + swz<false, VEC>(jl, n + (lane >> 4)) * 16);
        mma_16816(acc[n], pa, r[0], r[1]);
        mma_16816(acc[n + 1], pa, r[2], r[3]);
      }
    }
  }

  // the slot groups' (m, l, acc) meet in shared memory (acc over the K/V
  // bytes, once every warp is done reading them; rows past R are not
  // stored) and are summed in group order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  __syncthreads();
  float* ml = reinterpret_cast<float*>(sm + L::ML);    // (warp, 16 rows, 2)
  float* fac = reinterpret_cast<float*>(sm + L::FAC);  // (slot group, R)
  float* wacc = reinterpret_cast<float*>(sm);          // (warp, 16 rows, AW)
  if (c == 0) {
    ml[(warp * 16 + g) * 2] = m_run[0];
    ml[(warp * 16 + g) * 2 + 1] = l_run[0];
    ml[(warp * 16 + g + 8) * 2] = m_run[1];
    ml[(warp * 16 + g + 8) * 2 + 1] = l_run[1];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (mt * 16 + g + 8 * (e / 2) >= R) continue;
    float* row = wacc + (warp * 16 + g + 8 * (e / 2)) * L::AW;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // column 2c + (e & 1) of n8 tile n, at its d
      const int col = 2 * c + (e & 1);
      row[Q8 ? (n / 4) * 32 + 4 * col + n % 4 : 8 * n + col] = acc[n][e];
    }
  }
  __syncthreads();
  if (tid < R) {  // each row's factors exp(m - M), and its (M, l)
    const int rm = tid / 16, rr = tid % 16;
    float M = E_NEG, l = 0.f;
    for (int s = 0; s < SG; ++s) M = fmaxf(M, ml[((s * MTp + rm) * 16 + rr) * 2]);
    for (int s = 0; s < SG; ++s) {
      const int w = (s * MTp + rm) * 16 + rr;
      const float f = expf(ml[w * 2] - M);
      fac[s * R + tid] = f;
      l += f * ml[w * 2 + 1];
    }
    a.part_ml[2 * (prow + tid)] = M;
    a.part_ml[2 * (prow + tid) + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += E_THREADS) {
    const int r = i / D, d = i % D;
    float o = 0.f;
    for (int s = 0; s < SG; ++s)
      o += fac[s * R + r] * wacc[((s * MTp + r / 16) * 16 + r % 16) * L::AW + d];
    a.part_acc[prow * D + i] = o;
  }
}

// Merges n partials of a (batch row, kv head), at splits first + k * stride.
// Each thread takes 4 output columns of one query row and reads, 8 partials
// at a time, their (m, l) and those columns of their acc together, so a merge
// of up to 8 partials costs one round trip to L2 and no barrier: over each
// batch of 8 the maximum M of the m whose l > 0 is taken and the running sum
// rescaled to it, then the batch is added in partial order with weights
// exp(m - M) (0 for a partial whose row saw no key, l = 0, whose acc is 0).
// With final, the sink is added, the row normalized and written out in
// bf16; otherwise (M, L, acc) is written over partial `first`: each thread
// writes only the acc it read, and the rows' (M, L) wait in shared memory
// (mls, R float2) until every thread has read partial `first`'s.
template <int D>
__device__ __forceinline__ void merge_parts(const FdArgs& a, int b, int hk, int first,
                                            int stride, int n, bool final, float2* mls) {
  const int T = a.T, G = a.H / a.Hkv, R = G * T;
  const size_t base = (size_t)(b * a.Hkv + hk) * a.NS + first;  // partial k: base + k * stride
  float2* ml = reinterpret_cast<float2*>(a.part_ml);
  float4* acc = reinterpret_cast<float4*>(a.part_acc);
  for (int f = threadIdx.x; f < R * D / 4; f += E_THREADS) {
    const int r = f / (D / 4), d4 = f % (D / 4);
    float M = E_NEG, L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < n; k0 += 8) {
      float2 v[8];
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k0 + u < n) {
          const size_t row = (base + (size_t)(k0 + u) * stride) * R + r;
          v[u] = __ldcg(ml + row);
          x[u] = __ldcg(acc + row * (D / 4) + d4);
        }
      }
      float Mb = M;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n && v[u].y > 0.f) Mb = fmaxf(Mb, v[u].x);
      const float al = expf(M - Mb);
      L *= al;
      o.x *= al;
      o.y *= al;
      o.z *= al;
      o.w *= al;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k0 + u < n) {  // w = 0 adds an exact 0: the partial's acc is finite
          const float w = v[u].y > 0.f ? expf(v[u].x - Mb) : 0.f;
          L += v[u].y > 0.f ? v[u].y * w : 0.f;
          o.x += w * x[u].x;
          o.y += w * x[u].y;
          o.z += w * x[u].z;
          o.w += w * x[u].w;
        }
      }
      M = Mb;
    }
    if (final) {
      float inv = 1.f;
      if (a.has_sinks) {
        const float sk = a.sinks[hk * G + r / T];
        const float M2 = fmaxf(M, sk);
        L = L * expf(M - M2) + expf(sk - M2);
        inv = expf(M - M2);
      }
      inv = L > 0.f ? inv / L : 0.f;
      uint2 packed;
      packed.x = tph::pack_bf16(o.x * inv, o.y * inv);
      packed.y = tph::pack_bf16(o.z * inv, o.w * inv);
      *reinterpret_cast<uint2*>(a.o + (((size_t)b * T + r % T) * a.H + hk * G + r / T) * D +
                                4 * d4) = packed;
    } else {
      acc[(base * R + r) * (D / 4) + d4] = o;
      if (d4 == 0) mls[r] = make_float2(M, L);
    }
  }
  if (!final) {
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += E_THREADS) ml[base * R + r] = mls[r];
  }
}

// The arrival of a block at counter cnt, which expects `expect` arrivals:
// the block's writes are ordered before thread 0's fence by the barrier (a
// fence is cumulative), so one thread fences, counts, and fences again
// before the last block reads the others' partials. True in the last block,
// which sets the counter back to 0.
__device__ __forceinline__ bool arrive(int* cnt, int expect, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(cnt, 1) == expect - 1;
    if (*flag) *cnt = 0;  // ready for the next launch
    __threadfence();
  }
  __syncthreads();
  return *flag;
}

template <int D, bool Q8, bool RING>
__global__ void __launch_bounds__(E_THREADS, D == 256 ? 1 : 3) flash_decode_kernel(FdArgs a) {
  extern __shared__ __align__(128) unsigned char sm[];
  using L = Smem<D, Q8>;
  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int T = a.T, G = a.H / a.Hkv, R = G * T;
  int newest = (int)a.qslots[b * T], minq = newest, minpos = (int)a.qpos[b * T];
  for (int t = 1; t < T; ++t) {
    newest = max(newest, (int)a.qslots[b * T + t]);
    minq = min(minq, (int)a.qslots[b * T + t]);
    minpos = min(minpos, (int)a.qpos[b * T + t]);
  }
  // the slots (a ring's: positions) any of the row's queries may see:
  // [lo_b, hi_b); the live splits are those that hold one, the others exit
  // at once
  const int vf = (int)a.valid_from[b];
  int lo_b = vf, hi_b;
  if (RING) {
    const int w = a.window > 0 ? min(a.window, a.ring) : a.ring;
    hi_b = newest + 1;
    // the query slots of a batch row are consecutive (first + t), so the
    // range holds at most ring + 7 positions: the grid's splits
    lo_b = max(max(lo_b, minq - w + 1), hi_b - (a.ring + 7));
  } else {
    if (a.window > 0)
      lo_b = max(lo_b, vf + (a.chunked ? floordiv(minpos, a.window) * a.window
                                       : minpos - a.window + 1));
    hi_b = min(newest + 1, a.S);
  }
  if (hi_b <= lo_b) {  // no visible key: block 0 writes the rows' zeros
    if (blockIdx.z == 0)
      for (int i = tid; i < R * D; i += E_THREADS) {
        const int r = i / D;
        a.o[(((size_t)b * T + r % T) * a.H + hk * G + r / T) * D + i % D] =
            __float2bfloat16_rn(0.f);
      }
    return;
  }
  // live index k of this block: a plain view's grid holds every split of S
  // (split sp0 + k is block sp0 + k), a ring's only the live range (block k)
  const int sp0 = lo_b / L::CH, nl = (hi_b - 1) / L::CH - sp0 + 1;
  const int k = RING ? (int)blockIdx.z : (int)blockIdx.z - sp0;
  if (k < 0 || k >= nl) return;
  const int sp = sp0 + k, s0 = sp * L::CH;
  split_partial<D, Q8, RING>(a, sm, sp, max(s0, lo_b), min(s0 + L::CH, hi_b),
                       ((size_t)(b * a.Hkv + hk) * a.NS + k) * R);
  // two merge levels, in a fixed order: the last split of each group of
  // E_GRP live splits to arrive merges the group into the group's first
  // partial, then the last group merges the groups and writes the rows
  int* cnt = a.cnt + (size_t)(b * a.Hkv + hk) * (a.NS / E_GRP + 2);
  int* flag = reinterpret_cast<int*>(sm + L::LAST);
  const int gi = k / E_GRP, ng = (nl + E_GRP - 1) / E_GRP;
  const int g0 = gi * E_GRP, gn = min(E_GRP, nl - g0);
  if (!arrive(cnt + gi, gn, flag)) return;
  merge_parts<D>(a, b, hk, g0, 1, gn, ng == 1, reinterpret_cast<float2*>(sm + L::FAC));
  if (ng == 1 || !arrive(cnt + a.NS / E_GRP + 1, ng, flag)) return;
  merge_parts<D>(a, b, hk, 0, E_GRP, ng, true, nullptr);
}

template <int D, bool Q8, bool RING>
int launch(const FdArgs& a, cudaStream_t stream) {
  constexpr int SMEM = Smem<D, Q8>::BYTES;
  // set on every launch, on the current device (a per-process flag would
  // leave a second card's launches refused)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<D, Q8, RING>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  // split slowest: the live splits of every row (the low ones) start first
  flash_decode_kernel<D, Q8, RING><<<dim3(a.Hkv, a.B, a.NS), E_THREADS, SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpq_flash_decode(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* sinks, const void* qslots, const void* qpos, const void* valid_from,
    void* part_ml, void* part_acc, void* counters, void* o, int B, int T, int H, int Hkv, int S,
    int NS, int D,
    int q8, long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
    float scale, float softcap, int window, int chunked, int has_sinks, int ring,
    const void* slopes, void* stream) {
  cudaGetLastError();
  // the caller sized part_ml/part_acc for NS splits: they must be this
  // kernel's splits of S (of a ring's live range), or the blocks would
  // write past them
  const int ch = q8 ? split_of<true>() : split_of<false>();
  const int ns = ring > 0 ? (ring + 7 + ch - 1) / ch + 1 : (S + ch - 1) / ch;
  if (Hkv <= 0 || H % Hkv || (H / Hkv) * T > E_RMAX || T < 1 || T > 8 ||
      (D != 64 && D != 128 && D != 256) || S < 1 || NS != ns || ring < 0 || (ring > 0 && ring != S) ||
      (ring > 0 && (chunked || q8)) || (slopes != nullptr && softcap != 0.f))
    return (int)cudaErrorInvalidValue;
  FdArgs a;
  a.q = reinterpret_cast<const __nv_bfloat16*>(q);
  a.k = reinterpret_cast<const unsigned char*>(k);
  a.v = reinterpret_cast<const unsigned char*>(v);
  a.ks = reinterpret_cast<const float*>(ks);
  a.vs = reinterpret_cast<const float*>(vs);
  a.sinks = reinterpret_cast<const float*>(sinks);
  a.qslots = reinterpret_cast<const long long*>(qslots);
  a.qpos = reinterpret_cast<const long long*>(qpos);
  a.valid_from = reinterpret_cast<const long long*>(valid_from);
  a.part_ml = reinterpret_cast<float*>(part_ml);
  a.part_acc = reinterpret_cast<float*>(part_acc);
  a.cnt = reinterpret_cast<int*>(counters);
  a.o = reinterpret_cast<__nv_bfloat16*>(o);
  a.B = B; a.T = T; a.H = H; a.Hkv = Hkv; a.S = S; a.NS = NS;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.ks_sb = ks_sb; a.ks_sh = ks_sh; a.vs_sb = vs_sb; a.vs_sh = vs_sh;
  a.scale = scale; a.softcap = softcap;
  a.window = window; a.chunked = chunked; a.has_sinks = has_sinks;
  a.ring = ring;
  a.slopes = reinterpret_cast<const float*>(slopes);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (ring > 0) {
    if (D == 64) return launch<64, false, true>(a, st);
    return D == 128 ? launch<128, false, true>(a, st) : launch<256, false, true>(a, st);
  }
  if (D == 64) return q8 ? launch<64, true, false>(a, st) : launch<64, false, false>(a, st);
  if (D == 128) return q8 ? launch<128, true, false>(a, st) : launch<128, false, false>(a, st);
  return q8 ? launch<256, true, false>(a, st) : launch<256, false, false>(a, st);
}
