// Kernel C: causal prefill flash attention over a head-major KV cache, on
// Hopper's TMA and wgmma.
//
// Replaces the Pallas kernel tpullm/ops/flash_attention.py:_build
// (flash_attention.py:28, pallas_call :117): online softmax over KV tiles,
// GQA by head index (KV head h / G), slot mask valid_from <= kv_slot <=
// q_slot, optional sliding window on real positions and logit softcap.
//
// Bound on this card. Shallow (the engine's prefill: 4 prompts bucketed to
// 512, at most 512 live keys): bytes, mostly q and o, with K/V once per
// batch row and KV head. Deep (a server chunk of 512 queries at slot 5632
// over ~6000 live keys): operations, 4 D flops a visible query/key pair on
// the tensor cores.
//
// What the design does about it:
// - A block holds one batch row and one KV head. Its consumer warpgroups
//   (two at D = 128, one at D = 256) each own one (64-slot query tile,
//   query head of the group) pair; pairs are enumerated tile-major (all G
//   heads of tile 0, then of tile 1), and a block takes consecutive pairs.
//   So the heads of a GQA group share every K/V tile a block loads, and at
//   G = 1 a block takes neighbouring tiles of one head.
// - One producer warp (at D = 128 setmaxnreg leaves its warpgroup few
//   registers) feeds Q once and TK-key K and V tiles by 4-D TMA over the
//   (D, slot, head, batch) strides the wrapper passes, so a cache view is
//   read in place. A row of D bf16 values takes D / 64 128-byte-swizzled
//   boxes. K and V land in a ring of stages with full barriers of their
//   own, so S = Q K^T starts before V has landed; every consumer releases a
//   stage on its empty barrier, including stages their rows never see.
// - S = Q K^T is wgmma m64nTKk16 with both operands K-major in shared
//   memory (a k16 step is a 32-byte advance, the next 64-column atom
//   starts after every fourth step). The softmax runs on the accumulator
//   registers: a thread holds parts of two rows, whose max and sum take
//   two xor-shuffles over the quad; exp2 with log2(e) folded into the
//   scale (after the tanh with softcap). P is rounded to bf16
//   unnormalised, as the Pallas kernel does, and packed straight into the
//   k16 A-fragment registers: O += P V is wgmma with A from registers and
//   V as an MN-major B operand (the transpose bit), one m64n128 product
//   per 128 columns of D. S, P, the running max and sum and O never leave
//   the registers until the end, when O / l goes out as bf16 through the
//   warpgroup's Q tile in whole rows.
// - Two instances, by head dim D = Dk = Dv. At D = 128 the key tile TK is
//   128: Q 2 x 16 KB and 2 stages of K and V at 32 KB each, 160 KB, and
//   ptxas fits O (64 f32 a thread), S (64) and P (32 words) in the 168
//   registers a 384-thread block allows. At D = 256 that ring would need
//   2 x 32 KB of Q and 2 x (K + V) x 64 KB, 320 KB, over the 227 KB a
//   block may hold, so TK is 64 there; and O alone is 128 f32 a thread,
//   which does not fit beside S in 168 registers (ptxas spilled 780 bytes
//   a thread with two consumers at TK = 64, 384 at TK = 32, whatever
//   setmaxnreg asked). So the D = 256 block has one consumer warpgroup
//   (256 threads, up to 255 registers a thread, no setmaxnreg) and one
//   pair: Q 32 KB and the ring 128 KB, 160 KB, one block an SM.
// - Masks (causal, valid_from, window) are evaluated only on tiles that
//   straddle a boundary. A masked key contributes exactly 0 and a row with
//   no visible key outputs 0. The KV loop runs from the tile holding
//   valid_from to the block's largest query slot: no fully masked tile is
//   read. A block whose rows all lie before valid_from writes zeros and
//   returns before any barrier exists.
// - An iSWA ring bank (ring > 0, S = ring: the SWA layers' window + chunk
//   slots, position p at slot p % ring; tpullm/models/llama.py:80-117,
//   313-324) is read in position space: the KV loop runs over the positions
//   [max(valid_from, least query slot - w + 1), largest query slot], w =
//   min(window, ring), in TK-position tiles, and each tile's K and V come
//   as 64-row TMA boxes from slot (p % ring): ring is a multiple of 64, so
//   a box never crosses the ring's end, and a 128-key tile that does is two
//   boxes from both ends. The mask is the JAX ring mask: position p is
//   visible to the query at slot q where valid_from <= p <= q and q - p <
//   w. A chunk of T <= ring - window rows writes no ring slot that one of
//   its queries still sees (llama.py:315-319), so the positions are exact.
//   The rows of a chunk need not fill the last 64-row query tile: the rows
//   past T read as zeros (TMA fills past the tensor's end), see no key and
//   are not written.
// - ALiBi (slopes set; the port's own route, as the JAX package sends ALiBi
//   to its einsum path, tpullm/models/llama.py:268-279, 301-307): each
//   score gets slope_h * (key position - query position) after the scale,
//   in the log2 units of the scores (the slope times log2 e), one FMA a
//   score. A key's position is its slot - valid_from, as forward's
//   kv_positions are (never a ring: check_dense keeps ALiBi from
//   windows). Without slopes
//   the instance computes what it did before, bit for bit; with them no
//   softcap (no arch has both).
// - llama4's chunked window (chunked set; the port's own route: the Pallas
//   kernel masks such a layer as a sliding window,
//   tpullm/ops/flash_attention.py:61-64, where the JAX einsum path, the
//   oracle, masks by chunk, tpullm/models/llama.py:335-337): the query at
//   position p sees the keys of positions floor(p / w) * w .. p, each row's
//   first visible key max(valid_from, its chunk's start). The KV loop starts
//   at the tile of the block's least query position's chunk start (in slots,
//   valid_from + floor(p_min / w) * w, as kernel E's split range does), so a
//   block past a chunk boundary reads no tile of the chunks before, and a
//   block that straddles one masks each row by its own chunk. Never on a
//   ring (the dual cache builds none for chunked layers).
// No split over keys and no atomics: repeats are bit-identical.
#include "hopper.cuh"

using namespace tph;

namespace {

constexpr int TQ = 64;
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// the D = 128 instance's setmaxnreg split: producer warpgroup 40, consumers 232
static_assert(128 * 40 + 256 * 232 <= 65536, "register file");

// the tile sizes of the instance for head dim HD (128 or 256)
template <int HD>
struct Tiles {
  static constexpr int TK = HD == 128 ? 128 : 64;  // keys a stage
  // consumer warpgroups, each with its own (query tile, head) pair, after
  // the producer warpgroup
  static constexpr int NC = HD == 128 ? 2 : 1;
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int Q_ATOM = TQ * 128;          // one 64-column atom of Q
  static constexpr int KV_ATOM = TK * 128;         // one 64-column atom of K or V
  static constexpr int Q_BYTES = TQ * HD * 2;      // one warpgroup's Q: HD / 64 atoms
  static constexpr int KV_BYTES = TK * HD * 2;     // one K or V tile: HD / 64 atoms
  static constexpr int SMEM = 1024 + NC * Q_BYTES + STAGES * 2 * KV_BYTES +
                              (1 + 3 * STAGES) * 8 + 2 * 2 * TQ * 4 + 3 * 4 * 4;
  static_assert(SMEM <= 232448, "shared memory of a block");
};

struct FaArgs {
  const int* qslots;      // (B, T)
  const int* kvpos;       // (B, S)
  const int* qpos;        // (B, T)
  const int* valid_from;  // (B,)
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_st;
  int T, S, G;
  float scale_log2, softcap_in, softcap_out;  // softcap_in 0: no softcap
  int window;
  int chunked;  // the window is llama4's chunk (never with a ring)
  int ring;  // > 0: S = ring slots of an iSWA ring bank, read by position
  const float* slopes;  // (H,) ALiBi slopes, or null
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b rounded toward minus infinity (b > 0): a left-padding row's
// position is negative
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// bf16 zeros over the 64 output rows of one (query tile, head) pair
template <int HD>
__device__ __forceinline__ void store_zero_rows(const FaArgs& a, __nv_bfloat16* ob, int tile,
                                                int head) {
  for (int i = threadIdx.x; i < TQ * HD / 8; i += Tiles<HD>::THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (tile * TQ + r >= a.T) break;  // rows past T: none
    *reinterpret_cast<uint4*>(ob + (long long)(tile * TQ + r) * a.o_st + head * a.o_sh + c) =
        make_uint4(0, 0, 0, 0);
  }
}

// S = Q K^T over one stage: n = TK keys
template <int TK>
__device__ __forceinline__ void score_mma(float (&sc)[TK / 2], uint64_t da, uint64_t db,
                                          int scale_d) {
  if constexpr (TK == 128)
    wgmma_m64n128k16(sc, da, db, scale_d);
  else
    wgmma_m64n64k16(sc, da, db, scale_d);
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, FaArgs a) {
  using TL = Tiles<HD>;
  constexpr int TK = TL::TK, Q_BYTES = TL::Q_BYTES, KV_BYTES = TL::KV_BYTES;
  constexpr int NJ = TK / 8, NH = HD / 128;  // 8-key column groups of S; 128-column parts of O
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (saddr(smem_raw) & 1023u)) & 1023u;
  uint8_t* qsm = smem_raw + pad;            // NC x Q (one per consumer warpgroup)
  uint8_t* ring = qsm + TL::NC * Q_BYTES;   // STAGES x (K tile, V tile)
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * KV_BYTES);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;
  int* qs_s = reinterpret_cast<int*>(empty + STAGES);  // 128 query slots, then positions
  int* qp_s = qs_s + 2 * TQ;
  int* red = qp_s + 2 * TQ;  // each warp's least and largest slot and least position

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_pairs = ((a.T + TQ - 1) / TQ) * a.G;
  int tile[2], head[2];
  bool present[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int p = blockIdx.x * TL::NC + w;
    present[w] = w < TL::NC && p < n_pairs;
    tile[w] = p / a.G;
    head[w] = hk * a.G + p % a.G;
  }
  const int vf = a.valid_from[b];
  if (tid < 2 * TQ) {
    const int w = tid / TQ, t = (w ? tile[1] : tile[0]) * TQ + tid % TQ;
    const bool in = (w ? present[1] : present[0]) && t < a.T;
    const int qs = in ? a.qslots[b * a.T + t] : -1;
    const int qp = in ? a.qpos[b * a.T + t] : 0;
    qs_s[tid] = qs;
    qp_s[tid] = qp;
    const int wl = __reduce_min_sync(0xffffffffu, in ? qs : 0x7fffffff);
    const int wh = __reduce_max_sync(0xffffffffu, qs);
    const int wp = __reduce_min_sync(0xffffffffu, in ? qp : 0x7fffffff);
    if (tid % 32 == 0) {
      red[tid / 32] = wl;
      red[4 + tid / 32] = wh;
      red[8 + tid / 32] = wp;
    }
  }
  __syncthreads();
  // rows of pair slot w are warps 2w and 2w + 1 of the first warpgroup
  const int lo[2] = {min(red[0], red[1]), min(red[2], red[3])};
  const int hi[2] = {max(red[4], red[5]), max(red[6], red[7])};
  const int max_q = max(hi[0], hi[1]);  // an absent pair's rows hold slot -1
  // a ring's window in positions, and the first position any row sees
  const int wr = a.ring > 0 ? (a.window > 0 ? min(a.window, a.ring) : a.ring) : 0;
  // a chunked block: no key before its least query position's chunk
  const int p_min = min(min(red[8], red[9]), min(red[10], red[11]));
  const int s_first =
      a.ring > 0 ? max(vf, min(lo[0], lo[1]) - wr + 1)
                 : max(vf, a.chunked && p_min != 0x7fffffff
                               ? vf + floordiv(p_min, a.window) * a.window : 0);
  const int s_begin = (s_first / TK) * TK;
  const int s_end = a.ring > 0 ? max_q + 1 : min(a.S, max_q + 1);
  __nv_bfloat16* ob = a.o + b * a.o_sb;
  if (max_q < vf || s_end <= s_begin) {  // no row of the block sees a key
    for (int w = 0; w < 2; ++w)
      if (present[w]) store_zero_rows<HD>(a, ob, tile[w], head[w]);
    return;
  }
  const int n_it = (s_end - s_begin + TK - 1) / TK;

  if (tid == 0) {
    mbar_init(saddr(qbar), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(saddr(kfull + s), 1);
      mbar_init(saddr(vfull + s), 1);
      mbar_init(saddr(empty + s), TL::NC);  // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ------------------------------------------------------------ producer
    if constexpr (TL::NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(40));
    if (tid == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      const uint32_t qb = saddr(qbar);
      mbar_expect_tx(qb, (present[1] ? 2 : 1) * Q_BYTES);
      for (int w = 0; w < 2; ++w)
        if (present[w])
          for (int h = 0; h < HD / 64; ++h)
            tma_4d(saddr(qsm + w * Q_BYTES + h * TL::Q_ATOM), &qmap, qb, h * 64,
                   tile[w] * TQ, head[w], b);
#pragma unroll 1
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, s0 = s_begin + it * TK;
        mbar_wait(saddr(empty + s), ((it / STAGES) & 1) ^ 1);  // tile it - STAGES consumed
        const uint32_t kd = saddr(ring + s * 2 * KV_BYTES), vd = kd + KV_BYTES;
        // a ring's tile: 64-row boxes, each from its own ring slot
        const int nbox = a.ring > 0 ? TK / 64 : 1;
        mbar_expect_tx(saddr(kfull + s), KV_BYTES);
        for (int h = 0; h < HD / 64; ++h)
          for (int x = 0; x < nbox; ++x)
            tma_4d(kd + h * TL::KV_ATOM + x * 64 * 128, &kmap, saddr(kfull + s), h * 64,
                   a.ring > 0 ? (s0 + 64 * x) % a.ring : s0, hk, b);
        mbar_expect_tx(saddr(vfull + s), KV_BYTES);
        for (int h = 0; h < HD / 64; ++h)
          for (int x = 0; x < nbox; ++x)
            tma_4d(vd + h * TL::KV_ATOM + x * 64 * 128, &vmap, saddr(vfull + s), h * 64,
                   a.ring > 0 ? (s0 + 64 * x) % a.ring : s0, hk, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  if constexpr (TL::NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(232));
  const int cw = tid / 128 - 1, tw = tid % 128, lane = tw % 32;
  const int r0 = (tw / 32) * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int q0 = qs_s[cw * TQ + r0], q1 = qs_s[cw * TQ + r0 + 8];
  const int p0 = qp_s[cw * TQ + r0], p1 = qp_s[cw * TQ + r0 + 8];
  const bool mine = cw ? present[1] : present[0];
  const int my_lo = cw ? lo[1] : lo[0], my_hi = cw ? hi[1] : hi[0];
  const int my_tile = cw ? tile[1] : tile[0], my_head = cw ? head[1] : head[0];
  const int* kvp = a.kvpos + (long long)b * a.S;
  const uint32_t qa = saddr(qsm + cw * Q_BYTES), ring_a = saddr(ring);
  // ALiBi: the head's slope in log2 units; key k's term is al * (k + ab)
  const float al = a.slopes != nullptr && mine ? __ldg(a.slopes + my_head) * LOG2E : 0.f;
  const int ab0 = -vf - p0, ab1 = -vf - p1;
  // each row's least visible key position under a window: its chunk's
  // start, or p - window + 1 for a sliding window
  const int c0 = a.chunked ? floordiv(p0, a.window) * a.window : p0 - a.window + 1;
  const int c1 = a.chunked ? floordiv(p1, a.window) * a.window : p1 - a.window + 1;

  float o[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[h][i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sums
  mbar_wait(saddr(qbar), 0);

#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES, s0 = s_begin + it * TK;
    const uint32_t ph = (it / STAGES) & 1;
    const uint32_t ka = ring_a + s * 2 * KV_BYTES, va = ka + KV_BYTES;
    mbar_wait(saddr(kfull + s), ph);
    // a ring tile wholly before every row's window is skipped too
    if (mine && s0 <= my_hi && (a.ring == 0 || s0 + TK - 1 > my_lo - wr)) {
      float sc[TK / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k)
        score_mma<TK>(sc, sw128_desc(qa + (k / 4) * TL::Q_ATOM + (k % 4) * 32),
                      sw128_desc(ka + (k / 4) * TL::KV_ATOM + (k % 4) * 32), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // scores in the log2 domain; masks only where the tile straddles one
      if (a.softcap_in != 0.f) {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) sc[i] = tanhf(sc[i] * a.softcap_in) * a.softcap_out;
      } else {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) sc[i] *= a.scale_log2;
        if (a.slopes != nullptr) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = s0 + 8 * j + 2 * (lane % 4) + e;
              sc[4 * j + e] = fmaf(al, (float)(key + ab0), sc[4 * j + e]);
              sc[4 * j + 2 + e] = fmaf(al, (float)(key + ab1), sc[4 * j + 2 + e]);
            }
          }
        }
      }
      const bool visible =
          s0 >= vf && s0 + TK - 1 <= my_lo &&
          (a.ring > 0 ? s0 > my_hi - wr : s0 + TK <= a.S && a.window == 0);
      if (!visible && a.ring > 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = s0 + 8 * j + 2 * (lane % 4) + e;  // a position
            if (!(key >= vf && key <= q0 && key > q0 - wr)) sc[4 * j + e] = NEG;
            if (!(key >= vf && key <= q1 && key > q1 - wr)) sc[4 * j + 2 + e] = NEG;
          }
        }
      } else if (!visible) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = s0 + 8 * j + 2 * (lane % 4) + e;
            bool ok0 = key >= vf && key <= q0 && key < a.S;
            bool ok1 = key >= vf && key <= q1 && key < a.S;
            if (a.window && key < a.S) {
              const int kp = __ldg(kvp + key);
              ok0 = ok0 && kp >= c0;
              ok1 = ok1 && kp >= c1;
            }
            if (!ok0) sc[4 * j + e] = NEG;
            if (!ok1) sc[4 * j + 2 + e] = NEG;
          }
        }
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
      // a row with no visible key so far keeps p = 0 (its max is still NEG)
      const bool dead0 = mn0 == NEG, dead1 = mn1 == NEG;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pr[TK / 4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x0 = dead0 ? 0.f : ex2(sc[4 * j] - mn0);
        const float x1 = dead0 ? 0.f : ex2(sc[4 * j + 1] - mn0);
        const float x2 = dead1 ? 0.f : ex2(sc[4 * j + 2] - mn1);
        const float x3 = dead1 ? 0.f : ex2(sc[4 * j + 3] - mn1);
        sum0 += x0 + x1;
        sum1 += x2 + x3;
        pr[2 * j] = pack_bf16(x0, x1);
        pr[2 * j + 1] = pack_bf16(x2, x3);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[h][4 * j] *= al0;
          o[h][4 * j + 1] *= al0;
          o[h][4 * j + 2] *= al1;
          o[h][4 * j + 3] *= al1;
        }

      mbar_wait(saddr(vfull + s), ph);
#pragma unroll
      for (int i = 0; i < TK / 4; ++i) asm volatile("" : "+r"(pr[i])::"memory");
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_acc(o[h]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int k = 0; k < TK / 16; ++k) {
          const uint32_t frag[4] = {pr[4 * k], pr[4 * k + 1], pr[4 * k + 2], pr[4 * k + 3]};
          // columns 128h..128h+127 of V: atoms 2h and 2h + 1; a k16 step is 16 rows
          wgmma_m64n128k16_rs(o[h], frag,
                              sw128_mn_desc(va + 2 * h * TL::KV_ATOM + k * 16 * 128, TL::KV_ATOM));
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) fence_acc(o[h]);
    } else {
      mbar_wait(saddr(vfull + s), ph);
    }
    if (tw == 0) mbar_arrive(saddr(empty + s));
  }
  if (!mine) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  // O leaves through this warpgroup's Q tile (its last read is done), so
  // that rows go out as whole lines of RB bytes. 16-byte chunk c of row r
  // sits at c ^ (r & 7): the quads of a warp write 32 distinct banks.
  constexpr int RB = HD * 2;
  uint8_t* ot = qsm + cw * Q_BYTES;
  const int sw = r0 & 7;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint8_t* p = ot + r0 * RB + (((16 * h + j) ^ sw) << 4) + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[h][4 * j] * inv0, o[h][4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(p + 8 * RB) =
          pack_bf16(o[h][4 * j + 2] * inv1, o[h][4 * j + 3] * inv1);
    }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");  // this warpgroup only
  __nv_bfloat16* orows = ob + (long long)(my_tile * TQ) * a.o_st + my_head * a.o_sh;
#pragma unroll
  for (int i = tw; i < TQ * HD / 8; i += 128) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    if (my_tile * TQ + r >= a.T) break;  // rows past T: none
    *reinterpret_cast<uint4*>(orows + r * a.o_st + c * 8) =
        *reinterpret_cast<const uint4*>(ot + r * RB + ((c ^ (r & 7)) << 4));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const FaArgs& a, int B, int H, int Hkv,
           long long q_sb, long long q_sh, long long q_st, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss, cudaStream_t stream) {
  using TL = Tiles<HD>;
  // 4-D maps, innermost first: (D, T, H, B) for q, (D, S, Hkv, B) for k and v
  const CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long qd[4] = {HD, a.T, H, B}, qs[3] = {q_st * 2, q_sh * 2, q_sb * 2};
  const long long kd[4] = {HD, a.S, Hkv, B}, ks[3] = {k_ss * 2, k_sh * 2, k_sb * 2},
                  vs[3] = {v_ss * 2, v_sh * 2, v_sb * 2};
  // a ring's K/V come in 64-row boxes (flash_kernel's producer)
  const int qbox[4] = {64, TQ, 1, 1}, kbox[4] = {64, a.ring > 0 ? 64 : TL::TK, 1, 1};
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, BF16, q, 4, qd, qs, qbox, SW);
  err = err ? err : make_map(&kmap, BF16, k, 4, kd, ks, kbox, SW);
  err = err ? err : make_map(&vmap, BF16, v, 4, kd, vs, kbox, SW);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_pairs = ((a.T + TQ - 1) / TQ) * a.G;
  dim3 grid((n_pairs + TL::NC - 1) / TL::NC, Hkv, B);
  flash_kernel<HD><<<grid, TL::THREADS, TL::SMEM, stream>>>(qmap, kmap, vmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpq_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* qslots,
    const void* kvpos, const void* qpos, const void* valid_from, int B, int H,
    int Hkv, int T, int S, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_st, float scale,
    float softcap, int window, int chunked, int ring, const void* slopes, void* stream) {
  cudaGetLastError();
  // T: any count of rows (the last query tile may be partial); S and a ring
  // multiples of 64
  if ((D != 128 && D != 256) || T < 1 || S % 64 || Hkv < 1 || H % Hkv ||
      (o_sb | o_sh | o_st) % 8 || ring < 0 || (ring > 0 && ring != S) ||
      (slopes != nullptr && softcap != 0.f) || (chunked && (ring > 0 || window <= 0)))
    return (int)cudaErrorInvalidValue;
  FaArgs a;
  a.qslots = reinterpret_cast<const int*>(qslots);
  a.kvpos = reinterpret_cast<const int*>(kvpos);
  a.qpos = reinterpret_cast<const int*>(qpos);
  a.valid_from = reinterpret_cast<const int*>(valid_from);
  a.o = reinterpret_cast<__nv_bfloat16*>(o);
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_st = o_st;
  a.T = T; a.S = S; a.G = H / Hkv;
  a.scale_log2 = scale * LOG2E;
  a.softcap_in = softcap != 0.f ? scale / softcap : 0.f;
  a.softcap_out = softcap * LOG2E;
  a.window = window;
  a.chunked = chunked;
  a.ring = ring;
  a.slopes = reinterpret_cast<const float*>(slopes);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return D == 128 ? launch<128>(q, k, v, a, B, H, Hkv, q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb,
                                v_sh, v_ss, st)
                  : launch<256>(q, k, v, a, B, H, Hkv, q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb,
                                v_sh, v_ss, st);
}
