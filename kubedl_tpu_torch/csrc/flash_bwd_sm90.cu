// FlashAttention-2 backward on Hopper's tensor cores (sm_90a): dQ (K2) and
// dK/dV (K3) for bf16 and f16 at head dims 64, 128 and 256 (Gemma).
//
// Replaces the TPU kernels kubedl_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (launched by _flash_backward through pl.pallas_call) on
// the training path, and computes what flash_bwd.cu computes (that file
// stays the route for float32 and the other head dims):
//   p = exp((q . k) * scale masked to -1e30 - lse), with K1's lse;
//   ds = p * (dO . v - delta), delta = rowsum(dO * O) from PyTorch;
//   dq = scale * sum ds . k;  dv = sum p^T . dO;  dk = scale * sum ds^T . q,
// dk/dv summed over the GQA group's query heads inside one block: no
// atomics, deterministic. Masks: causal top-left with global offsets,
// sliding window, segment ids, ragged sq/sk (columns past sk get p = 0,
// rows past sq add nothing).
//
// Bound on an H100 SXM at the training shape (b = 4, s = 2048, nh = 32,
// nkv = 8, hd = 128, causal): K2 does 6*hd and K3 8*hd operations per kept
// (row, key) pair, 0.21 and 0.28 ms at 989 TFLOP/s, against ~0.06 ms of
// bytes: both are bound by tensor-core operations. flash_bwd.cu runs them
// on the f32 CUDA cores (67 TFLOP/s peak) from f32 tiles that every thread
// stages. Here:
//   * every product is a wgmma on bf16/f16 operands with f32 sums;
//   * one producer warp streams tiles with TMA (128-byte swizzle, zero fill
//     past the tensor's end) into a 2-stage ring under mbarriers, while two
//     consumer warpgroups compute; setmaxnreg moves the producer's
//     registers to the consumers;
//   * the products are arranged so nothing goes back to shared memory:
//     K3 computes S^T = K.Q^T and dP^T = V.dO^T (64 k rows per warpgroup),
//     so P^T and dS^T are already the A operand of dV += P^T.dO and
//     dK += dS^T.Q, taken from registers, with dO and Q read MN-major;
//     K2 computes S = Q.K^T, dP = dO.V^T and dQ += dS.K the same way;
//   * P and dS are rounded to the operand type before the second products
//     (as SDPA's backward does); the sums stay f32 in registers;
//   * the element-wise pass is as short as it can be: lse comes
//     pre-multiplied by log2 e, exp is one ex2.approx, and K2 computes P
//     while dP's products still run (in K3 the same split gained nothing
//     measurable, so K3 waits once);
//   * causal load balance: blocks are numbered heaviest first (K3's first
//     k tiles see the most q tiles, K2's last q tiles the most k tiles), so
//     the hardware's in-order block dispatch packs the light tiles into the
//     last wave. A persistent grid would need a work queue; this needs none.
// The producer warp's 32 lanes copy each tile's lse and delta rows into
// shared memory before its TMA transaction is announced: a row starts at
// element (b*nh + h)*sq + q0, which TMA cannot take unless it falls on 16
// bytes (sq a multiple of 4).
//
// K3 at head dim 256 (flash_dkv256_kernel) cannot keep the hd-128 layout:
//   * registers: a warpgroup's 64 x 256 f32 sum is 128 registers a
//     thread, so dK and dV of its 64 k rows would be 256. The block takes
//     64 k rows, and both consumer warpgroups own all of them: warpgroup 0
//     sums dV, warpgroup 1 dK, each computing S^T itself (warpgroup 1 also
//     dP^T), so the tensor cores do 5 products of 64 x 64 x 256 per q tile
//     where 4 would do. A thread holds its 128-register sum, S^T and dP^T
//     (32 each) and the packed A operand (16): 208 before addresses, of
//     the 240 setmaxnreg gives (the producer warpgroup keeps 24);
//   * shared memory: K and V stay resident (2 x 32 KB) beside 2 stages of
//     Q and dO (2 x 2 x 32 KB) and lse/delta rows: 193 KB with barriers
//     and alignment;
//   * the products: S^T and dP^T are m64n64k16 from shared memory, dV +=
//     P^T.dO and dK += dS^T.Q one m64n256k16 per 16 q rows with the A
//     operand from registers;
//   * occupancy: the grid b*nkv x sk/64 is 64 blocks at Gemma-2B's
//     training shape (b = 2, nkv = 1, s = 2048), under half of the 132 SMs,
//     each looping over 8 heads x up to 32 q tiles. The wrapper therefore
//     splits the group's query heads over `splits` blocks (a power of two
//     dividing nh / nkv). One split writes dK/dV directly; several write
//     their f32 sums to a workspace of splits x 2 x b x sk x nkv x 256 x 4
//     B (4 splits at that shape: 2 x 4 x 2 x 2048 x 256 x 4 B = 33.5 MB),
//     and dkv_reduce_kernel adds them in split order and rounds once. No
//     atomics: two calls give the same bits.
// Bound at that shape: 8 * 256 operations per kept pair, 0.0695 ms at 989
// TFLOP/s; the duplicated S^T adds a quarter.
//
// K2 at head dim 256 (flash_dq256_kernel) cannot keep the hd-128 layout
// either, where each warpgroup holds the whole dQ row of its 64 q rows:
//   * registers: that dQ is 128 f32 registers a thread at hd 256, beside S
//     and dP (32 each) and the packed dS (16): ~208 before addresses;
//   * shared memory: Q and dO at 128 rows are 2 x 64 KB, and two stages
//     of 64-key K and V tiles 2 x 64 KB, 256 KB against the 227 KB a
//     block may have.
// So the block takes 64 q rows, and both consumer warpgroups own all of
// them. Per K/V tile warpgroup 0 computes S = Q.K^T and warpgroup 1 dP =
// dO.V^T (each m64n64k16 from shared memory over k = 256). They swap the
// two f32 tiles through shared memory: both hold the wgmma fragment
// layout, so thread t reads what thread t of the other wrote, and two
// named barriers order the writes and reads. Each then forms P and dS in
// registers, and warpgroup w sums dQ[:, 128w : 128w + 128] += dS.K, one
// m64n128k16 per 16 keys with K's descriptor moved by two 64-column
// boxes. No product is done twice: three 64 x 64 x 256 products per tile,
// 1.5 per warpgroup.
//   * registers: the dQ half (64), S or dP and the other's tile (32
//     each), dS packed (16): ~144 before addresses, of the 240 setmaxnreg
//     gives (the producer warpgroup keeps 24);
//   * shared memory: Q and dO 2 x 32 KB, two stages of K and V 2 x 64 KB,
//     the swap 2 x 16 KB, lse and delta 512 B: 225 KB, 230,952 bytes
//     with the barriers and the 1 KB alignment, under the 232,448 a block
//     may have;
//   * grid: b*nh x sq/64, 512 blocks at Gemma-2B's training shape
//     (b = 2, nh = 8, s = 2048) on 132 SMs, heaviest q tiles first.
// Bound at that shape: 6 * 256 operations per kept pair, 0.0521 ms at 989
// TFLOP/s. Each 64-row tile reads its K/V tiles (64 KB per 64 keys) from
// L2 twice as often per q row as the hd-128 kernel does.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NT = 384;                 // 2 consumer warpgroups + producer
constexpr int STAGES = 2;

struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const float* lse;     // [b*nh, sq]
  const float* delta;   // [b*nh, sq]
  const int32_t* seg;   // [b, sk] keys' segments, or null
  const int32_t* seg_q; // [b, sq] query rows' segments (with seg)
  void* dq;             // [b, sq, nh, hd] contiguous
  void* dk;             // [b, sk, nkv, hd] contiguous
  void* dv;
  int sq, sk, nh, nkv;
  int causal, window, has_off, q_off, k_off;
  float scale;
  float* ws;            // K3 at hd 256, splits > 1: f32 partials
  int splits;           // K3 at hd 256: blocks per GQA group
};

// lanes of the producer warp copy n values of lse (times log2 e, for exp2)
// and delta, rows past sq as 0; the lane that then arrives on the tile's
// barrier releases them. A fully masked row (offsets only) has lse =
// -1e30 and must get p = 1 per key, as the reference: -1e30 * log2 e here
// and in the consumers' masked score round alike, and __fmul_rn keeps
// both out of an FMA that would not.
__device__ __forceinline__ void copy_rows(const Params& p, int bh, int q0,
                                          int n, float* lse2, float* dlt,
                                          int lane) {
  const int64_t at = static_cast<int64_t>(bh) * p.sq;
  for (int i = lane; i < n; i += 32) {
    const bool in = q0 + i < p.sq;
    lse2[i] = in ? __fmul_rn(p.lse[at + q0 + i], LOG2E) : 0.f;
    dlt[i] = in ? p.delta[at + q0 + i] : 0.f;
  }
  __syncwarp();
}

template <int HD> struct DkvSmem {
  static constexpr int BK = HD == 256 ? 64 : 128, BQ = 64;
  static constexpr int KV = BK * HD * 2, Q = BQ * HD * 2;
  static constexpr int K = 0, V = KV, QS = 2 * KV, OS = QS + STAGES * Q;
  static constexpr int LSE = OS + STAGES * Q, DLT = LSE + STAGES * BQ * 4;
  static constexpr int BAR = DLT + STAGES * BQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// K2's: Q and dO resident, STAGES of K and V, at head dim 256 the two f32
// tiles the warpgroups swap (XS: S, then dP), then lse/delta rows
template <int HD> struct DqSmem {
  static constexpr int BQ = HD == 256 ? 64 : 128, BK = 64;
  static constexpr int Q = BQ * HD * 2, KV = BK * HD * 2;
  static constexpr int X = HD == 256 ? BQ * BK * 4 : 0;
  static constexpr int QS = 0, OS = Q, KS = 2 * Q, VS = KS + STAGES * KV;
  static constexpr int XS = VS + STAGES * KV, LSE = XS + 2 * X;
  static constexpr int DLT = LSE + BQ * 4, BAR = DLT + BQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// K3's shared pieces: both kernels take one block per (b*nkv, k tile) -
// the hd-256 one also per split of the GQA group - and stream, for each
// of heads [h0, h0 + n_iter / span), the q tiles [lower, lower + span)
// that can see the k tile (all of them with global offsets).
template <int BQ, int BK>
__device__ __forceinline__ void dkv_q_tiles(const Params& p, int k0,
                                            int* lower, int* span) {
  const int num_qb = (p.sq + BQ - 1) / BQ;
  int lo = 0, up = num_qb;
  if (p.causal && !p.has_off) {
    lo = k0 / BQ;
    if (p.window > 0) up = min(num_qb, (k0 + BK - 1 + p.window - 1) / BQ + 1);
  }
  *lower = lo;
  *span = max(0, up - lo);
}

// the barriers at bar: the resident tiles (K3's K/V, K2's Q/dO) loaded
// once, then each stage's full/empty
__device__ __forceinline__ void init_barriers(uint64_t* bar) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar + 1 + s, 1);
      sm90::mbar_init(bar + 1 + STAGES + s, 8);   // one per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// the producer warp: the k tile's K and V once, then (Q, dO, lse, delta)
// of every streamed q tile into the stage ring
template <class L, int HD>
__device__ __forceinline__ void dkv_produce(const Params& p, uint8_t* sm,
                                            int bi, int kvh, int k0, int h0,
                                            int lower, int span, int n_iter,
                                            int lane) {
  constexpr int BK = L::BK, BQ = L::BQ, NB = HD / 64;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  if (lane == 0) {
    sm90::mbar_expect_tx(kv_full, 2 * L::KV);
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load_4d(sm + L::K + nb * BK * 128, &p.tm_k, kv_full, nb * 64,
                        k0, kvh, bi);
      sm90::tma_load_4d(sm + L::V + nb * BK * 128, &p.tm_v, kv_full, nb * 64,
                        k0, kvh, bi);
    }
  }
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % STAGES;
    sm90::mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
    const int h = h0 + it / span;
    const int q0 = (lower + it % span) * BQ;
    copy_rows(p, bi * p.nh + h, q0, BQ,
              reinterpret_cast<float*>(sm + L::LSE) + st * BQ,
              reinterpret_cast<float*>(sm + L::DLT) + st * BQ, lane);
    if (lane == 0) {
      sm90::mbar_expect_tx(full + st, 2 * L::Q);
      for (int nb = 0; nb < NB; ++nb) {
        sm90::tma_load_4d(sm + L::QS + st * L::Q + nb * BQ * 128, &p.tm_q,
                          full + st, nb * 64, q0, h, bi);
        sm90::tma_load_4d(sm + L::OS + st * L::Q + nb * BQ * 128, &p.tm_o,
                          full + st, nb * 64, q0, h, bi);
      }
    }
  }
}

// segment ids of a consumer thread's two k rows kr and kr + 8 (-1 past sk)
__device__ __forceinline__ void seg_rows(const Params& p, int bi, int kr,
                                         int (&seg_k)[2]) {
  seg_k[0] = seg_k[1] = 0;
  if (p.seg != nullptr)
    for (int i = 0; i < 2; ++i)
      seg_k[i] = kr + 8 * i < p.sk ? p.seg[bi * p.sk + kr + 8 * i] : -1;
}

// P^T of one (key, q row) element from its S^T score: exp2 of the scaled
// score less lse (log2 units), the reference's -1e30 for a masked pair,
// and 0 past sq or sk. A tile that needs no mask skips the tests;
// otherwise the select is branch-free, so the warp stays converged for
// the next wgmma.
__device__ __forceinline__ float p_elem(const Params& p, bool plain, float s,
                                        float l2, int qr, int kg, int seg_k,
                                        int bi, float scale_l2,
                                        float neg_l2) {
  if (plain) return sm90::exp2_approx(fmaf(s, scale_l2, -l2));
  bool keep = keep_pair(p, qr, kg);
  if (p.seg != nullptr)
    keep = keep && p.seg_q[bi * p.sq + min(qr, p.sq - 1)] == seg_k;
  const float x = keep ? fmaf(s, scale_l2, -l2) : neg_l2 - l2;
  return qr < p.sq && kg < p.sk ? sm90::exp2_approx(x) : 0.f;
}

// a consumer thread's share of a 64-row dK or dV sum (rows kr and kr + 8,
// columns 8j + cq + {0, 1}) times f: to `out` in the operand type, or
// with `part` as f32 to the split's slice of the workspace
template <bool F16, int HD>
__device__ __forceinline__ void dkv_store(const Params& p,
                                          const float (&acc)[HD / 2], float f,
                                          void* out, float* part, int bi,
                                          int kvh, int kr, int cq) {
  using T = typename Elem<F16>::T;
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kg = kr + 8 * i;
    if (kg >= p.sk) continue;
    const int64_t at = ((static_cast<int64_t>(bi) * p.sk + kg) * p.nkv + kvh) * HD;
    #pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + cq;
      const float x = acc[4 * j + 2 * i] * f, y = acc[4 * j + 2 * i + 1] * f;
      if (part == nullptr)
        *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + at + d) =
            sm90::pack2<F16>(x, y);
      else
        *reinterpret_cast<float2*>(part + at + d) = make_float2(x, y);
    }
  }
}

// K3: one block per (b*nkv, 128-row k tile), heaviest k tiles first. Each
// consumer warpgroup owns 64 k rows; the producer streams (Q, dO, lse,
// delta) of every q tile that sees the k tile, for each of the group's
// query heads.
template <bool F16, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_kernel(const __grid_constant__ Params p) {
  using L = DkvSmem<HD>;
  constexpr int BK = L::BK, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const float* s_lse = reinterpret_cast<const float*>(sm + L::LSE);
  const float* s_dlt = reinterpret_cast<const float*>(sm + L::DLT);

  const int bkv = blockIdx.x;
  const int bi = bkv / p.nkv, kvh = bkv % p.nkv, reps = p.nh / p.nkv;
  const int k0 = blockIdx.y * BK;
  int lower, span;
  dkv_q_tiles<BQ, BK>(p, k0, &lower, &span);
  const int n_iter = reps * span;
  init_barriers(kv_full);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8)               // the producer warp
      dkv_produce<L, HD>(p, sm, bi, kvh, k0, kvh * reps, lower, span, n_iter,
                         threadIdx.x % 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my k rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);           // my columns: 8j + cq + {0, 1}
    const int kw0 = k0 + 64 * wg;            // this warpgroup's first k row
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);   // see copy_rows
    int seg_k[2];
    seg_rows(p, bi, kw0 + r0, seg_k);
    float dk[HD / 2], dv[HD / 2];
    #pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_u = sm90::smem_u32(sm + L::K) + wg * 64 * 128;
    const uint32_t v_u = sm90::smem_u32(sm + L::V) + wg * 64 * 128;
    sm90::mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(full + st, (it / STAGES) & 1);
      const int q0 = (lower + it % span) * BQ;
      const uint32_t q_u = sm90::smem_u32(sm + L::QS + st * L::Q);
      const uint32_t o_u = sm90::smem_u32(sm + L::OS + st * L::Q);

      // S^T = K . Q^T and dP^T = V . dO^T, [64 k rows x 64 q columns]
      float s[32], dp[32];
      __syncwarp();
      sm90::wgmma_fence();
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BK * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BQ * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(s, sm90::desc_sw128(k_u + off_a, 16, 1024),
                                sm90::desc_sw128(q_u + off_b, 16, 1024), k);
      }
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BK * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BQ * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(dp, sm90::desc_sw128(v_u + off_a, 16, 1024),
                                sm90::desc_sw128(o_u + off_b, 16, 1024), k);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // P^T and dS^T in registers; lse and delta run along the columns
      const float* lse2 = s_lse + st * BQ;
      const float* dlt = s_dlt + st * BQ;
      const bool plain = tile_unmasked(p, q0, BQ, kw0, 64);
      uint32_t pa[16], da[16];
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        float pv[4], dsv[4];
        #pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = 8 * j + cq + cc;
          const float l2 = lse2[c], dl = dlt[c];
          #pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + cc, i = 4 * j + e;
            pv[e] = p_elem(p, plain, s[i], l2, q0 + c, kw0 + r0 + 8 * half,
                           seg_k[half], bi, scale_l2, neg_l2);
            dsv[e] = pv[e] * (dp[i] - dl);
          }
        }
        pa[2 * j] = sm90::pack2<F16>(pv[0], pv[1]);
        pa[2 * j + 1] = sm90::pack2<F16>(pv[2], pv[3]);
        da[2 * j] = sm90::pack2<F16>(dsv[0], dsv[1]);
        da[2 * j + 1] = sm90::pack2<F16>(dsv[2], dsv[3]);
      }

      // dV += P^T . dO and dK += dS^T . Q over the tile's 64 q rows
      __syncwarp();
      sm90::wgmma_fence();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_tn<F16, HD>(
            dv, pa + 4 * kk, sm90::desc_sw128(o_u + kk * 2048, BQ * 128, 1024), 1);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_tn<F16, HD>(
            dk, da + 4 * kk, sm90::desc_sw128(q_u + kk * 2048, BQ * 128, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::fence_regs(pa);
      sm90::fence_regs(da);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }

    dkv_store<F16, HD>(p, dk, p.scale, p.dk, nullptr, bi, kvh, kw0 + r0, cq);
    dkv_store<F16, HD>(p, dv, 1.f, p.dv, nullptr, bi, kvh, kw0 + r0, cq);
  }
}

// K3 at head dim 256: one block per (b*nkv, split, 64-row k tile),
// heaviest k tiles first. A 64 x 256 f32 sum is 128 registers a thread,
// so a warpgroup holds dK or dV, not both: both consumer warpgroups own
// the tile's 64 k rows, warpgroup 0 sums dV += P^T.dO and warpgroup 1 dK
// += dS^T.Q, each computing S^T = K.Q^T itself (warpgroup 1 also dP^T =
// V.dO^T). The split takes reps / splits of the group's query heads; with
// more than one the block writes its f32 sums to the workspace and
// dkv_reduce_kernel adds them in split order.
template <bool F16>
__global__ void __launch_bounds__(NT, 1)
flash_dkv256_kernel(const __grid_constant__ Params p) {
  constexpr int HD = 256;
  using L = DkvSmem<HD>;
  constexpr int BK = L::BK, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  const float* s_lse = reinterpret_cast<const float*>(sm + L::LSE);
  const float* s_dlt = reinterpret_cast<const float*>(sm + L::DLT);

  const int bkv = blockIdx.x / p.splits, sp = blockIdx.x % p.splits;
  const int bi = bkv / p.nkv, kvh = bkv % p.nkv;
  const int hps = p.nh / p.nkv / p.splits;   // query heads of this split
  const int k0 = blockIdx.y * BK;
  int lower, span;
  dkv_q_tiles<BQ, BK>(p, k0, &lower, &span);
  const int n_iter = hps * span;
  init_barriers(kv_full);

  // the warpgroup index read from lane 0: uniform to the compiler, which
  // then keeps the wgmma pipeline in the branch on it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 == 8)               // the producer warp
      dkv_produce<L, HD>(p, sm, bi, kvh, k0, kvh * (p.nh / p.nkv) + sp * hps,
                         lower, span, n_iter, threadIdx.x % 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my k rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);           // my columns: 8j + cq + {0, 1}
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);   // see copy_rows
    int seg_k[2];
    seg_rows(p, bi, k0 + r0, seg_k);
    float acc[HD / 2];                       // dV (warpgroup 0) or dK
    #pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t k_u = sm90::smem_u32(sm + L::K);
    const uint32_t v_u = sm90::smem_u32(sm + L::V);
    sm90::mbar_wait(kv_full, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(full + st, (it / STAGES) & 1);
      const int q0 = (lower + it % span) * BQ;
      const uint32_t q_u = sm90::smem_u32(sm + L::QS + st * L::Q);
      const uint32_t o_u = sm90::smem_u32(sm + L::OS + st * L::Q);

      // S^T = K . Q^T, and on warpgroup 1 dP^T = V . dO^T, [64 k rows x
      // 64 q columns]
      float s[32], dp[32];
      __syncwarp();
      sm90::wgmma_fence();
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BK * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BQ * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(s, sm90::desc_sw128(k_u + off_a, 16, 1024),
                                sm90::desc_sw128(q_u + off_b, 16, 1024), k);
      }
      if (wg == 1) {
        #pragma unroll
        for (int k = 0; k < HD / 16; ++k) {
          const uint32_t off_a = (k / 4) * BK * 128 + (k % 4) * 32;
          const uint32_t off_b = (k / 4) * BQ * 128 + (k % 4) * 32;
          sm90::wgmma_ss_n64<F16>(dp, sm90::desc_sw128(v_u + off_a, 16, 1024),
                                  sm90::desc_sw128(o_u + off_b, 16, 1024), k);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // P^T (warpgroup 0) or dS^T (warpgroup 1) as the A operand; lse and
      // delta run along the columns
      const float* lse2 = s_lse + st * BQ;
      const float* dlt = s_dlt + st * BQ;
      const bool plain = tile_unmasked(p, q0, BQ, k0, BK);
      uint32_t fa[16];
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        float f[4];
        #pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = 8 * j + cq + cc;
          const float l2 = lse2[c], dl = dlt[c];
          #pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + cc, i = 4 * j + e;
            const float pv = p_elem(p, plain, s[i], l2, q0 + c,
                                    k0 + r0 + 8 * half, seg_k[half], bi,
                                    scale_l2, neg_l2);
            f[e] = wg == 0 ? pv : pv * (dp[i] - dl);
          }
        }
        fa[2 * j] = sm90::pack2<F16>(f[0], f[1]);
        fa[2 * j + 1] = sm90::pack2<F16>(f[2], f[3]);
      }

      // dV += P^T . dO or dK += dS^T . Q over the tile's 64 q rows: one
      // m64n256k16 per 16 rows, the B operand MN-major
      const uint32_t b_u = wg == 0 ? o_u : q_u;
      __syncwarp();
      sm90::wgmma_fence();
      sm90::fence_regs(acc);
      sm90::fence_regs(fa);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_tn<F16, HD>(
            acc, fa + 4 * kk, sm90::desc_sw128(b_u + kk * 2048, BQ * 128, 1024),
            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(fa);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }

    // dK carries the scale; one split writes the operand type, several
    // their f32 sums, [splits, 2 (dK, dV), b, sk, nkv, hd]
    const int64_t n = static_cast<int64_t>(gridDim.x / p.splits) * p.sk * HD;
    float* part = p.splits == 1
        ? nullptr : p.ws + (2 * static_cast<int64_t>(sp) + (wg == 0)) * n;
    dkv_store<F16, HD>(p, acc, wg == 0 ? 1.f : p.scale,
                       wg == 0 ? p.dv : p.dk, part, bi, kvh, k0 + r0, cq);
  }
}

// dK and dV of a split K3 launch: the splits' f32 sums added in split
// order (no atomics, so two runs agree bit for bit), rounded once to the
// operand type. n = b * sk * nkv * hd elements each, 4 per thread.
template <bool F16>
__global__ void dkv_reduce_kernel(const float* ws, void* dk, void* dv,
                                  int64_t n, int splits) {
  const int64_t i =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= 2 * n) return;
  const int which = i >= n;                  // 0: dK, 1: dV
  const int64_t at = i - which * n;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(
        ws + (2 * static_cast<int64_t>(sp) + which) * n + at);
    sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
  }
  using T = typename Elem<F16>::T;
  T* out = static_cast<T*>(which ? dv : dk) + at;
  *reinterpret_cast<uint2*>(out) = make_uint2(sm90::pack2<F16>(sum.x, sum.y),
                                              sm90::pack2<F16>(sum.z, sum.w));
}

// K2's shared pieces: both kernels take one block per (b*nh, q tile),
// heaviest q tiles first, and stream the K/V tiles [lower, lower + n_iter)
// inside the causal and window bounds (every tile with global offsets).
template <int BQ, int BK>
__device__ __forceinline__ int dq_q_tile(const Params& p, int* lower,
                                         int* n_iter) {
  const int qt = p.causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int num_kb = (p.sk + BK - 1) / BK;
  int lo = 0, up = num_kb;
  if (p.causal && !p.has_off) {
    up = min(num_kb, ((qt + 1) * BQ + BK - 1) / BK);
    if (p.window > 0) {
      const int first_col = qt * BQ - (p.window - 1);
      lo = first_col > 0 ? first_col / BK : 0;
    }
  }
  *lower = lo;
  *n_iter = max(0, up - lo);
  return qt;
}

// the producer warp: the q tile's lse and delta rows, Q and dO once, then
// every streamed K/V tile into the stage ring
template <class L, int HD>
__device__ __forceinline__ void dq_produce(const Params& p, uint8_t* sm,
                                           int bi, int h, int kvh, int q0,
                                           int lower, int n_iter, int lane) {
  constexpr int BK = L::BK, BQ = L::BQ, NB = HD / 64;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  copy_rows(p, bi * p.nh + h, q0, BQ, reinterpret_cast<float*>(sm + L::LSE),
            reinterpret_cast<float*>(sm + L::DLT), lane);
  if (lane != 0) return;
  sm90::mbar_expect_tx(q_full, 2 * L::Q);
  for (int nb = 0; nb < NB; ++nb) {
    sm90::tma_load_4d(sm + L::QS + nb * BQ * 128, &p.tm_q, q_full, nb * 64,
                      q0, h, bi);
    sm90::tma_load_4d(sm + L::OS + nb * BQ * 128, &p.tm_o, q_full, nb * 64,
                      q0, h, bi);
  }
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % STAGES;
    sm90::mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
    const int k0 = (lower + it) * BK;
    sm90::mbar_expect_tx(full + st, 2 * L::KV);
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load_4d(sm + L::KS + st * L::KV + nb * BK * 128, &p.tm_k,
                        full + st, nb * 64, k0, kvh, bi);
      sm90::tma_load_4d(sm + L::VS + st * L::KV + nb * BK * 128, &p.tm_v,
                        full + st, nb * 64, k0, kvh, bi);
    }
  }
}

// a consumer thread's lse (log2 units), delta and segment id of its two q
// rows qr0 and qr0 + 8 (r the first's index in the tile)
template <class L>
__device__ __forceinline__ void dq_rows(const Params& p, const uint8_t* sm,
                                        int bi, int qr0, int r, float (&l2)[2],
                                        float (&dlt)[2], int (&seg_q)[2]) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    l2[i] = reinterpret_cast<const float*>(sm + L::LSE)[r + 8 * i];
    dlt[i] = reinterpret_cast<const float*>(sm + L::DLT)[r + 8 * i];
    seg_q[i] = p.seg != nullptr && qr0 + 8 * i < p.sq
        ? p.seg_q[bi * p.sq + qr0 + 8 * i] : 0;
  }
}

// P of one (q row, key) element from its S score, as p_elem with rows and
// columns swapped: the row's segment is held, the key's read; keys past
// sk get p = 0 (rows past sq have dO = 0 and delta = 0, so dS = 0)
__device__ __forceinline__ float dq_p_elem(const Params& p, bool plain,
                                           float s, float l2, int qr, int kc,
                                           int seg_q, int bi, float scale_l2,
                                           float neg_l2) {
  if (plain) return sm90::exp2_approx(fmaf(s, scale_l2, -l2));
  bool keep = keep_pair(p, qr, kc);
  if (p.seg != nullptr)
    keep = keep && seg_q == p.seg[bi * p.sk + min(kc, p.sk - 1)];
  const float x = keep ? fmaf(s, scale_l2, -l2) : neg_l2 - l2;
  return kc < p.sk ? sm90::exp2_approx(x) : 0.f;
}

// a consumer thread's share of dQ's columns [c0, c0 + N) (rows qr0 and
// qr0 + 8, columns c0 + 8j + cq + {0, 1}) times the scale, in the operand
// type
template <bool F16, int N>
__device__ __forceinline__ void dq_store(const Params& p,
                                         const float (&acc)[N / 2], int bi,
                                         int h, int qr0, int c0, int cq,
                                         int hd) {
  using T = typename Elem<F16>::T;
  T* dqp = static_cast<T*>(p.dq);
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qr0 + 8 * i;
    if (qr >= p.sq) continue;
    const int64_t at =
        ((static_cast<int64_t>(bi) * p.sq + qr) * p.nh + h) * hd + c0 + cq;
    #pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqp + at + 8 * j) = sm90::pack2<F16>(
          acc[4 * j + 2 * i] * p.scale, acc[4 * j + 2 * i + 1] * p.scale);
  }
}

// K2 at head dims 64 and 128: one block per (b*nh, 128-row q tile). Q, dO,
// lse and delta stay resident; the producer streams the K/V tiles. Each
// consumer warpgroup owns 64 q rows.
template <bool F16, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_dq_kernel(const __grid_constant__ Params p) {
  using L = DqSmem<HD>;
  constexpr int BK = L::BK, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int bi = bh / p.nh, h = bh % p.nh, kvh = h / (p.nh / p.nkv);
  int lower, n_iter;
  const int q0 = dq_q_tile<BQ, BK>(p, &lower, &n_iter) * BQ;
  init_barriers(q_full);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8)               // the producer warp
      dq_produce<L, HD>(p, sm, bi, h, kvh, q0, lower, n_iter,
                        threadIdx.x % 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my q rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);
    const int qw0 = q0 + 64 * wg;
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);   // see copy_rows
    const uint32_t q_u = sm90::smem_u32(sm + L::QS) + wg * 64 * 128;
    const uint32_t o_u = sm90::smem_u32(sm + L::OS) + wg * 64 * 128;
    float dq[HD / 2];
    #pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);
    // lse and delta run along the rows: two rows per thread
    float l2[2], dlt[2];
    int seg_q[2];
    dq_rows<L>(p, sm, bi, qw0 + r0, 64 * wg + r0, l2, dlt, seg_q);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(full + st, (it / STAGES) & 1);
      const int k0 = (lower + it) * BK;
      const uint32_t k_u = sm90::smem_u32(sm + L::KS + st * L::KV);
      const uint32_t v_u = sm90::smem_u32(sm + L::VS + st * L::KV);

      // S = Q . K^T and dP = dO . V^T, [64 q rows x 64 k columns], two
      // groups so that P is computed while dP runs
      float s[32], dp[32];
      __syncwarp();
      sm90::wgmma_fence();
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BQ * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BK * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(s, sm90::desc_sw128(q_u + off_a, 16, 1024),
                                sm90::desc_sw128(k_u + off_b, 16, 1024), k);
      }
      sm90::wgmma_commit();
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BQ * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BK * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(dp, sm90::desc_sw128(o_u + off_a, 16, 1024),
                                sm90::desc_sw128(v_u + off_b, 16, 1024), k);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);

      // P in registers (over s); lse and delta run along the rows
      const bool plain = tile_unmasked(p, qw0, 64, k0, BK);
      #pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i >> 1) & 1;
        s[i] = dq_p_elem(p, plain, s[i], l2[row], qw0 + r0 + 8 * row,
                         k0 + 8 * (i / 4) + cq + (i & 1), seg_q[row], bi,
                         scale_l2, neg_l2);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t da[16];
      #pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = j & 1;
        da[j] = sm90::pack2<F16>(s[2 * j] * (dp[2 * j] - dlt[row]),
                                 s[2 * j + 1] * (dp[2 * j + 1] - dlt[row]));
      }

      // dQ += dS . K over the tile's 64 keys
      __syncwarp();
      sm90::wgmma_fence();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_tn<F16, HD>(
            dq, da + 4 * kk, sm90::desc_sw128(k_u + kk * 2048, BK * 128, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }

    dq_store<F16, HD>(p, dq, bi, h, qw0 + r0, 0, cq, HD);
  }
}

// K2 at head dim 256 (the design in the header): one block per (b*nh,
// 64-row q tile); both consumer warpgroups own all 64 rows, warpgroup 0
// computes S and warpgroup 1 dP, and warpgroup w sums dQ's columns
// [128w, 128w + 128).
template <bool F16>
__global__ void __launch_bounds__(NT, 1)
flash_dq256_kernel(const __grid_constant__ Params p) {
  constexpr int HD = 256;
  using L = DqSmem<HD>;
  constexpr int BK = L::BK, BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int bi = bh / p.nh, h = bh % p.nh, kvh = h / (p.nh / p.nkv);
  int lower, n_iter;
  const int q0 = dq_q_tile<BQ, BK>(p, &lower, &n_iter) * BQ;
  init_barriers(q_full);

  // the warpgroup index read from lane 0: uniform to the compiler, which
  // then keeps the wgmma pipeline in the branch on it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x / 32 == 8)               // the producer warp
      dq_produce<L, HD>(p, sm, bi, h, kvh, q0, lower, n_iter,
                        threadIdx.x % 32);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my q rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);   // see copy_rows
    // the A operand: Q (warpgroup 0, for S) or dO (warpgroup 1, for dP)
    const uint32_t a_u = sm90::smem_u32(sm + (wg == 0 ? L::QS : L::OS));
    // the swap: float4 j of thread t at [j * 128 + t] of its tile, so a
    // warp's stores and loads are 512 contiguous bytes
    float4* mine = reinterpret_cast<float4*>(sm + L::XS + wg * L::X) + tid;
    const float4* theirs =
        reinterpret_cast<const float4*>(sm + L::XS + (1 - wg) * L::X) + tid;
    float dq[64];                            // dQ[:, 128 wg : 128 wg + 128]
    #pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);
    float l2[2], dlt[2];
    int seg_q[2];
    dq_rows<L>(p, sm, bi, q0 + r0, r0, l2, dlt, seg_q);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % STAGES;
      sm90::mbar_wait(full + st, (it / STAGES) & 1);
      const int k0 = (lower + it) * BK;
      const uint32_t k_u = sm90::smem_u32(sm + L::KS + st * L::KV);
      const uint32_t b_u =
          wg == 0 ? k_u : sm90::smem_u32(sm + L::VS + st * L::KV);

      // S = Q . K^T (warpgroup 0) or dP = dO . V^T, [64 q rows x 64 keys]
      float x[32];
      __syncwarp();
      sm90::wgmma_fence();
      #pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const uint32_t off_a = (k / 4) * BQ * 128 + (k % 4) * 32;
        const uint32_t off_b = (k / 4) * BK * 128 + (k % 4) * 32;
        sm90::wgmma_ss_n64<F16>(x, sm90::desc_sw128(a_u + off_a, 16, 1024),
                                sm90::desc_sw128(b_u + off_b, 16, 1024), k);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(x);

      // the swap: barrier 2 waits until the other warpgroup has read the
      // last tile's values, barrier 1 until it has written this tile's
      if (it > 0) sm90::bar_sync(2, 256);
      #pragma unroll
      for (int j = 0; j < 8; ++j)
        mine[j * 128] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                    x[4 * j + 3]);
      sm90::bar_sync(1, 256);
      float y[32];
      #pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 t = theirs[j * 128];
        y[4 * j] = t.x; y[4 * j + 1] = t.y; y[4 * j + 2] = t.z;
        y[4 * j + 3] = t.w;
      }

      // P and dS = P (dP - delta) in registers, the same in both
      // warpgroups; lse and delta run along the rows
      const bool plain = tile_unmasked(p, q0, BQ, k0, BK);
      uint32_t da[16];
      #pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = j & 1;
        float ds[2];
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + e;
          const float sv = wg == 0 ? x[i] : y[i];
          const float dpv = wg == 0 ? y[i] : x[i];
          const float pv = dq_p_elem(p, plain, sv, l2[row],
                                     q0 + r0 + 8 * row,
                                     k0 + 8 * (j / 2) + cq + e, seg_q[row],
                                     bi, scale_l2, neg_l2);
          ds[e] = pv * (dpv - dlt[row]);
        }
        da[j] = sm90::pack2<F16>(ds[0], ds[1]);
      }

      // dQ[:, 128 wg : 128 wg + 128] += dS . K over the tile's 64 keys:
      // K read MN-major from its boxes 2 wg and 2 wg + 1
      __syncwarp();
      sm90::wgmma_fence();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs_tn<F16, 128>(
            dq, da + 4 * kk,
            sm90::desc_sw128(k_u + wg * 2 * BK * 128 + kk * 2048, BK * 128,
                             1024),
            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(da);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + st);
    }

    dq_store<F16, 128>(p, dq, bi, h, q0 + r0, 128 * wg, cq, HD);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg, *seg_q;
  void *dq, *dk, *dv, *ws;
  int dtype, b, sq, sk, nh, nkv, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, has_off, q_off, k_off;
  float scale;
  int splits;
};

// the tensor maps of one launch: q/dO boxes of q_rows rows, k/v boxes of
// k_rows rows
bool make_params(const Args& a, int q_rows, int k_rows, Params* p) {
  const bool f16 = a.dtype == 2;
  const bool ok = sm90::map_bshd(&p->tm_q, a.q, f16, a.b, a.sq, a.nh, a.hd,
                                 a.q_sb, a.q_ss, a.q_sh, q_rows)
                  && sm90::map_bshd(&p->tm_o, a.dout, f16, a.b, a.sq, a.nh,
                                    a.hd, a.o_sb, a.o_ss, a.o_sh, q_rows)
                  && sm90::map_bshd(&p->tm_k, a.k, f16, a.b, a.sk, a.nkv,
                                    a.hd, a.k_sb, a.k_ss, a.k_sh, k_rows)
                  && sm90::map_bshd(&p->tm_v, a.v, f16, a.b, a.sk, a.nkv,
                                    a.hd, a.v_sb, a.v_ss, a.v_sh, k_rows);
  p->lse = static_cast<const float*>(a.lse);
  p->delta = static_cast<const float*>(a.delta);
  p->seg = static_cast<const int32_t*>(a.seg);
  p->seg_q = static_cast<const int32_t*>(a.seg_q);
  p->dq = a.dq;
  p->dk = a.dk;
  p->dv = a.dv;
  p->sq = a.sq; p->sk = a.sk; p->nh = a.nh; p->nkv = a.nkv;
  p->causal = a.causal; p->window = a.window; p->has_off = a.has_off;
  p->q_off = a.q_off; p->k_off = a.k_off; p->scale = a.scale;
  p->ws = static_cast<float*>(a.ws);
  p->splits = a.splits;
  return ok;
}

// K3 at hd 256: the split kernel, then (several splits) the reduction
template <bool F16>
cudaError_t launch_dkv256(const Args& a, cudaStream_t stream) {
  using L = DkvSmem<256>;
  static_assert(L::BYTES <= 227 * 1024, "the stages do not fit the SM");
  Params p;
  if (!make_params(a, L::BQ, L::BK, &p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv256_kernel<F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(a.b * a.nkv * a.splits, (a.sk + L::BK - 1) / L::BK);
  flash_dkv256_kernel<F16><<<grid, NT, L::BYTES, stream>>>(p);
  if (a.splits == 1 || (err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(a.b) * a.sk * a.nkv * 256;
  const int64_t threads = 2 * n / 4;
  dkv_reduce_kernel<F16><<<static_cast<unsigned>((threads + 255) / 256), 256,
                           0, stream>>>(static_cast<const float*>(a.ws), a.dk,
                                        a.dv, n, a.splits);
  return cudaGetLastError();
}

// K2 at hd 256
template <bool F16>
cudaError_t launch_dq256(const Args& a, cudaStream_t stream) {
  using L = DqSmem<256>;
  static_assert(L::BYTES <= 227 * 1024, "the tiles do not fit the SM");
  Params p;
  if (!make_params(a, L::BQ, L::BK, &p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq256_kernel<F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(a.b * a.nh, (a.sq + L::BQ - 1) / L::BQ);
  flash_dq256_kernel<F16><<<grid, NT, L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <bool F16, int HD>
cudaError_t launch(const Args& a, bool dkv, cudaStream_t stream) {
  Params p;
  if (dkv) {
    using L = DkvSmem<HD>;
    if (!make_params(a, L::BQ, L::BK, &p)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_kernel<F16, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.nkv, (a.sk + L::BK - 1) / L::BK);
    flash_dkv_kernel<F16, HD><<<grid, NT, L::BYTES, stream>>>(p);
  } else {
    using L = DqSmem<HD>;
    if (!make_params(a, L::BQ, L::BK, &p)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<F16, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.nh, (a.sq + L::BQ - 1) / L::BQ);
    flash_dq_kernel<F16, HD><<<grid, NT, L::BYTES, stream>>>(p);
  }
  return cudaGetLastError();
}

int run(const Args& a, bool dkv, void* stream) {
  // the route takes half precision at head dims 64, 128 and 256, where
  // K3 alone splits the GQA group (splits dividing it, with a workspace);
  // TMA wants 16-byte aligned bases and strides
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k)
        | reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout))
       & 15) == 0
      && ((a.q_sb | a.q_ss | a.q_sh | a.k_sb | a.k_ss | a.k_sh | a.v_sb | a.v_ss
           | a.v_sh | a.o_sb | a.o_ss | a.o_sh) & 7) == 0;
  const bool hd256 = a.hd == 256;
  if ((a.dtype != 1 && a.dtype != 2) || (a.hd != 64 && a.hd != 128 && !hd256)
      || a.nkv < 1 || a.nh % a.nkv != 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.splits != 1
      && !(dkv && hd256 && a.splits > 1 && (a.nh / a.nkv) % a.splits == 0
           && a.ws != nullptr && (reinterpret_cast<uintptr_t>(a.ws) & 15) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd256 && dkv)
    err = a.dtype == 1 ? launch_dkv256<false>(a, s) : launch_dkv256<true>(a, s);
  else if (hd256)
    err = a.dtype == 1 ? launch_dq256<false>(a, s) : launch_dq256<true>(a, s);
  else if (a.dtype == 1)
    err = a.hd == 64 ? launch<false, 64>(a, dkv, s) : launch<false, 128>(a, dkv, s);
  else
    err = a.hd == 64 ? launch<true, 64>(a, dkv, s) : launch<true, 128>(a, dkv, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// dQ: the same arguments as flash_bwd.cu's, at head dims 64, 128 and 256.
// dtype: 1 bfloat16, 2 float16. Returns a cudaError_t (0 = ok).
int kubedl_flash_bwd90_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* seg, const void* seg_q, void* dq,
                          int dtype, int b, int sq,
                          int sk, int nh, int nkv, int hd, int64_t q_sb,
                          int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                          int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                          int window, int has_off, int q_off, int k_off,
                          float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, seg_q, dq, nullptr, nullptr,
               nullptr,
               dtype, b, sq, sk, nh, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window,
               has_off, q_off, k_off, scale, 1};
  return run(a, false, stream);
}

// dK/dV: flash_bwd.cu's arguments plus the workspace `ws` and `splits`,
// the blocks that share one GQA group. Head dim 256 takes splits dividing
// nh / nkv, and for splits > 1 a 16-byte aligned f32 workspace of
// splits * 2 * b * sk * nkv * hd elements; the other head dims take 1.
int kubedl_flash_bwd90_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta,
                           const void* seg, const void* seg_q, void* dk,
                           void* dv, void* ws,
                           int dtype, int b, int sq, int sk, int nh, int nkv,
                           int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                           int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                           int window, int has_off, int q_off, int k_off,
                           float scale, int splits, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, seg_q, nullptr, dk, dv, ws,
               dtype, b,
               sq, sk, nh, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, has_off, q_off,
               k_off, scale, splits};
  return run(a, true, stream);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
