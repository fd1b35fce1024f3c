// FlashAttention-2 backward on Hopper's tensor cores (sm_90a): dQ (K2) and
// dK/dV (K3) for bf16 and f16 at head dims 64 and 128.
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

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NT = 384;                 // 2 consumer warpgroups + producer
constexpr int STAGES = 2;

struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const float* lse;     // [b*nh, sq]
  const float* delta;   // [b*nh, sq]
  const int32_t* seg;   // [b, s] or null
  void* dq;             // [b, sq, nh, hd] contiguous
  void* dk;             // [b, sk, nkv, hd] contiguous
  void* dv;
  int sq, sk, nh, nkv;
  int causal, window, has_off, q_off, k_off;
  float scale;
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
  static constexpr int BK = 128, BQ = 64;
  static constexpr int KV = BK * HD * 2, Q = BQ * HD * 2;
  static constexpr int K = 0, V = KV, QS = 2 * KV, OS = QS + STAGES * Q;
  static constexpr int LSE = OS + STAGES * Q, DLT = LSE + STAGES * BQ * 4;
  static constexpr int BAR = DLT + STAGES * BQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int HD> struct DqSmem {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int Q = BQ * HD * 2, KV = BK * HD * 2;
  static constexpr int QS = 0, OS = Q, KS = 2 * Q, VS = KS + STAGES * KV;
  static constexpr int LSE = VS + STAGES * KV, DLT = LSE + BQ * 4;
  static constexpr int BAR = DLT + BQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// K3: one block per (b*nkv, 128-row k tile), heaviest k tiles first. Each
// consumer warpgroup owns 64 k rows; the producer streams (Q, dO, lse,
// delta) of every q tile that sees the k tile, for each of the group's
// query heads.
template <bool F16, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_kernel(const __grid_constant__ Params p) {
  using L = DkvSmem<HD>;
  using T = typename Elem<F16>::T;
  constexpr int BK = L::BK, BQ = L::BQ, NB = HD / 64;
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
  // q tiles that can see this k tile (all of them with global offsets)
  const int num_qb = (p.sq + BQ - 1) / BQ;
  int lower = 0, upper = num_qb;
  if (p.causal && !p.has_off) {
    lower = k0 / BQ;
    if (p.window > 0) upper = min(num_qb, (k0 + BK - 1 + p.window - 1) / BQ + 1);
  }
  const int span = max(0, upper - lower);
  const int n_iter = reps * span;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8) {             // the producer warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_full, 2 * L::KV);
        for (int nb = 0; nb < NB; ++nb) {
          sm90::tma_load_4d(sm + L::K + nb * BK * 128, &p.tm_k, kv_full,
                            nb * 64, k0, kvh, bi);
          sm90::tma_load_4d(sm + L::V + nb * BK * 128, &p.tm_v, kv_full,
                            nb * 64, k0, kvh, bi);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        const int h = kvh * reps + it / span;
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
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my k rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);           // my columns: 8j + cq + {0, 1}
    const int kw0 = k0 + 64 * wg;            // this warpgroup's first k row
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);   // see copy_rows
    int seg_k[2] = {0, 0};
    if (p.seg != nullptr)
      for (int i = 0; i < 2; ++i) {
        const int kg = kw0 + r0 + 8 * i;
        seg_k[i] = kg < p.sk ? p.seg[bi * p.sk + kg] : -1;
      }
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
            if (plain) {
              pv[e] = sm90::exp2_approx(fmaf(s[i], scale_l2, -l2));
            } else {
              // branch-free, so the warp stays converged for the next
              // wgmma; rows past sq and keys past sk add nothing
              const int qr = q0 + c, kg = kw0 + r0 + 8 * half;
              bool keep = keep_pair(p, qr, kg);
              if (p.seg != nullptr)
                keep = keep && p.seg[bi * p.sq + min(qr, p.sq - 1)] == seg_k[half];
              const float x = keep ? fmaf(s[i], scale_l2, -l2) : neg_l2 - l2;
              pv[e] = qr < p.sq && kg < p.sk ? sm90::exp2_approx(x) : 0.f;
            }
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

    T* dkp = static_cast<T*>(p.dk);
    T* dvp = static_cast<T*>(p.dv);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kg = kw0 + r0 + 8 * i;
      if (kg >= p.sk) continue;
      const int64_t at = ((static_cast<int64_t>(bi) * p.sk + kg) * p.nkv + kvh) * HD;
      #pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + cq;
        *reinterpret_cast<uint32_t*>(dkp + at + d) = sm90::pack2<F16>(
            dk[4 * j + 2 * i] * p.scale, dk[4 * j + 2 * i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvp + at + d) =
            sm90::pack2<F16>(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// K2: one block per (b*nh, 128-row q tile), heaviest q tiles first. Q, dO,
// lse and delta stay resident; the producer streams the K/V tiles inside
// the causal and window bounds (every tile with global offsets). Each
// consumer warpgroup owns 64 q rows.
template <bool F16, int HD>
__global__ void __launch_bounds__(NT, 1)
flash_dq_kernel(const __grid_constant__ Params p) {
  using L = DqSmem<HD>;
  using T = typename Elem<F16>::T;
  constexpr int BK = L::BK, BQ = L::BQ, NB = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x;
  const int bi = bh / p.nh, h = bh % p.nh, kvh = h / (p.nh / p.nkv);
  const int num_qt = gridDim.y;
  const int qt = p.causal ? num_qt - 1 - static_cast<int>(blockIdx.y)
                          : static_cast<int>(blockIdx.y);
  const int q0 = qt * BQ;
  const int num_kb = (p.sk + BK - 1) / BK;
  int lower = 0, upper = num_kb;
  if (p.causal && !p.has_off) {
    upper = min(num_kb, ((qt + 1) * BQ + BK - 1) / BK);
    if (p.window > 0) {
      const int first_col = qt * BQ - (p.window - 1);
      lower = first_col > 0 ? first_col / BK : 0;
    }
  }
  const int n_iter = max(0, upper - lower);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8) {             // the producer warp
      const int lane = threadIdx.x % 32;
      copy_rows(p, bh, q0, BQ, reinterpret_cast<float*>(sm + L::LSE),
                reinterpret_cast<float*>(sm + L::DLT), lane);
      if (lane == 0) {
        sm90::mbar_expect_tx(q_full, 2 * L::Q);
        for (int nb = 0; nb < NB; ++nb) {
          sm90::tma_load_4d(sm + L::QS + nb * BQ * 128, &p.tm_q, q_full,
                            nb * 64, q0, h, bi);
          sm90::tma_load_4d(sm + L::OS + nb * BQ * 128, &p.tm_o, q_full,
                            nb * 64, q0, h, bi);
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
    }
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
    int seg_q[2] = {0, 0};
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 64 * wg + r0 + 8 * i;
      l2[i] = reinterpret_cast<const float*>(sm + L::LSE)[r];
      dlt[i] = reinterpret_cast<const float*>(sm + L::DLT)[r];
      if (p.seg != nullptr && q0 + r < p.sq) seg_q[i] = p.seg[bi * p.sq + q0 + r];
    }

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
        if (plain) {
          s[i] = sm90::exp2_approx(fmaf(s[i], scale_l2, -l2[row]));
        } else {
          // branch-free, as in K3; keys past sk get p = 0
          const int kc = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qr = qw0 + r0 + 8 * row;
          bool keep = keep_pair(p, qr, kc);
          if (p.seg != nullptr)
            keep = keep && seg_q[row] == p.seg[bi * p.sk + min(kc, p.sk - 1)];
          const float x = keep ? fmaf(s[i], scale_l2, -l2[row]) : neg_l2 - l2[row];
          s[i] = kc < p.sk ? sm90::exp2_approx(x) : 0.f;
        }
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

    T* dqp = static_cast<T*>(p.dq);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = qw0 + r0 + 8 * i;
      if (qr >= p.sq) continue;
      const int64_t at = ((static_cast<int64_t>(bi) * p.sq + qr) * p.nh + h) * HD;
      #pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqp + at + 8 * j + cq) = sm90::pack2<F16>(
            dq[4 * j + 2 * i] * p.scale, dq[4 * j + 2 * i + 1] * p.scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg;
  void *dq, *dk, *dv;
  int dtype, b, sq, sk, nh, nkv, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, has_off, q_off, k_off;
  float scale;
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
  p->dq = a.dq;
  p->dk = a.dk;
  p->dv = a.dv;
  p->sq = a.sq; p->sk = a.sk; p->nh = a.nh; p->nkv = a.nkv;
  p->causal = a.causal; p->window = a.window; p->has_off = a.has_off;
  p->q_off = a.q_off; p->k_off = a.k_off; p->scale = a.scale;
  return ok;
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
  // the route takes half precision at head dims 64 and 128; TMA wants
  // 16-byte aligned bases and strides
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k)
        | reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout))
       & 15) == 0
      && ((a.q_sb | a.q_ss | a.q_sh | a.k_sb | a.k_ss | a.k_sh | a.v_sb | a.v_ss
           | a.v_sh | a.o_sb | a.o_ss | a.o_sh) & 7) == 0;
  if ((a.dtype != 1 && a.dtype != 2) || (a.hd != 64 && a.hd != 128)
      || a.nkv < 1 || a.nh % a.nkv != 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.dtype == 1)
    err = a.hd == 64 ? launch<false, 64>(a, dkv, s) : launch<false, 128>(a, dkv, s);
  else
    err = a.hd == 64 ? launch<true, 64>(a, dkv, s) : launch<true, 128>(a, dkv, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Same arguments as flash_bwd.cu's entry points. dtype: 1 bfloat16,
// 2 float16. Returns a cudaError_t (0 = ok).
int kubedl_flash_bwd90_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* seg, void* dq, int dtype, int b, int sq,
                          int sk, int nh, int nkv, int hd, int64_t q_sb,
                          int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                          int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                          int window, int has_off, int q_off, int k_off,
                          float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, dtype, b,
               sq, sk, nh, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
               v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, has_off, q_off,
               k_off, scale};
  return run(a, false, stream);
}

int kubedl_flash_bwd90_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta,
                           const void* seg, void* dk, void* dv, int dtype, int b,
                           int sq, int sk, int nh, int nkv, int hd, int64_t q_sb,
                           int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                           int window, int has_off, int q_off, int k_off,
                           float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg, nullptr, dk, dv, dtype, b, sq,
               sk, nh, nkv, hd, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
               v_sh, o_sb, o_ss, o_sh, causal, window, has_off, q_off, k_off,
               scale};
  return run(a, true, stream);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
