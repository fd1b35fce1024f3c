// FlashAttention forward on Hopper's tensor cores (sm_90a): K1 for bf16 and
// f16 at head dims 64, 128 and 256.
//
// Replaces the TPU kernel kubedl_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_forward through pl.pallas_call) on the serving and
// training paths, and computes what flash_fwd.cu computes (that file stays
// the route for float32 and the other head dims):
//   out = softmax(scale * Q.K^T masked to -1e30) . V in q's dtype, lse =
//   row max + log(max(row sum, 1e-37)) as [b*nh, sq] f32,
// with GQA read in kv-head space, the causal mask top-left with global
// (q_off, k_off) offsets, the sliding window, segment ids and any sq/sk
// (keys past sk get p = 0; a row that sees no key, possible only with
// offsets, averages the keys it visited, as the reference).
//
// Bound on an H100 SXM: at the training shape (b = 4, s = 2048, nh = 32,
// nkv = 8, hd = 128, causal) the 4*hd operations per kept (row, key) pair
// take 0.139 ms at 989 TFLOP/s against ~0.03 ms of bytes: bound by
// tensor-core operations. At the serving shape (b = 2, s = 512) the bytes of
// q/k/v/out/lse bound it, 0.0063 ms, and a q tile sees only 1-4 K/V tiles,
// so the Q load and the epilogue weigh. flash_fwd.cu runs every product on
// the f32 CUDA cores (67 TFLOP/s peak) from f32 tiles that every thread
// stages. Here:
//   * both products are wgmma on bf16/f16 operands with f32 sums: S = Q.K^T
//     from swizzled shared memory, O += P.V with P from registers and V
//     read MN-major, as flash_bwd_sm90.cu's dQ += dS.K;
//   * the grid is persistent (one block of 2 consumer warpgroups of 64 q
//     rows per SM); its blocks deal the (b*nh, 128-row q) tiles heaviest
//     first in a snake, which balances the causal work. Producer lanes
//     load each tile's Q and stream 128-key K/V tiles with TMA (128-byte
//     swizzle, zero fill past the tensor's end) into a 3-stage ring, K and
//     V under their own mbarriers, inside the causal and window bounds
//     (every tile with global offsets); the stream runs on across q tiles,
//     so one tile's epilogue overlaps the next one's loads. setmaxnreg
//     moves the producer's registers to the consumers;
//   * the online softmax stays in registers in the exp2 domain: the scale
//     times log2 e is applied to the f32 S in the exp's FMA, the row max
//     is reduced over the 4 lanes of a quad, the row sum is kept per lane
//     (from the f32 P) and reduced once per q tile, exp is one
//     ex2.approx; only tiles that tile_unmasked does not clear are masked,
//     branch-free. The two warpgroups' products and softmaxes interleave
//     on the SM's tensor cores and other units;
//   * P is rounded to the operand type before P.V (as SDPA does), except
//     on the edge tiles that need a mask (the causal diagonal, window
//     edges, ragged tails, segments): there a row may see only a few keys
//     and its output keeps the size of a V row (a bf16 ulp of 2^-6 past
//     2), so the rest of P, rounded again, goes through a second product,
//     which keeps P.V to ~2^-17 of P (at hd 256 a third product takes the
//     rest of that: ~2^-26, see Tiles);
//   * the O rescale and the final division stay in f32 registers; each
//     warpgroup stages its O rows in its own Q rows (dead after its last
//     S) and writes them with a TMA store, lse from registers.
// lse is written in the reference's units: the max is kept as m2 = max of
// the scores times scale * log2 e, a masked score is -1e30 * log2 e
// exactly, and a row whose max is still that value writes -1e30 +
// log(sum), as the reference's -1e30 + log(n) rounds; the others write
// m2 * ln 2 + log(sum). The backward's fully masked rows depend on it.
// The tile sizes and stages at hd 64/128 are the fastest of the variants
// timed on an H100 (PERF.md): 64-key tiles, 2 stages, one warpgroup per
// block (2 blocks per SM) and the next S issued with this P.V were slower
// at the training shape.
//
// Head dim 256 (Gemma) runs the same template with its own tiles
// (Tiles<256>), because the hd-128 ones fit neither shared memory nor
// registers there:
//   * shared memory: the 128-row Q tile is 128 * 256 * 2 B = 64 KB and a
//     K or V tile of BK keys BK * 512 B. At BK = 128 and 3 stages that is
//     64 + 3 * (64 + 64) = 448 KB against the 227 KB a block may have; at
//     BK = 64 and 2 stages it is 64 + 2 * (32 + 32) = 192 KB (193 KB with
//     the barriers and the 1 KB alignment slack);
//   * registers: a consumer thread holds its share of the warpgroup's 64 x
//     256 f32 O, 128 registers, beside S and P of one tile: at BK = 64
//     that is 32 f32 (S, then P in place) and 16 packed P, 176 in all
//     before the row statistics and addresses, where BK = 128 would need
//     224. setmaxnreg gives the consumers 240 and the producer warpgroup
//     24 (24 * 128 + 240 * 256 = 168 * 384);
//   * O += P.V is one m64n256k16 product per 16 keys, V read MN-major
//     across its four 64-column boxes;
//   * an edge tile's P.V takes two rest products, not one: with ~2^-17 of
//     P a row that sees 3 keys of its segment came out one bf16 ulp from
//     the correctly rounded value (-2.09375 for -2.1015658; the plain
//     version's -2.109375) on an H100; ~2^-26 is below f32's rounding.
// At Gemma-2B's training shape (b = 2, s = 2048, 8/1 heads) the grid
// deals 256 tiles over the 132 SMs; at its embeddings shape (s = 512)
// only 64 tiles exist, so 68 SMs stay idle.

#include <math_constants.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float LN2 = 0.6931471805599453f;
constexpr int NWG = 2;          // consumer warpgroups per block, 1 block/SM
constexpr int BQ = 64 * NWG;    // q rows per tile

// the K/V ring per head dim: BK keys per tile, ST tiles in flight, the
// registers setmaxnreg gives each consumer (REG_C) and producer (REG_P)
// thread, which together are the block's launch allocation (REG_P * 128 +
// REG_C * 256 = 168 * 384), and REST, the products that carry the part of
// P its first rounding missed on an edge tile
template <int HD> struct Tiles {
  static constexpr int BK = 128, ST = 3, REG_C = 232, REG_P = 40, REST = 1;
};
template <> struct Tiles<256> {
  static constexpr int BK = 64, ST = 2, REG_C = 240, REG_P = 24, REST = 2;
};

struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;   // tm_o: out [b, sq, nh, hd]
  float* lse;           // [b*nh, sq]
  const int32_t* seg;   // [b, sk] keys' segments, or null
  const int32_t* seg_q; // [b, sq] query rows' segments (with seg)
  int sq, sk, nh, nkv;
  int bhn, num_qt;      // b * nh, and the q tiles of BQ rows of each
  int causal, window, has_off, q_off, k_off;
  float scale;
};

template <int HD> struct FwdSmem {
  static constexpr int BK = Tiles<HD>::BK, ST = Tiles<HD>::ST;
  static constexpr int Q = BQ * HD * 2, KV = BK * HD * 2;
  static constexpr int QS = 0, KS = Q, VS = KS + ST * KV;
  static constexpr int BAR = VS + ST * KV;
  static constexpr int BYTES = BAR + 8 * (2 + 4 * ST) + 1024;
};

// S = Q . K^T for one warpgroup's 64 rows and one BK-key tile
template <bool F16, int HD, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_u,
                                        uint32_t k_u) {
  #pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const uint64_t a = sm90::desc_sw128(q_u + (k / 4) * BQ * 128 + (k % 4) * 32,
                                        16, 1024);
    const uint64_t b = sm90::desc_sw128(k_u + (k / 4) * BK * 128 + (k % 4) * 32,
                                        16, 1024);
    if constexpr (BK == 128) sm90::wgmma_ss_n128<F16>(s, a, b, k);
    else sm90::wgmma_ss_n64<F16>(s, a, b, k);
  }
}

// O += P . V over one tile's BK keys, P from registers, V MN-major
template <bool F16, int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[BK / 4],
                                         uint32_t v_u) {
  #pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    sm90::wgmma_rs_tn<F16, HD>(
        o, pa + 4 * kk, sm90::desc_sw128(v_u + kk * 2048, BK * 128, 1024), 1);
}

// One tile of the online softmax for this thread's two rows (r and r + 8
// of the warpgroup, BK / 4 keys each), in place: S becomes P (f32), the
// running max m2 (log2 units) and per-lane sum l are updated, and alpha
// is the O rescale per row. An edge tile (one that needs a mask) is
// masked first.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    const Params& p, bool edge, float (&s)[BK / 2], float (&m2)[2],
    float (&l)[2], float (&alpha)[2], int seg_base, const int (&seg_q)[2],
    int qw0, int r0, int cq, int k0, float scale_l2, float neg_l2) {
  float f = scale_l2;
  if (edge) {
    // scores to log2 units, masked ones -1e30 * log2 e, keys past sk -inf
    #pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + cq + (i & 1);
      const bool keep = keep_pair(p, qw0 + r0 + 8 * ((i >> 1) & 1), col);
      s[i] = col < p.sk ? (keep ? s[i] * scale_l2 : neg_l2) : -CUDART_INF_F;
    }
    if (p.seg != nullptr) {
      #pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + cq + (i & 1);
        const bool other = seg_q[(i >> 1) & 1]
                           != p.seg[seg_base + min(col, p.sk - 1)];
        s[i] = other && col < p.sk ? neg_l2 : s[i];
      }
    }
    f = 1.f;
  }
  // the row max and sum over this lane's BK / 4 keys per row, each in two
  // interleaved partials to halve the dependent chains
  float mx[2][2] = {{-CUDART_INF_F, -CUDART_INF_F},
                    {-CUDART_INF_F, -CUDART_INF_F}};
  #pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1][(i >> 2) & 1] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 1], s[i]);
  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(mx[r][0], mx[r][1]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m2[r], m * f);
    alpha[r] = sm90::exp2_approx(m2[r] - m_new);
    m2[r] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  #pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = sm90::exp2_approx(fmaf(s[i], f, -m2[r]));
    sum[r][(i >> 2) & 1] += s[i];
  }
  #pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
}

// P rounded to the operand type, as the A operand of P . V
template <bool F16, int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 4]) {
  #pragma unroll
  for (int j = 0; j < BK / 4; ++j) pa[j] = sm90::pack2<F16>(s[2 * j], s[2 * j + 1]);
}

// the tiles [a, b) of the block's range [lower, lower + n_iter) that the
// rows [qw0, qw0 + 64) can see (causal without offsets); none past sq
template <int BK>
__device__ __forceinline__ int2 wg_tiles(const Params& p, int qw0, int lower,
                                         int n_iter) {
  int a = 0, b = n_iter;
  if (qw0 >= p.sq) {
    b = 0;
  } else if (p.causal && !p.has_off) {
    b = min(n_iter, (qw0 + 64 + BK - 1) / BK - lower);
    if (p.window > 0) {
      const int first_col = qw0 - (p.window - 1);
      a = max(0, (first_col > 0 ? first_col / BK : 0) - lower);
    }
  }
  return make_int2(a, b);
}

// A persistent grid: each block takes (b*nh, BQ-row q) tiles in turn, so
// one tile's epilogue and the next one's Q load overlap the K/V stream,
// which runs on across tiles. The tiles are ordered heaviest
// q tile first and dealt in a snake (round k: block i takes tile k*G + i,
// or k*G + G-1-i on odd rounds), which balances the causal work. The
// producer streams each tile's K/V tiles inside the causal and window
// bounds, K and V each under their own barriers, so a K tile is released
// once S is computed. Each consumer warpgroup owns 64 q rows; it writes
// its O rows through shared memory (its Q rows, dead after its last S)
// with a TMA store, and lse from registers.
template <bool F16, int HD>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_kernel(const __grid_constant__ Params p) {
  using L = FwdSmem<HD>;
  constexpr int NB = HD / 64, BK = L::BK, ST = L::ST;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full_k = q_full + 2;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty_k = full_v + ST;
  uint64_t* empty_v = empty_k + ST;

  const int num_kb = (p.sk + BK - 1) / BK;
  const int n_tiles = p.bhn * p.num_qt;
  const int G = gridDim.x, gi = blockIdx.x;
  auto tile_of = [&](int k) { return k * G + ((k & 1) ? G - 1 - gi : gi); };
  // (q tile, b*nh) of tile t, and its K/V tiles [lower, lower + n_iter)
  struct Tile { int bh, q0, lower, n_iter; };
  auto decode = [&](int t) {
    Tile tl;
    const int qt = p.causal ? p.num_qt - 1 - t / p.bhn : t / p.bhn;
    tl.bh = t % p.bhn;
    tl.q0 = qt * BQ;
    int lower = 0, upper = num_kb;
    if (p.causal && !p.has_off) {
      upper = min(num_kb, (tl.q0 + BQ + BK - 1) / BK);
      if (p.window > 0) {
        const int first_col = tl.q0 - (p.window - 1);
        lower = first_col > 0 ? first_col / BK : 0;
      }
    }
    tl.lower = lower;
    tl.n_iter = max(0, upper - lower);
    return tl;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, NWG);             // one arrival per warpgroup
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_k + s, 4 * NWG);   // one arrival per consumer warp
      sm90::mbar_init(empty_v + s, 4 * NWG);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index read from lane 0, so the compiler knows it is
  // uniform across the warp and keeps the wgmma pipeline in the branches
  // it controls (ptxas serializes wgmma on paths it thinks divergent)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Tiles<HD>::REG_P));
    // lane 0 of the producer warpgroup's first warp streams K/V, lane 0 of
    // its second warp loads each tile's Q once the previous tile's O has
    // left the Q rows, so the K/V stream runs on across tiles
    if (threadIdx.x == 128 * NWG) {
      int g = 0;                             // K/V ring position
      for (int k = 0; tile_of(k) < n_tiles; ++k) {
        const Tile tl = decode(tile_of(k));
        const int bi = tl.bh / p.nh, kvh = tl.bh % p.nh / (p.nh / p.nkv);
        for (int it = 0; it < tl.n_iter; ++it, ++g) {
          const int st = g % ST, phase = ((g / ST) & 1) ^ 1;
          const int k0 = (tl.lower + it) * BK;
          sm90::mbar_wait(empty_k + st, phase);
          sm90::mbar_expect_tx(full_k + st, L::KV);
          for (int nb = 0; nb < NB; ++nb)
            sm90::tma_load_4d(sm + L::KS + st * L::KV + nb * BK * 128,
                              &p.tm_k, full_k + st, nb * 64, k0, kvh, bi);
          sm90::mbar_wait(empty_v + st, phase);
          sm90::mbar_expect_tx(full_v + st, L::KV);
          for (int nb = 0; nb < NB; ++nb)
            sm90::tma_load_4d(sm + L::VS + st * L::KV + nb * BK * 128,
                              &p.tm_v, full_v + st, nb * 64, k0, kvh, bi);
        }
      }
    } else if (threadIdx.x == 128 * NWG + 32) {
      for (int k = 0; tile_of(k) < n_tiles; ++k) {
        const Tile tl = decode(tile_of(k));
        sm90::mbar_wait(q_empty, (k & 1) ^ 1);
        sm90::mbar_expect_tx(q_full, L::Q);
        for (int nb = 0; nb < NB; ++nb)
          sm90::tma_load_4d(sm + L::QS + nb * BQ * 128, &p.tm_q, q_full,
                            nb * 64, tl.q0, tl.bh % p.nh, tl.bh / p.nh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(Tiles<HD>::REG_C));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 16 * warp + lane / 4;     // my q rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);           // my columns: 8j + cq + {0, 1}
    const float scale_l2 = p.scale * LOG2E;
    const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);
    // this warpgroup's Q rows; O is staged there for its TMA store
    uint8_t* q_rows = sm + L::QS + wg * 64 * 128;
    const uint32_t q_u = sm90::smem_u32(q_rows);
    float o[HD / 2], m2[2], l[2], alpha[2];
    float s[BK / 2];
    uint32_t pa[BK / 4];
    int g0 = 0;                              // K/V ring position of the tile

    auto wait_k = [&](int it) {
      const int g = g0 + it;
      sm90::mbar_wait(full_k + g % ST, (g / ST) & 1);
    };
    auto wait_v = [&](int it) {
      const int g = g0 + it;
      sm90::mbar_wait(full_v + g % ST, (g / ST) & 1);
    };
    auto release = [&](uint64_t* bars, int it) {
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bars + (g0 + it) % ST);
    };
    auto k_smem = [&](int it) {
      return sm90::smem_u32(sm + L::KS + ((g0 + it) % ST) * L::KV);
    };
    auto v_smem = [&](int it) {
      return sm90::smem_u32(sm + L::VS + ((g0 + it) % ST) * L::KV);
    };
    auto skip = [&](int it) {
      wait_k(it);
      release(empty_k, it);
      wait_v(it);
      release(empty_v, it);
    };
    // S of one tile, waited for; its K tile is released
    auto s_tile = [&](int it) {
      wait_k(it);
      sm90::fence_regs(s);
      __syncwarp();
      sm90::wgmma_fence();
      issue_s<F16, HD, BK>(s, q_u, k_smem(it));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      release(empty_k, it);
    };
    // O += P.V of one tile, waited for; its V tile is released
    auto pv_tile = [&](int it) {
      wait_v(it);
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      __syncwarp();
      sm90::wgmma_fence();
      issue_pv<F16, HD, BK>(o, pa, v_smem(it));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      release(empty_v, it);
    };
    // on an edge tile, O += (P - pa).V in REST more products, each on the
    // part of P the terms before it missed, rounded again, waited for:
    // with pa.V one keeps P.V to ~2^-17 of P, two to ~2^-26 (P - pa and
    // each later difference are exact in f32)
    auto pv_rest = [&](int it) {
      constexpr int REST = Tiles<HD>::REST;
      uint32_t lo[REST][BK / 4];
      #pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float2 hi = sm90::unpack2<F16>(pa[j]);
        float r0 = s[2 * j] - hi.x, r1 = s[2 * j + 1] - hi.y;
        #pragma unroll
        for (int t = 0; t < REST; ++t) {
          lo[t][j] = sm90::pack2<F16>(r0, r1);
          const float2 got = sm90::unpack2<F16>(lo[t][j]);
          r0 -= got.x;
          r1 -= got.y;
        }
      }
      wait_v(it);
      sm90::fence_regs(o);
      #pragma unroll
      for (int t = 0; t < REST; ++t) sm90::fence_regs(lo[t]);
      __syncwarp();
      sm90::wgmma_fence();
      #pragma unroll
      for (int t = 0; t < REST; ++t) issue_pv<F16, HD, BK>(o, lo[t], v_smem(it));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      #pragma unroll
      for (int t = 0; t < REST; ++t) sm90::fence_regs(lo[t]);
    };

    for (int k = 0; tile_of(k) < n_tiles; ++k) {
      const Tile tl = decode(tile_of(k));
      const int bi = tl.bh / p.nh, h = tl.bh % p.nh;
      const int lower = tl.lower, n_iter = tl.n_iter;
      const int qw0 = tl.q0 + 64 * wg;       // this warpgroup's first q row
      // the tiles [a, b) this warpgroup's rows can see; it only releases
      // the others
      const int2 ab = wg_tiles<BK>(p, qw0, lower, n_iter);
      const int a = ab.x, b = ab.y;
      int seg_q[2] = {0, 0};
      if (p.seg != nullptr)
        for (int i = 0; i < 2; ++i)
          seg_q[i] = p.seg_q[bi * p.sq + min(qw0 + r0 + 8 * i, p.sq - 1)];
      const int seg_base = bi * p.sk;
      #pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      m2[0] = m2[1] = neg_l2;
      l[0] = l[1] = 0.f;
      sm90::mbar_wait(q_full, k & 1);
      for (int it = 0; it < min(a, n_iter); ++it) skip(it);
      for (int it = a; it < b; ++it) {
        s_tile(it);
        // a tile that needs a mask: there a row may see only a few keys,
        // its output then has the size of one V row, and P.V takes the
        // rest of P too (pv_rest)
        const int k0 = (lower + it) * BK;
        const bool edge = !tile_unmasked(p, qw0, 64, k0, BK);
        softmax_tile<BK>(p, edge, s, m2, l, alpha, seg_base, seg_q, qw0, r0, cq,
                     k0, scale_l2, neg_l2);
        pack_p<F16, BK>(s, pa);
        #pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        if (edge) pv_rest(it);
        pv_tile(it);
      }
      for (int it = max(a, b); it < n_iter; ++it) skip(it);
      g0 += n_iter;

      // out = O / max(l, 1e-37) (times the reciprocal) into this
      // warpgroup's Q rows, in the 128-byte swizzle of the TMA map, then
      // one TMA store per 64 columns (rows past sq are not written); lse
      // from registers
      #pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int rr = r0 + 8 * r, qr = qw0 + rr;
        const float safe = fmaxf(l[r], 1e-37f), inv = 1.f / safe;
        #pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(
              q_rows + (j / 8) * BQ * 128 + rr * 128
              + (((j % 8) ^ (rr % 8)) * 16) + cq * 2) =
              sm90::pack2<F16>(o[4 * j + 2 * r] * inv,
                               o[4 * j + 2 * r + 1] * inv);
        if (lane % 4 == 0 && qr < p.sq)
          p.lse[static_cast<int64_t>(tl.bh) * p.sq + qr] =
              m2[r] == neg_l2 ? NEG_INF + logf(safe)
                              : m2[r] * LN2 + logf(safe);
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(1 + wg, 128);
      if (tid == 0) {
        for (int nb = 0; nb < NB; ++nb)
          sm90::tma_store_4d(&p.tm_o, q_rows + nb * BQ * 128, nb * 64, qw0,
                             h, bi);
        sm90::bulk_commit();
        sm90::bulk_wait_read<0>();           // the Q rows may be loaded again
        sm90::mbar_arrive(q_empty);
      }
    }
    if (tid == 0) sm90::bulk_wait<0>();
  }
}

struct Args {
  const void *q, *k, *v, *seg, *seg_q;
  void *out, *lse;
  int dtype, b, sq, sk, nh, nkv, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window, has_off, q_off, k_off;
  float scale;
};

template <bool F16, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = FwdSmem<HD>;
  static_assert(L::BYTES <= 227 * 1024, "the stages do not fit the SM");
  auto kernel = flash_fwd_kernel<F16, HD>;
  Params p;
  const bool f16 = a.dtype == 2;
  // out is the wrapper's contiguous [b, sq, nh, hd]; its boxes are one
  // warpgroup's 64 rows
  const int64_t o_ss = static_cast<int64_t>(a.nh) * a.hd;
  if (!sm90::map_bshd(&p.tm_q, a.q, f16, a.b, a.sq, a.nh, a.hd, a.q_sb,
                      a.q_ss, a.q_sh, BQ)
      || !sm90::map_bshd(&p.tm_k, a.k, f16, a.b, a.sk, a.nkv, a.hd, a.k_sb,
                         a.k_ss, a.k_sh, L::BK)
      || !sm90::map_bshd(&p.tm_v, a.v, f16, a.b, a.sk, a.nkv, a.hd, a.v_sb,
                         a.v_ss, a.v_sh, L::BK)
      || !sm90::map_bshd(&p.tm_o, a.out, f16, a.b, a.sq, a.nh, a.hd,
                         a.sq * o_ss, o_ss, a.hd, 64))
    return cudaErrorInvalidValue;
  p.lse = static_cast<float*>(a.lse);
  p.seg = static_cast<const int32_t*>(a.seg);
  p.seg_q = static_cast<const int32_t*>(a.seg_q);
  p.sq = a.sq; p.sk = a.sk; p.nh = a.nh; p.nkv = a.nkv;
  p.bhn = a.b * a.nh;
  p.num_qt = (a.sq + BQ - 1) / BQ;
  p.causal = a.causal; p.window = a.window; p.has_off = a.has_off;
  p.q_off = a.q_off; p.k_off = a.k_off; p.scale = a.scale;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  // a persistent grid: one block per SM, none idle
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess)
    return err;
  const int64_t n_tiles = static_cast<int64_t>(p.bhn) * p.num_qt;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, 128 * (NWG + 1), L::BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Same arguments as flash_fwd.cu's kubedl_flash_fwd. dtype: 1 bfloat16,
// 2 float16; head dim 64, 128 or 256; q/k/v 16-byte aligned with strides
// of 8 elements (TMA). Returns a cudaError_t (0 = ok).
int kubedl_flash_fwd90(const void* q, const void* k, const void* v, void* o,
                       void* lse, const void* seg, const void* seg_q,
                       int dtype, int b, int sq,
                       int sk, int nh, int nkv, int hd, int64_t q_sb,
                       int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                       int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int causal, int window, int has_off, int q_off,
                       int k_off, float scale, void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
        | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o))
       & 15) == 0
      && ((q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh) & 7)
             == 0;
  if ((dtype != 1 && dtype != 2) || (hd != 64 && hd != 128 && hd != 256)
      || nkv < 1 || nh % nkv != 0 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, seg, seg_q, o, lse, dtype, b, sq, sk, nh, nkv, hd, q_sb,
               q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window,
               has_off, q_off, k_off, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = hd == 64    ? launch<false, 64>(a, s)
          : hd == 128 ? launch<false, 128>(a, s)
                      : launch<false, 256>(a, s);
  else
    err = hd == 64    ? launch<true, 64>(a, s)
          : hd == 128 ? launch<true, 128>(a, s)
                      : launch<true, 256>(a, s);
  return static_cast<int>(err);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
