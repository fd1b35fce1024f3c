// FlashAttention-2 backward for Hopper (sm_90a): dQ (K2) and dK/dV (K3).
//
// Replaces the TPU kernels kubedl_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (both launched by _flash_backward through pl.pallas_call)
// and computes exactly what they compute, from K1's forward residuals:
//   * lse is K1's [b*nh, sq] f32 logsumexp in scaled-score space, and
//     delta = rowsum(dO * O) is [b*nh, sq] f32, computed outside (as the JAX
//     package computes it outside Pallas);
//   * scores s = (q . k) * scale, masked to -1e30 (not -inf) by the same
//     mask as the forward: GQA kv head = q head / (nh / nkv), causal aligned
//     top-left with optional global (q_off, k_off) offsets, sliding window
//     col > row - window, packed-sequence segment ids;
//   * p = exp(s - lse), ds = p * (dO . v - delta);
//   * K2: dq = scale * sum_k ds . k, written in q's dtype;
//   * K3: dv = sum_q p^T . dO and dk = scale * sum_q ds^T . q over every q
//     row of the GQA group's reps query heads, written once in kv-head
//     space in k's dtype.
// Unlike the TPU kernels they read q/k/v/dO in the public [b, s, h, hd]
// layout through strides, take any sq and sk (columns past sk get p = 0;
// rows past sq are never read from lse/delta and add nothing to dk/dv), and
// any head dim up to 256 (templated at 64/128/256, the rest zero-padded).
//
// The TPU dK/dV kernel walks the group's reps query heads as the fastest
// grid axis and carries the sum in VMEM scratch from one grid step to the
// next. Hopper blocks run in no order, so here one block per (b*nkv, k tile)
// loops over the reps heads and the q tiles itself and keeps dk/dv in
// registers: no atomics, no second pass, and the result does not depend on
// the schedule.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at the training shape
// (b = 4, s = 2048, nh = 32, nkv = 8, hd = 128, causal) K2 does 6*hd and K3
// 8*hd operations per kept (row, key) pair, 2.69e8 pairs per head batch:
// 0.21 ms and 0.28 ms of tensor-core time against ~0.06 ms of bytes, so both
// are bound by operations. This first version is simple rather than fast,
// like K1: 256 threads per block, tiles staged as f32 in shared memory (rows
// padded by one float so a row group's lanes hit distinct banks), a 4-row
// score patch and the accumulators in f32 registers, products on the f32
// CUDA cores. wgmma, TMA loads and a causal-balanced schedule come next.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;  // masked score

// q rows per tile, k columns per tile; hd 256 halves the k tile so the
// staged tiles fit the 227 KB of shared memory a block may use
template <int HD> struct Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = HD > 128 ? 32 : 64;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;          // [b*nh, sq]
  const float* delta;        // [b*nh, sq]
  const int32_t* seg;        // [b, s] or null
  void* dq;                  // [b, sq, nh, hd] contiguous
  void* dk;                  // [b, sk, nkv, hd] contiguous
  void* dv;
  int b, sq, sk, nh, nkv, hd;
  int64_t q_sb, q_ss, q_sh;  // element strides (batch, seq, head); dim -1 is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // dO
  int causal, window, has_off, q_off, k_off;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// the forward's keep-mask for one (row, col) pair of local indices
__device__ __forceinline__ bool keep_pair(const Params& p, int row, int col,
                                          int seg_q, int seg_k) {
  bool keep = true;
  if (p.causal) {
    const int grow = row + p.q_off, gcol = col + p.k_off;
    keep = gcol <= grow;
    if (p.window > 0) keep = keep && (gcol > grow - p.window);
  }
  if (p.seg != nullptr) keep = keep && (seg_q == seg_k);
  return keep;
}

// rows x HD tile of a [b, s, h, hd] tensor into shared memory as f32, rows
// past n and dims past hd zero
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t ss,
                                      int r0, int rows, int n, int hd) {
  constexpr int QS = HD + 1;
  for (int idx = threadIdx.x; idx < rows * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * QS + d] = (row < n && d < hd) ? to_f32(src[row * ss + d]) : 0.f;
  }
}

// s = q . k and dp = dO . v for a thread's RQ x RK patch: rows ty*RQ + i,
// columns tx + 16*jj
template <int HD, int RQ, int RK>
__device__ __forceinline__ void score_patch(const float* sQ, const float* sO,
                                            const float* sK, const float* sV,
                                            int ty, int tx, float (&s)[RQ][RK],
                                            float (&dp)[RQ][RK]) {
  constexpr int QS = HD + 1;
  #pragma unroll
  for (int i = 0; i < RQ; ++i)
    #pragma unroll
    for (int jj = 0; jj < RK; ++jj) s[i][jj] = dp[i][jj] = 0.f;
  #pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[RQ], ov[RQ], kv[RK], vv[RK];
    #pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = sQ[(ty * RQ + i) * QS + d];
      ov[i] = sO[(ty * RQ + i) * QS + d];
    }
    #pragma unroll
    for (int jj = 0; jj < RK; ++jj) {
      kv[jj] = sK[(tx + 16 * jj) * QS + d];
      vv[jj] = sV[(tx + 16 * jj) * QS + d];
    }
    #pragma unroll
    for (int i = 0; i < RQ; ++i)
      #pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
        dp[i][jj] = fmaf(ov[i], vv[jj], dp[i][jj]);
      }
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1))
         + sizeof(int32_t) * BK;
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + 2 * BQ * (BK + 1)
                          + 2 * BQ)
         + sizeof(int32_t) * (BQ + BK);
}

// K2: one block per (b*nh, q tile); loops over the K/V tiles the tile's rows
// can see (_kv_lower/_kv_upper), accumulating dq in registers.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dq_kernel(Params p) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr int QS = HD + 1, PS = BK + 1;
  constexpr int RQ = BQ / 16, RK = BK / 16, CPT = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * QS;
  float* sK = sO + BQ * QS;
  float* sV = sK + BK * QS;
  float* sDS = sV + BK * QS;
  int32_t* sSeg = reinterpret_cast<int32_t*>(sDS + BQ * PS);

  const int bh = blockIdx.y;
  const int bi = bh / p.nh;
  const int h = bh % p.nh;
  const int kvh = h / (p.nh / p.nkv);
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  stage<T, HD>(sQ, static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh,
               p.q_ss, q0, BQ, p.sq, p.hd);
  stage<T, HD>(sO, static_cast<const T*>(p.dout) + bi * p.o_sb + h * p.o_sh,
               p.o_ss, q0, BQ, p.sq, p.hd);

  // per-row residuals; rows past sq read nothing (their dq is never stored)
  float lse[RQ], dlt[RQ];
  int seg_q[RQ];
  #pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    const bool in = row < p.sq;
    const int64_t at = static_cast<int64_t>(bh) * p.sq + row;
    lse[i] = in ? p.lse[at] : 0.f;
    dlt[i] = in ? p.delta[at] : 0.f;
    seg_q[i] = (p.seg != nullptr && in) ? p.seg[bi * p.sq + row] : 0;
  }

  float acc[RQ][CPT];
  #pragma unroll
  for (int i = 0; i < RQ; ++i)
    #pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // the causal diagonal and the window skip tiles every row of this block
  // masks; with global offsets every tile runs and the mask is exact
  const int num_kb = (p.sk + BK - 1) / BK;
  int lower = 0, upper = num_kb;
  if (p.causal && !p.has_off) {
    upper = min(num_kb, ((qt + 1) * BQ + BK - 1) / BK);
    if (p.window > 0) {
      const int first_col = qt * BQ - (p.window - 1);
      lower = first_col > 0 ? first_col / BK : 0;
    }
  }

  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  for (int j = lower; j < upper; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's sK/sV/sDS are no longer read
    stage<T, HD>(sK, kb, p.k_ss, k0, BK, p.sk, p.hd);
    stage<T, HD>(sV, vb, p.v_ss, k0, BK, p.sk, p.hd);
    if (p.seg != nullptr && tid < BK) {
      const int col = k0 + tid;
      sSeg[tid] = col < p.sk ? p.seg[bi * p.sk + col] : -1;
    }
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
    score_patch<HD, RQ, RK>(sQ, sO, sK, sV, ty, tx, s, dp);
    #pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      #pragma unroll
      for (int jj = 0; jj < RK; ++jj) {
        const int c = tx + 16 * jj;
        const int col = k0 + c;
        float ds = 0.f;  // columns past sk: p = 0
        if (col < p.sk) {
          float sc = s[i][jj] * p.scale;
          if (!keep_pair(p, q0 + r, col, seg_q[i], p.seg ? sSeg[c] : 0)) sc = NEG_INF;
          const float pv = expf(sc - lse[i]);
          ds = pv * (dp[i][jj] - dlt[i]);
        }
        sDS[r * PS + c] = ds;
      }
    }
    __syncthreads();

    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ];
      #pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sDS[(ty * RQ + i) * PS + kk];
      #pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = sK[kk * QS + tx + 16 * c];
        #pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
  #pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= p.sq) continue;
    T* out = dq + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * p.hd;
    #pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) out[d] = from_f32<T>(acc[i][c] * p.scale);
    }
  }
}

// K3: one block per (b*nkv, k tile); loops over the group's reps query heads
// and, for each, over the q tiles that can see the tile, accumulating dk and
// dv in registers (rows ty*RK + i of the tile, columns tx + 16*c).
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Params p) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr int QS = HD + 1, PS = BK + 1;
  constexpr int RQ = BQ / 16, RK = BK / 16, CPT = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * QS;
  float* sQ = sV + BK * QS;
  float* sO = sQ + BQ * QS;
  float* sP = sO + BQ * QS;
  float* sDS = sP + BQ * PS;
  float* sLse = sDS + BQ * PS;
  float* sDlt = sLse + BQ;
  int32_t* sSegQ = reinterpret_cast<int32_t*>(sDlt + BQ);
  int32_t* sSegK = sSegQ + BQ;

  const int bkv = blockIdx.y;
  const int bi = bkv / p.nkv;
  const int kvh = bkv % p.nkv;
  const int reps = p.nh / p.nkv;
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  stage<T, HD>(sK, static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh,
               p.k_ss, k0, BK, p.sk, p.hd);
  stage<T, HD>(sV, static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh,
               p.v_ss, k0, BK, p.sk, p.hd);
  if (p.seg != nullptr && tid < BK) {
    const int col = k0 + tid;
    sSegK[tid] = col < p.sk ? p.seg[bi * p.sk + col] : -1;
  }

  float dk[RK][CPT], dv[RK][CPT];
  #pragma unroll
  for (int i = 0; i < RK; ++i)
    #pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // q tiles that can see this k tile: from the one holding the causal
  // diagonal on, up to the last row the window still reaches; with global
  // offsets every tile runs and the mask is exact
  const int num_qb = (p.sq + BQ - 1) / BQ;
  int lower = 0, upper = num_qb;
  if (p.causal && !p.has_off) {
    lower = k0 / BQ;
    if (p.window > 0) {
      const int last_row = k0 + BK - 1 + (p.window - 1);
      upper = min(num_qb, last_row / BQ + 1);
    }
  }

  for (int rep = 0; rep < reps; ++rep) {
    const int h = kvh * reps + rep;
    const int bh = bi * p.nh + h;
    const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + h * p.q_sh;
    const T* ob = static_cast<const T*>(p.dout) + bi * p.o_sb + h * p.o_sh;
    for (int i = lower; i < upper; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // sK/sV staged; the previous q tile is no longer read
      stage<T, HD>(sQ, qb, p.q_ss, q0, BQ, p.sq, p.hd);
      stage<T, HD>(sO, ob, p.o_ss, q0, BQ, p.sq, p.hd);
      if (tid < BQ) {
        const int row = q0 + tid;
        const bool in = row < p.sq;
        const int64_t at = static_cast<int64_t>(bh) * p.sq + row;
        sLse[tid] = in ? p.lse[at] : 0.f;
        sDlt[tid] = in ? p.delta[at] : 0.f;
        sSegQ[tid] = (p.seg != nullptr && in) ? p.seg[bi * p.sq + row] : 0;
      }
      __syncthreads();

      float s[RQ][RK], dp[RQ][RK];
      score_patch<HD, RQ, RK>(sQ, sO, sK, sV, ty, tx, s, dp);
      #pragma unroll
      for (int ii = 0; ii < RQ; ++ii) {
        const int r = ty * RQ + ii;
        const int row = q0 + r;
        #pragma unroll
        for (int jj = 0; jj < RK; ++jj) {
          const int c = tx + 16 * jj;
          const int col = k0 + c;
          float pv = 0.f, ds = 0.f;  // rows past sq, columns past sk: nothing
          if (row < p.sq && col < p.sk) {
            float sc = s[ii][jj] * p.scale;
            if (!keep_pair(p, row, col, p.seg ? sSegQ[r] : 0, p.seg ? sSegK[c] : 0))
              sc = NEG_INF;
            pv = expf(sc - sLse[r]);
            ds = pv * (dp[ii][jj] - sDlt[r]);
          }
          sP[r * PS + c] = pv;
          sDS[r * PS + c] = ds;
        }
      }
      __syncthreads();

      #pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pk[RK], dsk[RK];
        #pragma unroll
        for (int i = 0; i < RK; ++i) {
          pk[i] = sP[r * PS + ty * RK + i];
          dsk[i] = sDS[r * PS + ty * RK + i];
        }
        #pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float ov = sO[r * QS + tx + 16 * c];
          const float qv = sQ[r * QS + tx + 16 * c];
          #pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv[i][c] = fmaf(pk[i], ov, dv[i][c]);
            dk[i][c] = fmaf(dsk[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
  #pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int col = k0 + ty * RK + i;
    if (col >= p.sk) continue;
    const int64_t at = ((static_cast<int64_t>(bi) * p.sk + col) * p.nkv + kvh) * p.hd;
    #pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) {
        dkp[at + d] = from_f32<T>(dk[i][c] * p.scale);
        dvp[at + d] = from_f32<T>(dv[i][c]);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + Tiles<HD>::BQ - 1) / Tiles<HD>::BQ, p.b * p.nh);
  flash_dq_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.sk + Tiles<HD>::BK - 1) / Tiles<HD>::BK, p.b * p.nkv);
  flash_dkv_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, bool dkv, cudaStream_t stream) {
  if (p.hd <= 64) return dkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
  if (p.hd <= 128) return dkv ? launch_dkv<T, 128>(p, stream) : launch_dq<T, 128>(p, stream);
  return dkv ? launch_dkv<T, 256>(p, stream) : launch_dq<T, 256>(p, stream);
}

int run(const Params& p, int dtype, bool dkv, void* stream) {
  if (p.hd < 1 || p.hd > 256 || p.nkv < 1 || p.nh % p.nkv != 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(p, dkv, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(p, dkv, s);
  else err = dispatch<__half>(p, dkv, s);
  return static_cast<int>(err);
}

Params make_params(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          const void* seg, void* dq, void* dk, void* dv, int b,
                          int sq, int sk, int nh, int nkv, int hd, int64_t q_sb,
                          int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                          int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                          int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                          int window, int has_off, int q_off, int k_off,
                          float scale) {
  return Params{q, k, v, dout, static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<const int32_t*>(seg),
                dq, dk, dv, b, sq, sk, nh, nkv, hd,
                q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                o_sb, o_ss, o_sh, causal, window, has_off, q_off, k_off, scale};
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t (0 = ok).
int kubedl_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* seg, void* dq, int dtype, int b, int sq,
                        int sk, int nh, int nkv, int hd, int64_t q_sb,
                        int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                        int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                        int window, int has_off, int q_off, int k_off,
                        float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, seg, dq, nullptr,
                               nullptr, b, sq, sk, nh, nkv, hd, q_sb, q_ss,
                               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
                               o_ss, o_sh, causal, window, has_off, q_off,
                               k_off, scale);
  return run(p, dtype, false, stream);
}

int kubedl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* seg, void* dk, void* dv, int dtype, int b,
                         int sq, int sk, int nh, int nkv, int hd, int64_t q_sb,
                         int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                         int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                         int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
                         int window, int has_off, int q_off, int k_off,
                         float scale, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, seg, nullptr, dk, dv,
                               b, sq, sk, nh, nkv, hd, q_sb, q_ss, q_sh, k_sb,
                               k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                               causal, window, has_off, q_off, k_off, scale);
  return run(p, dtype, true, stream);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
