// FlashAttention-2 forward for Hopper (sm_90a): O = softmax(scale*Q*K^T + mask)*V
// with an f32 online softmax over K/V tiles, plus the per-row logsumexp.
//
// Replaces the TPU kernel kubedl_tpu/ops/attention.py:_flash_kernel (launched
// by _flash_forward through pl.pallas_call). It computes exactly what that
// kernel computes:
//   * GQA read in kv-head space: kv head = q head / (nh / nkv) (_kv_index);
//   * causal mask aligned top-left, col <= row, with optional global
//     (q_off, k_off) offsets added to rows and columns (ring attention);
//   * sliding window col > row - window (causal only);
//   * packed sequences: keys only from the query's own segment;
//   * q scaled by 1/sqrt(hd) in f32 before Q*K^T;
//   * masked scores are -1e30, not -inf (no inf - inf = NaN; a fully masked
//     row averages the keys it visited, as the TPU kernel does);
//   * out = acc / max(row_sum, 1e-37) in q's dtype, lse = row_max +
//     log(max(row_sum, 1e-37)) as [b*nh, sq] f32.
// Unlike the TPU kernel it reads q/k/v in the public [b, s, h, hd] layout
// through strides, takes any sq and sk (ragged tails are masked here: columns
// past sk get -inf, so they add nothing even to a fully masked row), and any
// head dim up to 256 (templated at 64/128/256, the rest zero-padded).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the serving shapes
// (b*nh = 64, s = 128..512, hd = 128) the bytes of q/k/v/o/lse (~21 MB at
// s = 512) take ~6.3 us and the causal products ~4.3 us, so the bound is
// bytes. This first version is simple rather than fast: one block of 256
// threads per (b*nh, 64-row q tile); K/V tiles are staged in shared memory
// as f32; scores and the output accumulator stay in f32 registers (a 4-row
// by 4-column score patch and 4 rows by hd/16 output columns per thread);
// the products run on the f32 CUDA cores, so the kernel sits far above its
// bound. Tensor cores (wgmma) and TMA loads are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // k columns per tile
constexpr int NT = 256;      // threads per block: 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;  // masked score

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int32_t* seg;        // [b, s] or null
  int b, sq, sk, nh, nkv, hd;
  int64_t q_sb, q_ss, q_sh;  // element strides (batch, seq, head); dim -1 is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
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

template <int HD>
constexpr size_t smem_bytes() {
  // sQ and sK rows are padded by one float so the 16 lanes of a row group
  // read 16 different banks; sP likewise.
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1))
         + sizeof(int32_t) * BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  constexpr int QS = HD + 1;
  constexpr int PS = BK + 1;
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * HD;
  int32_t* sSeg = reinterpret_cast<int32_t*>(sP + BQ * PS);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int bh = blockIdx.y;
  const int bi = bh / p.nh;
  const int h = bh % p.nh;
  const int kvh = h / (p.nh / p.nkv);
  const int qt = blockIdx.x;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;   // row group: rows ty*4 .. ty*4+3
  const int tx = tid % 16;   // lane in the row group

  // Q tile, scaled in f32; rows past sq and dims past hd are zero.
  const T* qb = q + bi * p.q_sb + h * p.q_sh;
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = q0 + r;
    float x = 0.f;
    if (row < p.sq && d < p.hd) x = to_f32(qb[row * p.q_ss + d]) * p.scale;
    sQ[r * QS + d] = x;
  }

  int seg_q[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    seg_q[i] = (p.seg != nullptr && row < p.sq) ? p.seg[bi * p.sq + row] : 0;
  }

  float m[4], l[4], acc[4][CPT];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // Tile range: the causal diagonal and the window bound skip tiles every
  // row of this block masks (_kv_upper/_kv_lower); with global offsets the
  // diagonal can sit anywhere, so every tile runs and the mask is exact.
  const int num_kb = (p.sk + BK - 1) / BK;
  int lower = 0, upper = num_kb;
  if (p.causal && !p.has_off) {
    upper = min(num_kb, ((qt + 1) * BQ + BK - 1) / BK);
    if (p.window > 0) {
      const int first_col = qt * BQ - (p.window - 1);
      lower = first_col > 0 ? first_col / BK : 0;
    }
  }

  const T* kb = k + bi * p.k_sb + kvh * p.k_sh;
  const T* vb = v + bi * p.v_sb + kvh * p.v_sh;
  for (int j = lower; j < upper; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's sK/sV/sP are no longer read
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int c = idx / HD, d = idx % HD;
      const int col = k0 + c;
      const bool in = col < p.sk && d < p.hd;
      sK[c * QS + d] = in ? to_f32(kb[col * p.k_ss + d]) : 0.f;
      sV[c * HD + d] = in ? to_f32(vb[col * p.v_ss + d]) : 0.f;
    }
    if (p.seg != nullptr && tid < BK) {
      const int col = k0 + tid;
      sSeg[tid] = col < p.sk ? p.seg[bi * p.sk + col] : -1;
    }
    __syncthreads();

    float s[4][4];
    #pragma unroll
    for (int i = 0; i < 4; ++i)
      #pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    #pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
      #pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 16 * jj) * QS + d];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int grow = q0 + r + p.q_off;
      float mx = NEG_INF;
      #pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const int col = k0 + c;
        if (col >= p.sk) {
          s[i][jj] = -CUDART_INF_F;  // ragged tail: adds nothing, even to a fully masked row
        } else {
          const int gcol = col + p.k_off;
          bool keep = true;
          if (p.causal) {
            keep = gcol <= grow;
            if (p.window > 0) keep = keep && (gcol > grow - p.window);
          }
          if (p.seg != nullptr) keep = keep && (seg_q[i] == sSeg[c]);
          if (!keep) s[i][jj] = NEG_INF;
        }
        mx = fmaxf(mx, s[i][jj]);
      }
      // the 16 lanes of a row group are one half-warp: xor offsets < 16
      #pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float new_m = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - new_m);
      float psum = 0.f;
      #pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float pv = expf(s[i][jj] - new_m);
        sP[r * PS + tx + 16 * jj] = pv;
        psum += pv;
      }
      #pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = new_m;
      #pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    #pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
      #pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
      #pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = sV[kk * HD + tx + 16 * c];
        #pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float safe = fmaxf(l[i], 1e-37f);
    T* orow = o + ((static_cast<int64_t>(bi) * p.sq + row) * p.nh + h) * p.hd;
    #pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) orow[d] = from_f32<T>(acc[i][c] / safe);
    }
    if (tx == 0) p.lse[static_cast<int64_t>(bh) * p.sq + row] = m[i] + logf(safe);
  }
}

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + BQ - 1) / BQ, p.b * p.nh);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 64) return launch<T, 64>(p, stream);
  if (p.hd <= 128) return launch<T, 128>(p, stream);
  return launch<T, 256>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. Returns a cudaError_t (0 = ok).
int kubedl_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* seg, int dtype, int b, int sq,
                     int sk, int nh, int nkv, int hd, int64_t q_sb,
                     int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                     int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int causal, int window, int has_off, int q_off,
                     int k_off, float scale, void* stream) {
  if (hd < 1 || hd > 256 || nkv < 1 || nh % nkv != 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<float*>(lse),
           static_cast<const int32_t*>(seg), b, sq, sk, nh, nkv, hd,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           causal, window, has_off, q_off, k_off, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch_hd<float>(p, s);
  else if (dtype == 1) err = dispatch_hd<__nv_bfloat16>(p, s);
  else err = dispatch_hd<__half>(p, s);
  return static_cast<int>(err);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
