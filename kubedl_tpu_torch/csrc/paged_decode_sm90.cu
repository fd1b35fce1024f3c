// Paged decode attention for Hopper (sm_90a): one query position per lane
// against that lane's K/V in a block pool, read in place through the lane's
// block table.
//
// Replaces no TPU kernel. The JAX package's decode tick contracts the cache
// in an einsum (kubedl_tpu/models/llama.py, attention_step: products with
// preferred_element_type=float32, the probabilities kept in f32, V upcast in
// registers, no f32 copy of the cache), which XLA fuses on the TPU. Eager
// PyTorch has no such fusion: the port's tick gathered every lane's whole
// table into a dense view, cast it to float32 and ran two batched GEMVs over
// every slot, ~0.9 GB of traffic a layer for Qwen2-7B at 32 lanes x 2,048
// slots. This kernel reads the live K/V once, in its stored dtype.
//
// It computes the einsum's arithmetic:
//   * q.k products and sums in f32 from the stored values;
//   * the scale on the f32 score, then the optional softcap cap*tanh(s/cap);
//   * keys 0..pos[i] only, and pos[i] - window < key with a sliding window;
//   * softmax in f32, online within a split, the splits merged by
//     log-sum-exp in a second kernel;
//   * p.v with the f32 probabilities and V upcast in registers;
//   * one cast to the activation dtype at the end.
// Local query head h reads pool KV head (q_first + h) / group: the GQA map,
// and under a serving mesh where tp does not divide the KV heads, the rank's
// query heads over the whole KV heads it holds.
//
// Bound on an H100 SXM: the live K/V bytes at 3.35 TB/s (2 x live keys x
// KV heads x hd x the stored width, a layer). The design moves each of them
// from HBM once:
//   * one CTA of 128 threads per (lane, KV head, split) holds the KV head's
//     whole group of query heads (up to 8; a larger group takes several
//     CTAs), so a K/V row is read once for every head that attends to it;
//   * it walks its split's keys through the block table in tiles of 8 KiB of
//     K and 8 KiB of V, double-buffered with cp.async; rows past the split's
//     end are zero-filled, never read;
//   * q.k: NT/TK threads a key, each 64 bytes of the row against q in shared
//     memory (broadcast reads; the K rows are XOR-swizzled so a phase of 8
//     threads hits 8 distinct bank groups), then a shuffle sum;
//   * p.v: each thread owns 8 columns of every head over a share of the
//     tile's keys, so one V load feeds 8 x G FMAs; the shares are summed
//     through shared memory once, at the end;
//   * the split count and length come from the shapes alone (the wrapper's
//     decode_splits), so the grid is static and a CUDA graph captures it; a
//     CTA whose split lies past pos[i] (or before the window) exits at once.
// No host synchronisation, no allocation and no cudaFuncSetAttribute: the
// shared memory is static and under 48 KB, and the wrapper allocates the
// output and the split scratch with torch.empty.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;            // threads of the attention kernel
constexpr int NW = NT / 32;
constexpr int TILE_BYTES = 8192;   // one K (or V) tile in shared memory
constexpr int MERGE_NT = 128;      // threads of the merge kernel

struct Params {
  const void* q;            // [b, nh, hd] activation dtype, strides q_sb, q_sh
  const void* k;            // pool [num_blocks, block, nkv, hd], contiguous
  const void* v;
  const int64_t* tables;    // [b, n_tab], row stride t_sb
  const int64_t* pos;       // [b]
  float* part_o;            // [b, nh, splits, hd]
  float* part_ml;           // [b, nh, splits, 2]: the split's max and sum
  void* out;                // [b, nh, hd] contiguous, activation dtype
  int b, nh, hd, nkv, block, n_tab;
  int64_t q_sb, q_sh, t_sb;
  int act_dtype;            // q's and out's: 0 float32, 1 bfloat16, 2 float16
  int q_first, group;       // local head h reads KV head (q_first + h) / group
  int kv_first, kv_count;   // the KV heads the local heads read
  int chunks;               // CTAs a KV head's query heads take
  int splits, split_keys;
  int window;               // 0: none
  float scale, softcap;     // softcap 0: none
};

// 16 bytes of the pool as f32 values
template <typename KT> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Unpack<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float load_act(const void* base, int64_t i, int dt) {
  if (dt == 0) return static_cast<const float*>(base)[i];
  if (dt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  return __half2float(static_cast<const __half*>(base)[i]);
}

__device__ __forceinline__ void store_act(void* base, int64_t i, float x, int dt) {
  if (dt == 0) static_cast<float*>(base)[i] = x;
  else if (dt == 1) static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else static_cast<__half*>(base)[i] = __float2half(x);
}

// 16 bytes global -> shared; `bytes` 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the keys [lo, hi) split `s` attends for a query at `pos`: inside the
// split, at most pos (and the table's slots), after pos - window
__device__ __forceinline__ void split_range(const Params& p, int64_t pos, int s,
                                            int* lo, int* hi) {
  const int64_t slots = static_cast<int64_t>(p.n_tab) * p.block;
  const int64_t end = pos + 1 < slots ? pos + 1 : slots;
  int64_t a = static_cast<int64_t>(s) * p.split_keys;
  int64_t z = a + p.split_keys;
  if (p.window > 0 && a < pos - p.window + 1) a = pos - p.window + 1;
  if (z > end) z = end;
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(z > a ? z : a);
}

template <typename KT, int HD, int G>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const Params p) {
  constexpr int ES = sizeof(KT);
  constexpr int EPC = Unpack<KT>::N;           // elements in a 16-byte chunk
  constexpr int TK = TILE_BYTES / (HD * ES);   // keys a tile
  constexpr int CPR = HD * ES / 16;            // chunks a row
  constexpr int TPK = NT / TK;                 // q.k threads a key
  constexpr int CPT = CPR / TPK;               // chunks a q.k thread
  constexpr int SWZ = TPK < 8 ? 8 / TPK : 1;   // rows in a phase of 8 threads
  constexpr int DC = HD / 8;                   // p.v: groups of 8 columns
  constexpr int KG = NT / DC;                  // p.v: key groups
  constexpr int KPT = TK / KG;                 // p.v: keys a thread, a tile
  constexpr int VCH = 8 / EPC;                 // chunks of 8 V columns
  constexpr int LOADS = TILE_BYTES / 16 / NT;  // cp.async a thread, a tile
  static_assert(CPR % 8 == 0 && TK * TPK == NT && KPT * KG == TK &&
                CPT * TPK == CPR && G % 4 == 0, "tile shape");
  static_assert(KG * G * HD * 4 <= 4 * TILE_BYTES, "p.v shares fit the tiles");

  __shared__ __align__(16) uint8_t s_kv[2][2][TILE_BYTES];  // [stage][K, V]
  __shared__ __align__(16) float s_q[G][HD];
  __shared__ __align__(16) float s_p[TK][G];
  __shared__ float s_red[NW][G];

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int lane = blockIdx.z;
  const int kvh = p.kv_first + blockIdx.y / p.chunks;
  int h0 = kvh * p.group - p.q_first;
  int h1 = h0 + p.group;
  if (h0 < 0) h0 = 0;
  if (h1 > p.nh) h1 = p.nh;
  h0 += (blockIdx.y % p.chunks) * G;
  const int ng = h1 - h0 < G ? h1 - h0 : G;
  if (ng <= 0) return;
  const int64_t pos = p.pos[lane];
  int lo, hi;
  split_range(p, pos, split, &lo, &hi);
  if (lo >= hi) return;

  const KT* kpool = static_cast<const KT*>(p.k);
  const KT* vpool = static_cast<const KT*>(p.v);
  const int64_t* table = p.tables + lane * p.t_sb;
  const int row_chunks = p.hd * ES / 16;       // chunks of a row holding data

  auto issue = [&](int t, int st) {
    const int k0 = lo + t * TK;
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int idx = tid + j * NT;
      const int r = idx / CPR, c = idx % CPR;
      const int key = k0 + r;
      const bool ok = key < hi && c < row_chunks;
      int64_t off = 0;
      if (ok) {
        const int64_t blk = table[key / p.block];
        off = ((blk * p.block + key % p.block) * p.nkv + kvh) * p.hd + c * EPC;
      }
      cp_async16(s_kv[st][0] + (r * CPR + (c ^ ((r % SWZ) * TPK))) * 16,
                 kpool + off, ok ? 16 : 0);
      cp_async16(s_kv[st][1] + (r * CPR + c) * 16, vpool + off, ok ? 16 : 0);
    }
  };

  const int ntiles = (hi - lo + TK - 1) / TK;
  issue(0, 0);
  cp_async_commit();

  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    s_q[g][d] = g < ng && d < p.hd
        ? load_act(p.q, lane * p.q_sb + (h0 + g) * p.q_sh + d, p.act_dtype)
        : 0.f;
  }

  const int qr = tid / TPK, qu = tid % TPK;    // q.k: key row, part of it
  const int kg = tid / DC, dc = tid % DC;      // p.v: key group, columns
  float m[G], lsum[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) issue(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // q.k for row qr over this thread's chunks, summed over the row's threads
    const uint8_t* kt = s_kv[st][0] + qr * CPR * 16;
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = qu + i * TPK;
      float kf[EPC];
      Unpack<KT>::run(*reinterpret_cast<const uint4*>(
                          kt + (c ^ ((qr % SWZ) * TPK)) * 16), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&s_q[g][c * EPC + e]);
          sc[g] = fmaf(qv.x, kf[e], sc[g]);
          sc[g] = fmaf(qv.y, kf[e + 1], sc[g]);
          sc[g] = fmaf(qv.z, kf[e + 2], sc[g]);
          sc[g] = fmaf(qv.w, kf[e + 3], sc[g]);
        }
      }
    }
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
    }

    // scaled, softcapped, masked scores; the tile's max a head
    const bool live = lo + t * TK + qr < hi;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = sc[g] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      sc[g] = live && g < ng ? x : -CUDART_INF_F;
      float mx = sc[g];
#pragma unroll
      for (int off = TPK; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if ((tid & 31) == 0) s_red[tid >> 5][g] = mx;
    }
    __syncthreads();

    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s_red[0][g];
#pragma unroll
      for (int w = 1; w < NW; ++w) mx = fmaxf(mx, s_red[w][g]);
      const float mn = fmaxf(m[g], mx);
      // a head past ng keeps max -inf: no rescale, no weight
      alpha[g] = mn == -CUDART_INF_F ? 1.f : expf(m[g] - mn);
      const float pg = sc[g] == -CUDART_INF_F ? 0.f : expf(sc[g] - mn);
      m[g] = mn;
      lsum[g] = lsum[g] * alpha[g] + (qu == 0 ? pg : 0.f);
      if (qu == 0) s_p[qr][g] = pg;
    }
    __syncthreads();

    // p.v: this thread's 8 columns of every head over its keys of the tile
    const uint8_t* vt = s_kv[st][1];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha[g];
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int r = kg + j * KG;
      float vf[8];
#pragma unroll
      for (int u = 0; u < VCH; ++u)
        Unpack<KT>::run(*reinterpret_cast<const uint4*>(
                            vt + (r * CPR + dc * VCH + u) * 16), vf + u * EPC);
      float pr[G];
#pragma unroll
      for (int g = 0; g < G; g += 4) {
        const float4 pv = *reinterpret_cast<const float4*>(&s_p[r][g]);
        pr[g] = pv.x;
        pr[g + 1] = pv.y;
        pr[g + 2] = pv.z;
        pr[g + 3] = pv.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr[g], vf[e], acc[g][e]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // the split's softmax sums, over the q.k threads
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float x = lsum[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((tid & 31) == 0) s_red[tid >> 5][g] = x;
  }
  // the p.v shares of the key groups, added through the stage buffers
  float* s_acc = reinterpret_cast<float*>(&s_kv[0][0][0]);  // [KG][G][HD]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4* dst = reinterpret_cast<float4*>(s_acc + (kg * G + g) * HD + dc * 8);
    dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
  }
  __syncthreads();

  const int64_t row0 = (static_cast<int64_t>(lane) * p.nh + h0) * p.splits + split;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    if (g >= ng || d >= p.hd) continue;
    float o = 0.f;
#pragma unroll
    for (int q = 0; q < KG; ++q) o += s_acc[(q * G + g) * HD + d];
    p.part_o[(row0 + static_cast<int64_t>(g) * p.splits) * p.hd + d] = o;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) l += s_red[w][g];
      const int64_t at = row0 + static_cast<int64_t>(g) * p.splits;
      p.part_ml[2 * at] = m[g];
      p.part_ml[2 * at + 1] = l;
    }
  }
}

// out[lane, h] = sum over live splits of part_o * e^(m - M), over the same
// sum of the split sums: M the largest split max. A lane with no live key
// (a negative position) gets zeros. The splits' maxima and sums are read
// once, in parallel, into shared memory; the columns' loads then run
// independent of each other.
__global__ void __launch_bounds__(MERGE_NT) paged_decode_merge(const Params p) {
  __shared__ float s_m[256], s_l[256], s_w[256];
  const int h = blockIdx.x, lane = blockIdx.y;
  const int64_t pos = p.pos[lane];
  const int64_t row = static_cast<int64_t>(lane) * p.nh + h;
  const float* ml = p.part_ml + row * p.splits * 2;
  for (int s = threadIdx.x; s < p.splits; s += MERGE_NT) {
    int lo, hi;
    split_range(p, pos, s, &lo, &hi);
    s_m[s] = lo < hi ? ml[2 * s] : -CUDART_INF_F;
    s_l[s] = lo < hi ? ml[2 * s + 1] : 0.f;
  }
  __syncthreads();
  float mx = -CUDART_INF_F;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, s_m[s]);
  for (int s = threadIdx.x; s < p.splits; s += MERGE_NT)
    s_w[s] = s_m[s] == -CUDART_INF_F ? 0.f : expf(s_m[s] - mx);
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < p.splits; ++s) l += s_l[s] * s_w[s];
  const float* part = p.part_o + row * p.splits * p.hd;
  for (int d = threadIdx.x; d < p.hd; d += MERGE_NT) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.splits; ++s) {
      const float w = s_w[s];
      if (w > 0.f) o += part[s * p.hd + d] * w;
    }
    store_act(p.out, row * p.hd + d, l > 0.f ? o / l : 0.f, p.act_dtype);
  }
}

template <typename KT, int G>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.splits, p.kv_count * p.chunks, p.b);
  if (p.hd <= 64) paged_decode_kernel<KT, 64, G><<<grid, NT, 0, stream>>>(p);
  else if (p.hd <= 128) paged_decode_kernel<KT, 128, G><<<grid, NT, 0, stream>>>(p);
  else paged_decode_kernel<KT, 256, G><<<grid, NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge<<<dim3(p.nh, p.b), MERGE_NT, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t dispatch_g(const Params& p, int heads_per_cta, cudaStream_t stream) {
  return heads_per_cta == 4 ? launch<KT, 4>(p, stream) : launch<KT, 8>(p, stream);
}

}  // namespace

extern "C" {

// dtypes: 0 float32, 1 bfloat16, 2 float16. heads_per_cta is 4 or 8 (the
// wrapper's _layout). Returns a cudaError_t (0 = ok).
int kubedl_paged_decode(const void* q, const void* k, const void* v,
                        const void* tables, const void* pos, void* part_o,
                        void* part_ml, void* out, int act_dtype, int kv_dtype,
                        int b, int nh, int hd, int nkv, int block, int n_tab,
                        int64_t q_sb, int64_t q_sh, int64_t t_sb, int q_first,
                        int group, int kv_first, int kv_count, int chunks,
                        int heads_per_cta, int splits, int split_keys,
                        int window, float scale, float softcap, void* stream) {
  const int width = kv_dtype == 0 ? 4 : 2;
  if (hd < 1 || hd > 256 || (hd * width) % 16 != 0 || nkv < 1 || group < 1 ||
      kv_first < 0 || kv_first + kv_count > nkv || chunks < 1 ||
      (heads_per_cta != 4 && heads_per_cta != 8) || splits < 1 ||
      splits > 256 || split_keys < 1 || act_dtype < 0 || act_dtype > 2 ||
      kv_dtype < 0 || kv_dtype > 2 || b < 1 || b > 65535 || nh < 1 ||
      nh > 65535 || kv_count * chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, static_cast<const int64_t*>(tables),
                 static_cast<const int64_t*>(pos), static_cast<float*>(part_o),
                 static_cast<float*>(part_ml), out, b, nh, hd, nkv, block,
                 n_tab, q_sb, q_sh, t_sb, act_dtype, q_first, group, kv_first,
                 kv_count, chunks, splits, split_keys, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_dtype == 0) err = dispatch_g<float>(p, heads_per_cta, s);
  else if (kv_dtype == 1) err = dispatch_g<__nv_bfloat16>(p, heads_per_cta, s);
  else err = dispatch_g<__half>(p, heads_per_cta, s);
  return static_cast<int>(err);
}

const char* kubedl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
