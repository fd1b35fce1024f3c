// What the tensor-core flash kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu)
// share beyond the Hopper building blocks of sm90.cuh: the reference's
// masked score, the mask of one (row, key) pair and of a whole tile, the
// operand types and the 1024-byte alignment of the shared-memory tiles.
// The mask helpers read the fields sq, sk, seg, causal, window, q_off and
// k_off of each source's own Params.
#pragma once

#include "sm90.cuh"

namespace flash {

constexpr float NEG_INF = -1e30f;       // masked score, as the reference
constexpr float LOG2E = 1.4426950408889634f;

template <bool F16> struct Elem;
template <> struct Elem<false> { using T = __nv_bfloat16; };
template <> struct Elem<true> { using T = __half; };

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// the forward's keep-mask for global row/column positions, formed with
// bitwise ops: masked passes stay free of branches
template <class P>
__device__ __forceinline__ bool keep_pair(const P& p, int row, int col) {
  const int gr = row + p.q_off, gc = col + p.k_off;
  return !p.causal | ((gc <= gr) & ((p.window <= 0) | (gc > gr - p.window)));
}

// true when no element of rows [r0, r0 + nr) x cols [c0, c0 + nc) needs a
// mask: inside sq/sk, no segments, and wholly inside the causal band
template <class P>
__device__ __forceinline__ bool tile_unmasked(const P& p, int r0, int nr,
                                              int c0, int nc) {
  if (p.seg != nullptr || r0 + nr > p.sq || c0 + nc > p.sk) return false;
  if (!p.causal) return true;
  const int top = r0 + p.q_off, bottom = r0 + nr - 1 + p.q_off;
  const int left = c0 + p.k_off, right = c0 + nc - 1 + p.k_off;
  return right <= top && (p.window <= 0 || left > bottom - p.window);
}

}  // namespace flash
