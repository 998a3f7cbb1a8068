// The f32 program (strict policy) of one (64-query tile, head, batch) of the
// attention kernels, given each operand as a pointer to the head's row 0 and
// a row stride in elements. flash_attention_packed.cu (K1, K7) hands it the
// packed [B, N, H*64] layout, where all four strides are H*64;
// flash_attention.cu (K8) hands it [B, N, H, 64] tensors or views, each with
// its own strides. The bf16 program of the same kernels is flash_wgmma.cu's.
#pragma once

#include "tile_common.cuh"

namespace caim {

constexpr int FA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int HEAD_DIM = 64;

constexpr size_t F32_SMEM = align128(4 * TILE * LDT * sizeof(float))  // Q, K, V, P
                            + align128(2 * TILE * LDF * sizeof(float))  // S, O
                            + 2 * TILE * sizeof(float);                 // m, l

// f32 (strict policy): 64-row tiles and plain f32 FMAs through F32_SMEM
// bytes of dynamic shared memory. q, k, v, out point at row 0 of this head;
// rows of 64 contiguous values, ld* elements apart (multiples of 4). bias:
// null unless BIAS; then f32 [B, N], row b is added to every query row's
// scores.
template <bool BIAS>
__device__ __forceinline__ void flash_f32_body(
    const float* __restrict__ q, int ldq, const float* __restrict__ k, int ldk,
    const float* __restrict__ v, int ldv, const float* __restrict__ bias,
    float* __restrict__ out, int ldo, int q0, int b, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * LDT;
  float* Vs = Ks + TILE * LDT;
  float* Ps = Vs + TILE * LDT;
  float* Ss = reinterpret_cast<float*>(smem + align128(4 * TILE * LDT * sizeof(float)));
  float* Os = Ss + TILE * LDF;
  float* row_m = Os + TILE * LDF;
  float* row_l = row_m + TILE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_per_warp = TILE / (FA_THREADS / 32);

  load_tile(Qs, LDT, q + (size_t)q0 * ldq, ldq, TILE, HEAD_DIM, N - q0);
  for (int i = threadIdx.x; i < TILE * LDF; i += FA_THREADS) Os[i] = 0.0f;
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += TILE) {
    __syncthreads();  // the previous PV product is done with K/V/P
    load_tile(Ks, LDT, k + (size_t)k0 * ldk, ldk, TILE, HEAD_DIM, N - k0);
    load_tile(Vs, LDT, v + (size_t)k0 * ldv, ldv, TILE, HEAD_DIM, N - k0);
    __syncthreads();
    mm_abt(Ss, Qs, Ks, false);
    __syncthreads();

    // online softmax; each warp owns rows_per_warp rows, a lane two columns
    const int kvalid = min(TILE, N - k0);
    float b0 = 0.0f, b1 = 0.0f;  // this lane's two keys' bias, natural base
    if constexpr (BIAS) {
      const float* brow = bias + (size_t)b * N + k0;
      if (lane < kvalid) b0 = brow[lane];
      if (lane + 32 < kvalid) b1 = brow[lane + 32];
    }
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      const float s0 = lane < kvalid ? Ss[r * LDF + lane] * scale + b0 : -INFINITY;
      const float s1 = lane + 32 < kvalid ? Ss[r * LDF + lane + 32] * scale + b1 : -INFINITY;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ps[r * LDT + lane] = p0;
      Ps[r * LDT + lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);
      Os[r * LDF + lane] *= alpha;
      Os[r * LDF + lane + 32] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
      }
    }
    __syncthreads();
    mm_ab_acc(Os, LDF, Ps, Vs, LDT, HEAD_DIM);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE * HEAD_DIM; i += FA_THREADS) {
    const int r = i / HEAD_DIM, c = i % HEAD_DIM;
    if (q0 + r < N) out[(size_t)(q0 + r) * ldo + c] = Os[r * LDF + c] / row_l[r];
  }
}

}  // namespace caim
