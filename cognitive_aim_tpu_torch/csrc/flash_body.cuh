// The program of one (64-query tile, head, batch) of the bf16 and f32
// attention kernels, given each operand as a pointer to the head's row 0 and
// a row stride in elements. flash_attention_packed.cu (K1, K7) hands it the
// packed [B, N, H*64] layout, where all four strides are H*64;
// flash_attention.cu (K8) hands it [B, N, H, 64] tensors or views, each with
// its own strides. The design notes are in flash_attention_packed.cu.
#pragma once

#include "flash_step.cuh"

namespace caim {

constexpr int FA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int HEAD_DIM = 64;

// bf16: q, k, v, out point at row 0 of this head; rows of 64 contiguous
// values, ld* elements apart (multiples of 8: 16-byte rows for cp.async).
// bias: null unless BIAS; then f32 [B, N], row b is added to every query
// row's scores.
template <bool BIAS>
__device__ __forceinline__ void flash_bf16_body(
    const bf16* __restrict__ q, int ldq, const bf16* __restrict__ k, int ldk,
    const bf16* __restrict__ v, int ldv, const float* __restrict__ bias,
    bf16* __restrict__ out, int ldo, int q0, int b, int N, float scale) {
  __shared__ __align__(16) bf16 Qs[TILE * LDT];
  __shared__ __align__(16) bf16 Ks[2][TILE * LDT];  // double-buffered K and V
  __shared__ __align__(16) bf16 Vs[2][TILE * LDT];
  __shared__ __align__(8) float Bs[BIAS ? 2 : 1][TILE];  // BIAS: the key row, per buffer

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const int ntiles = (N + TILE - 1) / TILE;
  const float scale_log2 = scale * LOG2E;

  load_tile_async(Qs, LDT, q + (size_t)q0 * ldq, ldq, TILE, HEAD_DIM, N - q0);
  load_tile_async(Ks[0], LDT, k, ldk, TILE, HEAD_DIM, N);
  load_tile_async(Vs[0], LDT, v, ldv, TILE, HEAD_DIM, N);
  cp_async_commit();
  if constexpr (BIAS) load_key_row(Bs[0], bias, b, N, 0);

  uint32_t qf[4][4];  // A fragments of this warp's 16 x 64 Q block
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r0, r0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TILE, buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const size_t nxt = (size_t)(k0 + TILE);
      load_tile_async(Ks[buf ^ 1], LDT, k + nxt * ldk, ldk, TILE, HEAD_DIM, N - k0 - TILE);
      load_tile_async(Vs[buf ^ 1], LDT, v + nxt * ldv, ldv, TILE, HEAD_DIM, N - k0 - TILE);
      cp_async_commit();
      // visible after the barrier that ends this iteration
      if constexpr (BIAS) load_key_row(Bs[buf ^ 1], bias, b, N, k0 + TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to all warps
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = lds32(&Qs[r0 * LDT + 16 * kk + 2 * c]);
        qf[kk][1] = lds32(&Qs[(r0 + 8) * LDT + 16 * kk + 2 * c]);
        qf[kk][2] = lds32(&Qs[r0 * LDT + 16 * kk + 8 + 2 * c]);
        qf[kk][3] = lds32(&Qs[(r0 + 8) * LDT + 16 * kk + 8 + 2 * c]);
      }
    }

    float s[8][4];  // S = Q K^T for 16 rows x 64 keys, 8 tiles of 8 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const bf16* kr = &Ks[buf][(8 * nt + g) * LDT + 2 * c];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_16816(s[nt], qf[kk], lds32(kr + 16 * kk), lds32(kr + 16 * kk + 8));
    }

    // scores in base 2 (times scale * log2 e, so exp2 gives the same P) with
    // the tail masked. BIAS: the staged key row holds bias * log2 e, and -inf
    // past N (the scores there are 0, of zero-filled keys, so the sum is -inf).
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float2 kb = make_float2(0.0f, 0.0f);
      if constexpr (BIAS) kb = *reinterpret_cast<const float2*>(&Bs[buf][8 * nt + 2 * c]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (BIAS) {
          const float add = e ? kb.y : kb.x;
          s[nt][e] = s[nt][e] * scale_log2 + add;
          s[nt][2 + e] = s[nt][2 + e] * scale_log2 + add;
        } else {
          const bool ok = k0 + 8 * nt + 2 * c + e < N;
          s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
          s[nt][2 + e] = ok ? s[nt][2 + e] * scale_log2 : -INFINITY;
        }
      }
    }
    flash_softmax_pv(s, o, m0, m1, l0, l1, Vs[buf], lane);
    __syncthreads();  // all warps are done with this buffer before its refill
  }
  flash_store(out, ldo, q0 + r0, N, c, o, l0, l1);
}

constexpr size_t F32_SMEM = align128(4 * TILE * LDT * sizeof(float))  // Q, K, V, P
                            + align128(2 * TILE * LDF * sizeof(float))  // S, O
                            + 2 * TILE * sizeof(float);                 // m, l

// f32 (strict policy): the same tiling with plain f32 FMAs through F32_SMEM
// bytes of dynamic shared memory. Operands as above; ld* multiples of 4.
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
