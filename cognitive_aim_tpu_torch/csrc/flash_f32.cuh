// The f32 program (strict policy) of one (64-query tile, head, batch) of the
// attention kernels K1, K7 (flash_attention_packed.cu) and K8
// (flash_attention.cu), given each operand as a pointer to the head's row 0
// and a row stride in elements: the packed [B, N, H*64] layout, where all
// four strides are H*64, or [B, N, H, 64] tensors and views, each with its
// own strides. The bf16 program of the same kernels is flash_wgmma.cu's.
//
// What bounds it: the products, on the f32 FMA pipes (the policy keeps
// TF32 off): 4 N^2 64 operations a (head, batch) against 16 N 64 bytes. The
// earlier body computed one output element a thread at a time with both
// operands read from shared memory for every FMA, so it ran at the rate of
// shared memory, 3% of the FMA bound. The design here:
//   * Register tiles: 128 threads, each owning 4 rows x 8 keys of S and the
//     same 4 rows x 8 columns of O in registers. S = Q K^T and O += P V are
//     outer products over float4 reads (3 loads of 16 bytes for 32 FMAs);
//     the rows of a thread are 4 apart and its keys 8 apart, so that a
//     warp's reads hit 4 or 8 consecutive rows of the padded tiles, conflict
//     free (tile_common.cuh, RegTile).
//   * Q is copied once and stays in shared memory. K and V tiles of 64 keys
//     are double-buffered by cp.async: tile j + 1's copy is in flight while
//     tile j's products run, two barriers a tile. Rows past N are
//     zero-filled by the copy and their keys masked to -inf.
//   * The online softmax in registers, in base 2: a row's 64 scores sit in 8
//     lanes of one warp, so its maximum takes three shuffles; the running
//     sum stays a per-thread partial (reduced once at the end) and the
//     alpha rescale of O is 32 multiplies in registers. P goes to the PV
//     product through shared memory once a tile. The output is divided by
//     the row sum at the end.
//   * Two blocks an SM (104 KB of shared memory each): eight warps hide the
//     latency of the shared-memory reads. The block covers 64 rows so that
//     the strict slice's B 2 N 257 H 12 gives 120 blocks, about one for each
//     of the 132 SMs; 128-row blocks would leave half the card idle there.
#pragma once

#include "tile_common.cuh"

namespace caim {

constexpr int HEAD_DIM = 64;
constexpr int FA_ROWS = 64;                         // query rows of a block, keys of a tile
using FlashF32Tile = RegTile<FA_ROWS, FA_ROWS, 4, 8>;
constexpr int FA_THREADS = FlashF32Tile::THREADS;   // 128
constexpr int FA_LD = HEAD_DIM + 4;                 // padded row of a Q, K, V or P tile
constexpr int FA_TILE = FA_ROWS * FA_LD;            // floats of a tile
constexpr size_t F32_SMEM = 6 * FA_TILE * sizeof(float);  // Q, K[2], V[2], P

// q, k, v, out point at row 0 of this head; rows of 64 contiguous values,
// ld* elements apart (multiples of 4, 16-byte aligned rows). bias: null
// unless BIAS; then f32 [B, N], row b added to every query row's scores.
template <bool BIAS>
__device__ __forceinline__ void flash_f32_body(
    const float* __restrict__ q, int ldq, const float* __restrict__ k, int ldk,
    const float* __restrict__ v, int ldv, const float* __restrict__ bias,
    float* __restrict__ out, int ldo, int q0, int b, int N, float scale) {
  using T = FlashF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + FA_TILE;      // two slots
  float* Vs = Ks + 2 * FA_TILE;  // two slots
  float* Ps = Vs + 2 * FA_TILE;
  const int tx = T::tx(), r0 = T::row0();
  const int nkt = (N + FA_ROWS - 1) / FA_ROWS;
  const float sl2 = scale * LOG2E;  // scores in base 2

  auto load_kv = [&](int t) {
    const int k0 = t * FA_ROWS;
    load_rows_async<FA_ROWS, HEAD_DIM, FA_LD, FA_THREADS>(Ks + (t & 1) * FA_TILE,
                                                          k + (size_t)k0 * ldk, ldk, N - k0);
    load_rows_async<FA_ROWS, HEAD_DIM, FA_LD, FA_THREADS>(Vs + (t & 1) * FA_TILE,
                                                          v + (size_t)k0 * ldv, ldv, N - k0);
  };
  load_rows_async<FA_ROWS, HEAD_DIM, FA_LD, FA_THREADS>(Qs, q + (size_t)q0 * ldq, ldq, N - q0);
  load_kv(0);
  cp_async_commit();

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.0f;
  }
  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<0>();  // tile t (and Q) landed for this thread
    __syncthreads();     // ... and for all; every thread is done with tile t - 1 and P
    if (t + 1 < nkt) {   // tile t + 1 into the slot tile t - 1 held, in flight until t + 1
      load_kv(t + 1);
      cp_async_commit();
    }
    const int k0 = t * FA_ROWS;
    float bl[8];  // this thread's keys' bias in base 2, -inf past N
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + tx + T::TX * j;
      bl[j] = key < N ? (BIAS ? bias[(size_t)b * N + key] * LOG2E : 0.0f) : -INFINITY;
    }
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    mma_nt<4, 8, HEAD_DIM, FA_LD, FA_LD, T::Y, T::TX>(s, Qs + r0 * FA_LD,
                                                      Ks + (t & 1) * FA_TILE + tx * FA_LD);
    // online softmax: row i's 64 scores are in the 8 lanes of this warp
    // that share lane / 8
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(s[i][j], sl2, bl[j]);
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);  // finite: every tile holds a key < N
      const float alpha = exp2_ftz(m[i] - mn);
      m[i] = mn;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = exp2_ftz(s[i][j] - mn);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) Ps[(r0 + T::Y * i) * FA_LD + tx + T::TX * j] = s[i][j];
    }
    __syncthreads();  // P complete
    mma_nn<4, 8, FA_ROWS, FA_LD, FA_LD, T::Y, T::TX>(o, Ps + r0 * FA_LD,
                                                     Vs + (t & 1) * FA_TILE + 4 * tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const int row = q0 + r0 + T::Y * i;
    if (row < N) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(out + (size_t)row * ldo + 4 * tx + 4 * T::TX * g) =
            make_float4(o[i][4 * g] / sum, o[i][4 * g + 1] / sum, o[i][4 * g + 2] / sum,
                        o[i][4 * g + 3] / sum);
    }
  }
}

}  // namespace caim
