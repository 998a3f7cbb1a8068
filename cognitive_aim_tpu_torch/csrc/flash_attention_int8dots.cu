// K9: packed multi-head attention whose first product is int8 on q and k
// quantised inside the kernel, per (row, head), written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py,
//   flash_attention_packed(..., int8_dots=True) -> _flash_packed_fwd_only
//   (body _flash_packed_int8_kernel, quantiser _quant_rows).
// Computes, per head h,
//   softmax(float(Q8_h K8_h^T) * (sq * scale) * sk^T) V_h
// where Q8_h, sq and K8_h, sk are the head's 64-wide slices of q and k
// quantised per row over those 64 values: s = max(max|x| / 127, 1e-12) with a
// true division, q = clip(round_half_even(x / s), +-127), in f32. These are
// not K10's scales (one per row over all H*64 values, made outside the
// kernel). The integer product is exact; the softmax is f32; P is rounded to
// bf16 before the bf16 P V product, which is K1's. q, k, v and out are bf16
// [B, N, H*64].
//
// What bounds it on this card: K10's work (at B 8, N 1370, H 12: 23 GOP of
// int8 and 23 GFLOP of bf16 products) against 67 MB (q, k, v, out two bytes a
// value): operations. The design is the one K10 had before it moved onto
// wgmma (one block per 64-query tile, head and batch, 4 warps of 16 rows,
// 64-key tiles through a cp.async double buffer, mma.sync m16n8k32 on int8
// fragments, the int32 accumulators dequantised in the f32 layout that
// flash_step.cuh's softmax reads). What differs:
//   * K and V arrive as bf16 tiles. Once a K tile has landed, thread pair
//     (2r, 2r + 1) quantises its row r (32 values each, the maximum joined by
//     one shuffle) into an int8 tile and a scale in shared memory; one more
//     barrier a tile. Keys past N are zero rows: scale 1e-12, values 0, and the
//     score is masked to -inf after dequantising.
//   * Every block of a head quantises all of that head's K again: 22 query
//     tiles at N 1370 repeat it 22 times (the redundancy the TPU package
//     blames for this variant's loss there). Here it is 64 x 64 divisions per
//     tile beside 2 x 64 x 64 x 64 multiply-adds of each product.
//   * Q is quantised once, straight from global memory, while the first K
//     and V tiles are in flight; rows past N are zeros.
#include "flash_step.cuh"

namespace caim {

constexpr int I8D_THREADS = 128;  // 4 warps x 16 query rows; 2 threads a tile row
constexpr int I8D_HEAD = 64;
constexpr int LDQ8D = I8D_HEAD + 16;  // smem row stride of an int8 tile (bytes)

// Quantise a 64 x 64 bf16 tile (rows ld elements apart, in shared or global
// memory, 16-byte aligned; rows >= valid_rows count as zeros) per row into
// dst (int8, row stride LDQ8D) and scales[64]. Thread pair (2r, 2r + 1) takes
// row r. Every thread of the block calls it.
__device__ __forceinline__ void quant_tile_rows(const bf16* __restrict__ src, size_t ld,
                                                int valid_rows, int8_t* __restrict__ dst,
                                                float* __restrict__ scales) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float x[32];
  if (r < valid_rows) {
    const bf16* p = src + (size_t)r * ld + half * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + 8 * i);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int t = 0; t < 8; ++t) x[8 * i + t] = __bfloat162float(e[t]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.0f;
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) amax = fmaxf(amax, fabsf(x[i]));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float s = quant_scale(amax);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = quant_pack4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3], s);
  int8_t* d = dst + r * LDQ8D + half * 32;
  *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(d + 16) = make_uint4(w[4], w[5], w[6], w[7]);
  if (half == 0) scales[r] = s;
}

__global__ void __launch_bounds__(I8D_THREADS)
flash_int8dots_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int N, int H,
                      float scale) {
  __shared__ __align__(16) bf16 Ks[2][TILE * LDT];  // double-buffered K and V
  __shared__ __align__(16) bf16 Vs[2][TILE * LDT];
  __shared__ __align__(16) int8_t Q8s[TILE * LDQ8D];
  __shared__ __align__(16) int8_t K8s[TILE * LDQ8D];  // the current tile, quantised
  __shared__ __align__(8) float SQs[TILE];
  __shared__ __align__(8) float SKs[TILE];

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * I8D_HEAD;
  const size_t base = (size_t)b * N * HD + (size_t)h * I8D_HEAD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const int ntiles = (N + TILE - 1) / TILE;

  load_tile_async(Ks[0], LDT, k + base, HD, TILE, I8D_HEAD, N);
  load_tile_async(Vs[0], LDT, v + base, HD, TILE, I8D_HEAD, N);
  cp_async_commit();
  quant_tile_rows(q + base + (size_t)q0 * HD, HD, N - q0, Q8s, SQs);

  uint32_t qf[2][4];  // A fragments of this warp's 16 x 64 int8 Q block
  float sq0 = 0.0f, sq1 = 0.0f;  // rows' scales times the softmax scale and log2 e
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r0, r0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TILE, buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const size_t nxt = base + (size_t)(k0 + TILE) * HD;
      load_tile_async(Ks[buf ^ 1], LDT, k + nxt, HD, TILE, I8D_HEAD, N - k0 - TILE);
      load_tile_async(Vs[buf ^ 1], LDT, v + nxt, HD, TILE, I8D_HEAD, N - k0 - TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the quantised Q) visible to all warps
    quant_tile_rows(Ks[buf], LDT, TILE, K8s, SKs);
    __syncthreads();  // the quantised K tile visible
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        qf[kk][0] = lds32(&Q8s[r0 * LDQ8D + 32 * kk + 4 * c]);
        qf[kk][1] = lds32(&Q8s[(r0 + 8) * LDQ8D + 32 * kk + 4 * c]);
        qf[kk][2] = lds32(&Q8s[r0 * LDQ8D + 32 * kk + 16 + 4 * c]);
        qf[kk][3] = lds32(&Q8s[(r0 + 8) * LDQ8D + 32 * kk + 16 + 4 * c]);
      }
      sq0 = SQs[r0] * scale * LOG2E;
      sq1 = SQs[r0 + 8] * scale * LOG2E;
    }

    // S = dequant(Q8 K8^T) for 16 rows x 64 keys, in base 2, keys past N at -inf
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = &K8s[(8 * nt + g) * LDQ8D + 4 * c];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_16832_s8(acc, qf[kk], lds32(kr + 32 * kk), lds32(kr + 32 * kk + 16));
      const float2 ks = *reinterpret_cast<const float2*>(&SKs[8 * nt + 2 * c]);
      const int key = k0 + 8 * nt + 2 * c;
      s[nt][0] = key < N ? (float)acc[0] * sq0 * ks.x : -INFINITY;
      s[nt][1] = key + 1 < N ? (float)acc[1] * sq0 * ks.y : -INFINITY;
      s[nt][2] = key < N ? (float)acc[2] * sq1 * ks.x : -INFINITY;
      s[nt][3] = key + 1 < N ? (float)acc[3] * sq1 * ks.y : -INFINITY;
    }
    flash_softmax_pv(s, o, m0, m1, l0, l1, Vs[buf], lane);  // K1's second half
    __syncthreads();  // all warps are done with this buffer and with K8s
  }
  flash_store(out + base, HD, q0 + r0, N, c, o, l0, l1);
}

}  // namespace caim

// q, k, v, out: bf16 [B, N, H*head_dim] contiguous, 16-byte aligned; head_dim
// 64; scale: the softmax scale. Launches on `stream`, does not synchronize,
// returns cudaGetLastError() after the launch.
extern "C" int caim_flash_attention_int8dots(const void* q, const void* k, const void* v,
                                             void* out, int B, int N, int H, int head_dim,
                                             float scale, void* stream) {
  if (head_dim != caim::I8D_HEAD || B <= 0 || N <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + caim::TILE - 1) / caim::TILE, H, B);
  caim::flash_int8dots_kernel<<<grid, caim::I8D_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const caim::bf16*>(q), static_cast<const caim::bf16*>(k),
      static_cast<const caim::bf16*>(v), static_cast<caim::bf16*>(out), N, H, scale);
  return (int)cudaGetLastError();
}
