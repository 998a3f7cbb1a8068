// K10 and K10b: packed multi-head attention with an int8 first product on
// pre-quantised q and k, without and with a per-key logit bias, written for
// Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py:
//   K10  flash_attention_packed_i8qk -> _i8qk_fwd_only
//        (body _flash_packed_i8qk_kernel);
//   K10b flash_attention_packed_i8qk_bias -> _i8qk_bias_fwd_only
//        (body _flash_packed_i8qk_bias_kernel): the BIAS instantiation.
// Computes, per head h,
//   softmax(float(Q8_h K8_h^T) * sq[row] * sk[key] (+ bias[b, key])) V_h
// with q8, k8 int8 [B, N, H*64] quantised per row over all heads (the
// wrapper does that, as the JAX package does it outside its kernel), sq
// [B, N] and sk [B, N] f32 (the kernel folds the softmax scale into sq), v
// and out bf16. The integer product is exact (64 products of at most 127^2); the
// softmax is f32; P is rounded to bf16 before the PV product, which is K1's.
//
// What bounds it on this card: at B 8, N 1370, H 12 one call is 23 GOP of
// int8 and 23 GFLOP of bf16 products against 50 MB (q8, k8 one byte a value,
// v and out two): operation-bound like K1, with the first half of the work
// at twice the tensor-core rate. What the design does about it is K1's
// design (flash_attention_packed.cu): one block per (64-query tile, head,
// batch), 4 warps of 16 rows, K and V streamed in 64-key tiles through a
// double buffer filled by cp.async, online softmax in base 2 in registers.
// What differs:
//   * Q8 and K8 tiles are 64 rows of 64 bytes (row stride 80 in shared
//     memory: 16-byte aligned for cp.async, and the eight rows of a
//     fragment load fall on distinct banks). The first product is
//     mma.sync m16n8k32 on int8, two k-steps per 64-wide head instead of
//     four; its int32 accumulators have the f32 layout of the bf16 product,
//     so everything after the dequantisation is K1's code.
//   * Dequantisation in registers: a thread holds sq (times log2 e) of its
//     two rows for the whole key loop; the tile's 64 sk values and the
//     additive key row (bias * log2 e, -inf past N) are staged in shared
//     memory with the K tile, by plain 4-byte loads (a row of [B, N] f32
//     with N odd is only 4-byte aligned).
// Not yet used: wgmma, TMA; as for K1, those are the next steps.
#include "flash_step.cuh"

namespace caim {

constexpr int I8_THREADS = 128;  // 4 warps x 16 query rows
constexpr int I8_HEAD = 64;
constexpr int LDQ8 = I8_HEAD + 16;  // smem row stride of an int8 tile (bytes)

template <bool BIAS>
__global__ void __launch_bounds__(I8_THREADS)
flash_i8qk_kernel(const int8_t* __restrict__ q8, const float* __restrict__ sq,
                  const int8_t* __restrict__ k8, const float* __restrict__ sk,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, int N, int H, float scale) {
  __shared__ __align__(16) int8_t Qs[TILE * LDQ8];
  __shared__ __align__(16) int8_t Ks[2][TILE * LDQ8];  // double-buffered K and V
  __shared__ __align__(16) bf16 Vs[2][TILE * LDT];
  __shared__ __align__(8) float SKs[2][TILE];  // sk of the tile's keys
  __shared__ __align__(8) float Bs[2][TILE];   // additive key row, base 2

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * I8_HEAD;
  const size_t base = (size_t)b * N * HD + (size_t)h * I8_HEAD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const int ntiles = (N + TILE - 1) / TILE;
  const float* skrow = sk + (size_t)b * N;

  auto load_sk = [&](float* dst, int k0) {
    if (threadIdx.x >= TILE) {  // the other half of the block loads the key row
      const int key = k0 + threadIdx.x - TILE;
      dst[threadIdx.x - TILE] = key < N ? skrow[key] : 0.0f;
    }
  };

  load_tile_async_bytes(Qs, LDQ8, q8 + base + (size_t)q0 * HD, HD, TILE, I8_HEAD, N - q0);
  load_tile_async_bytes(Ks[0], LDQ8, k8 + base, HD, TILE, I8_HEAD, N);
  load_tile_async(Vs[0], LDT, v + base, HD, TILE, I8_HEAD, N);
  cp_async_commit();
  load_key_row(Bs[0], BIAS ? bias : nullptr, b, N, 0);
  load_sk(SKs[0], 0);

  // row scales with the softmax scale folded in (as the TPU wrapper does),
  // times log2 e; rows past N are computed on zeros and never stored
  const int row0 = q0 + r0, row1 = row0 + 8;  // rows r0, r0 + 8 of the tile
  const float sq0 = row0 < N ? sq[(size_t)b * N + row0] * scale * LOG2E : 0.0f;
  const float sq1 = row1 < N ? sq[(size_t)b * N + row1] * scale * LOG2E : 0.0f;

  uint32_t qf[2][4];  // A fragments of this warp's 16 x 64 int8 Q block
  float o[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r0, r0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TILE, buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const size_t nxt = base + (size_t)(k0 + TILE) * HD;
      load_tile_async_bytes(Ks[buf ^ 1], LDQ8, k8 + nxt, HD, TILE, I8_HEAD, N - k0 - TILE);
      load_tile_async(Vs[buf ^ 1], LDT, v + nxt, HD, TILE, I8_HEAD, N - k0 - TILE);
      cp_async_commit();
      // visible after the barrier that ends this iteration
      load_key_row(Bs[buf ^ 1], BIAS ? bias : nullptr, b, N, k0 + TILE);
      load_sk(SKs[buf ^ 1], k0 + TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to all warps
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        qf[kk][0] = lds32(&Qs[r0 * LDQ8 + 32 * kk + 4 * c]);
        qf[kk][1] = lds32(&Qs[(r0 + 8) * LDQ8 + 32 * kk + 4 * c]);
        qf[kk][2] = lds32(&Qs[r0 * LDQ8 + 32 * kk + 16 + 4 * c]);
        qf[kk][3] = lds32(&Qs[(r0 + 8) * LDQ8 + 32 * kk + 16 + 4 * c]);
      }
    }

    // S = dequant(Q8 K8^T) + key row, for 16 rows x 64 keys, in base 2
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      int acc[4] = {0, 0, 0, 0};
      const int8_t* kr = &Ks[buf][(8 * nt + g) * LDQ8 + 4 * c];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_16832_s8(acc, qf[kk], lds32(kr + 32 * kk), lds32(kr + 32 * kk + 16));
      const float2 ks = *reinterpret_cast<const float2*>(&SKs[buf][8 * nt + 2 * c]);
      const float2 kb = *reinterpret_cast<const float2*>(&Bs[buf][8 * nt + 2 * c]);
      s[nt][0] = (float)acc[0] * sq0 * ks.x + kb.x;
      s[nt][1] = (float)acc[1] * sq0 * ks.y + kb.y;
      s[nt][2] = (float)acc[2] * sq1 * ks.x + kb.x;
      s[nt][3] = (float)acc[3] * sq1 * ks.y + kb.y;
    }
    flash_softmax_pv(s, o, m0, m1, l0, l1, Vs[buf], lane);  // K1's second half
    __syncthreads();  // all warps are done with this buffer before its refill
  }
  flash_store(out + base, HD, row0, N, c, o, l0, l1);
}

template <bool BIAS>
cudaError_t launch_i8qk(const void* q8, const void* sq, const void* k8, const void* sk,
                        const void* v, const void* bias, void* out, int B, int N, int H,
                        float scale, cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  flash_i8qk_kernel<BIAS><<<grid, I8_THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(sq),
      static_cast<const int8_t*>(k8), static_cast<const float*>(sk),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), N, H, scale);
  return cudaGetLastError();
}

}  // namespace caim

// q8, k8: int8 [B, N, H*head_dim]; sq, sk: f32 [B, N] row scales; scale: the
// softmax scale; v, out: bf16 [B, N, H*head_dim]; bias: null (K10) or f32
// [B, N] (K10b). All contiguous; q8, k8, v, out 16-byte aligned;
// head_dim 64. Launches on `stream`, does not synchronize, returns
// cudaGetLastError() after the launch.
extern "C" int caim_flash_attention_i8qk(const void* q8, const void* sq, const void* k8,
                                         const void* sk, const void* v, const void* bias,
                                         void* out, int B, int N, int H, int head_dim,
                                         float scale, void* stream) {
  if (head_dim != caim::I8_HEAD || B <= 0 || N <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return (int)caim::launch_i8qk<true>(q8, sq, k8, sk, v, bias, out, B, N, H, scale,
                                        st);
  return (int)caim::launch_i8qk<false>(q8, sq, k8, sk, v, nullptr, out, B, N, H, scale,
                                       st);
}
