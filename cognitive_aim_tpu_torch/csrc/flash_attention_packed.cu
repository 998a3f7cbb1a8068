// K1 and K7: packed multi-head attention for the ViT backbone, without and
// with a per-key logit bias, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py:
//   K1 flash_attention_packed -> _flash_packed_fwd_only
//      (body _flash_packed_kernel);
//   K7 flash_attention_packed_bias -> _flash_packed_bias_fwd_only
//      (body _flash_packed_bias_kernel): the BIAS instantiation of the same
//      two kernels, softmax(Q_h K_h^T * scale + bias[b, key]) V_h. The bias
//      row [B, N] is f32 and only 4-byte aligned (N = 481), so it is staged
//      with plain loads, one 64-key slice per key tile, already multiplied
//      by log2 e and with -inf past N: the tail mask and the bias are one
//      add. Each block reads N floats beside 2 N x 64 K and V values, so the
//      bias changes neither the bytes nor the operations that bound K1.
// Computes, per head h, softmax(Q_h K_h^T * scale) V_h with an f32 softmax,
// reading q, k, v and writing out in the packed [B, N, H*64] layout of the
// projections (row stride H*64, no head transpose). P is rounded to the
// input type before the PV product, as the TPU kernel does (here the
// not-yet-normalised P of the online softmax; the 1/l scale is applied to
// the f32 accumulator at the end).
//
// What bounds it on this card: at the slice's shapes (B 8, N 1370, H 12)
// one call is 46 GFLOP against 67 MB of q/k/v/out traffic, ~690 FLOP/byte,
// well above the H100's ~295 FLOP/byte ridge: it is compute-bound, on the
// tensor cores for bf16 and on the f32 FMA pipes for the strict policy.
// What the design does about it:
//   * The TPU kept all of K and V for one head resident in VMEM. Here K+V
//     for one head at N 1370 is ~350 KB of bf16, more than the 227 KB a
//     block can use, so K/V stream in 64-key tiles through an online softmax
//     (running max m, sum l and the f32 accumulator O per row): the same
//     math in one pass over the keys.
//   * One block owns one (64-query tile, head, batch): 22 x 12 x 8 = 2112
//     blocks at the slice shape, several resident per SM.
//   * bf16: each of 4 warps owns 16 query rows and runs both products as
//     mma.sync m16n8k16 with f32 accumulation. Q's fragments stay in
//     registers for the whole key loop, S and O never leave registers, and
//     P goes from the QK^T accumulators straight into the PV A fragments.
//     Only the K and V tiles pass through shared memory (46 KB, static),
//     double-buffered: cp.async fetches tile t+1 while tile t is computed.
//     V stays row-major; ldmatrix.trans reads its B fragments. Not yet used:
//     wgmma, TMA, warp specialisation; those are the next steps to the
//     tensor cores' rate.
//   * f32 (strict policy): the same tiling with plain f32 FMAs through
//     shared memory; exact f32 products, not tuned.
//   * The ragged tail (N = 257, 481, 1370 are not multiples of 64) is
//     zero-filled on load and masked to -inf in the softmax; query rows past
//     N are computed on zeros and never stored.
#include "flash_step.cuh"

namespace caim {

constexpr int FA_THREADS = 128;  // 4 warps x 16 query rows
constexpr int HEAD_DIM = 64;

template <bool BIAS>
__global__ void __launch_bounds__(FA_THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, int N, int H, float scale) {
  __shared__ __align__(16) bf16 Qs[TILE * LDT];
  __shared__ __align__(16) bf16 Ks[2][TILE * LDT];  // double-buffered K and V
  __shared__ __align__(16) bf16 Vs[2][TILE * LDT];
  __shared__ __align__(8) float Bs[BIAS ? 2 : 1][TILE];  // BIAS: the key row, per buffer

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const size_t base = (size_t)b * N * HD + (size_t)h * HEAD_DIM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const int ntiles = (N + TILE - 1) / TILE;
  const float scale_log2 = scale * LOG2E;

  load_tile_async(Qs, LDT, q + base + (size_t)q0 * HD, HD, TILE, HEAD_DIM, N - q0);
  load_tile_async(Ks[0], LDT, k + base, HD, TILE, HEAD_DIM, N);
  load_tile_async(Vs[0], LDT, v + base, HD, TILE, HEAD_DIM, N);
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
      const size_t nxt = base + (size_t)(k0 + TILE) * HD;
      load_tile_async(Ks[buf ^ 1], LDT, k + nxt, HD, TILE, HEAD_DIM, N - k0 - TILE);
      load_tile_async(Vs[buf ^ 1], LDT, v + nxt, HD, TILE, HEAD_DIM, N - k0 - TILE);
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
  flash_store(out + base, HD, q0 + r0, N, c, o, l0, l1);
}

constexpr size_t F32_SMEM = align128(4 * TILE * LDT * sizeof(float))  // Q, K, V, P
                            + align128(2 * TILE * LDF * sizeof(float))  // S, O
                            + 2 * TILE * sizeof(float);                 // m, l

template <bool BIAS>
__global__ void __launch_bounds__(FA_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * LDT;
  float* Vs = Ks + TILE * LDT;
  float* Ps = Vs + TILE * LDT;
  float* Ss = reinterpret_cast<float*>(smem + align128(4 * TILE * LDT * sizeof(float)));
  float* Os = Ss + TILE * LDF;
  float* row_m = Os + TILE * LDF;
  float* row_l = row_m + TILE;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const size_t base = (size_t)b * N * HD + (size_t)h * HEAD_DIM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_per_warp = TILE / (FA_THREADS / 32);

  load_tile(Qs, LDT, q + base + (size_t)q0 * HD, HD, TILE, HEAD_DIM, N - q0);
  for (int i = threadIdx.x; i < TILE * LDF; i += FA_THREADS) Os[i] = 0.0f;
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += TILE) {
    __syncthreads();  // the previous PV product is done with K/V/P
    load_tile(Ks, LDT, k + base + (size_t)k0 * HD, HD, TILE, HEAD_DIM, N - k0);
    load_tile(Vs, LDT, v + base + (size_t)k0 * HD, HD, TILE, HEAD_DIM, N - k0);
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
    if (q0 + r < N) out[base + (size_t)(q0 + r) * HD + c] = Os[r * LDF + c] / row_l[r];
  }
}

template <bool BIAS>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const void* bias,
                         void* out, int B, int N, int H, float scale, int dtype,
                         cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, H, B);
  const float* kb = static_cast<const float*>(bias);
  if (dtype == kBF16) {
    flash_bf16_kernel<BIAS><<<grid, FA_THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), kb, static_cast<bf16*>(out), N, H, scale);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<BIAS><<<grid, FA_THREADS, F32_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kb, static_cast<float*>(out), N, H, scale);
  return cudaGetLastError();
}

}  // namespace caim

// q, k, v, out: [B, N, H*head_dim] contiguous, 16-byte aligned; head_dim 64.
// bias: null (K1), or f32 [B, N] contiguous, added to every query row's
// scores of batch b before the softmax (K7). dtype: 0 float32, 1 bfloat16.
// Launches on `stream`, does not synchronize, returns cudaGetLastError()
// after the launch.
extern "C" int caim_flash_attention_packed(const void* q, const void* k, const void* v,
                                           const void* bias, void* out, int B, int N, int H,
                                           int head_dim, float scale, int dtype,
                                           void* stream) {
  if (head_dim != caim::HEAD_DIM || B <= 0 || N <= 0 || H <= 0 ||
      (dtype != caim::kF32 && dtype != caim::kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr)
    return (int)caim::launch_flash<true>(q, k, v, bias, out, B, N, H, scale, dtype, st);
  return (int)caim::launch_flash<false>(q, k, v, nullptr, out, B, N, H, scale, dtype, st);
}

extern "C" const char* caim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
