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
#include "flash_body.cuh"

namespace caim {

// The block of (64-query tile blockIdx.x, head blockIdx.y, batch blockIdx.z);
// the program itself is flash_body.cuh's, on the packed layout: every
// operand's row stride is H * 64.
template <bool BIAS>
__global__ void __launch_bounds__(FA_THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  bf16* __restrict__ out, int N, int H, float scale) {
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const size_t base = (size_t)b * N * HD + (size_t)h * HEAD_DIM;
  flash_bf16_body<BIAS>(q + base, HD, k + base, HD, v + base, HD, bias, out + base, HD, q0, b,
                        N, scale);
}

template <bool BIAS>
__global__ void __launch_bounds__(FA_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, int N, int H, float scale) {
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const size_t base = (size_t)b * N * HD + (size_t)h * HEAD_DIM;
  flash_f32_body<BIAS>(q + base, HD, k + base, HD, v + base, HD, bias, out + base, HD, q0, b,
                       N, scale);
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
