// K1 and K7: packed multi-head attention for the ViT backbone, without and
// with a per-key logit bias, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py:
//   K1 flash_attention_packed -> _flash_packed_fwd_only
//      (body _flash_packed_kernel);
//   K7 flash_attention_packed_bias -> _flash_packed_bias_fwd_only
//      (body _flash_packed_bias_kernel): the BIAS instantiation of the same
//      two kernels, softmax(Q_h K_h^T * scale + bias[b, key]) V_h. The bias
//      row [B, N] is f32 and only 4-byte aligned (N = 481), out of TMA's
//      reach, so the producer warp stages each key tile's slice with
//      plain loads, already multiplied by log2 e and with -inf past N: the
//      tail mask and the bias are one term. Each block reads N floats beside
//      2 N x 64 K and V values, so the bias changes neither the bytes nor the
//      operations that bound K1.
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
// tensor cores for bf16 and on the f32 FMA pipes for the strict policy; the
// bf16 softmax's exp2 and f32 arithmetic take about as long as the products.
// What the design does about it:
//   * The TPU kept all of K and V for one head resident in VMEM. Here K+V
//     for one head at N 1370 is ~350 KB of bf16, more than the 227 KB a
//     block can use, so K/V stream in key tiles through an online softmax
//     (running max m, sum l and the f32 accumulator O per row): the same
//     math in one pass over the keys.
//   * bf16: the program is flash_wgmma.cu's, which K8 shares: the packed
//     layout is the [B, N, H, 64] view with strides (N H 64, H 64, 64). A
//     block owns 64 query rows of one (head, batch) (a 128-row variant is
//     slower at every length measured); a producer warp loads Q once and K,
//     V tiles through a ring of stages by TMA, and one consumer warpgroup
//     runs both products as wgmma (S = Q K^T with Q from registers, O += P V
//     with P from registers) with the next tile's scores in flight during
//     each softmax, three blocks an SM. The earlier body (4 warps of mma.sync
//     m16n8k16 fed by a cp.async double buffer) read the same 0.74 GB of K
//     and V from L2 a call at N 1370 in twice the time: it was bound by
//     issuing its products, 64 mma.sync for what one wgmma does.
//   * f32 (strict policy): exact f32 products on the FMA pipes, register
//     tiles fed by cp.async (flash_f32.cuh, which K8 shares); the bias
//     row is read by plain loads.
//   * The ragged tail (N = 257, 481, 1370 are not multiples of 64): TMA
//     zero-fills the rows past N and drops them on the store, the softmax
//     masks those keys to -inf; the f32 program's copies zero-fill and it
//     masks likewise.
#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

namespace caim {

template <bool BIAS>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, int N, int H, float scale) {
  const int q0 = blockIdx.x * FA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  const size_t base = (size_t)b * N * HD + (size_t)h * HEAD_DIM;
  flash_f32_body<BIAS>(q + base, HD, k + base, HD, v + base, HD, bias, out + base, HD, q0, b,
                       N, scale);
}

template <bool BIAS>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int N, int H, float scale, cudaStream_t stream) {
  const dim3 grid((N + FA_ROWS - 1) / FA_ROWS, H, B);
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  cudaError_t err = smem_allowance_once(smem_set, (const void*)flash_f32_kernel<BIAS>, F32_SMEM);
  if (err != cudaSuccess) return err;
  flash_f32_kernel<BIAS><<<grid, FA_THREADS, F32_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias), static_cast<float*>(out),
      N, H, scale);
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
                                           int head_dim, float scale, int dtype, void* stream) {
  using namespace caim;
  if (head_dim != HEAD_DIM || B <= 0 || N <= 0 || H <= 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(bias);
  if (dtype == kBF16) {
    const HeadStrides s{(long long)N * H * HEAD_DIM, (long long)H * HEAD_DIM, HEAD_DIM};
    return (int)launch_flash_bf16(q, s, k, s, v, s, kb, out, B, N, H, scale, st);
  }
  if (bias != nullptr) return (int)launch_flash_f32<true>(q, k, v, bias, out, B, N, H, scale, st);
  return (int)launch_flash_f32<false>(q, k, v, nullptr, out, B, N, H, scale, st);
}

extern "C" const char* caim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
