// K8: multi-head attention on [B, N, H, 64] operands, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py, flash_attention
// (body _flash_kernel): per (batch, head) softmax(Q K^T * scale) V with the
// scores masked past N, an f32 softmax, P rounded to V's type before the PV
// product and the f32 accumulator divided by the row sum at the end. The TPU
// wrapper transposes its operands to [B*H, N, 64] and pads N to a multiple
// of its 512-key block before the kernel, and transposes back after it.
//
// What bounds it on this card: the work is K1's (flash_attention_packed.cu):
// at B 8, N 1370, H 12 one call is 46 GFLOP of bf16 products against 67 MB,
// operation-bound, with the softmax's exp2 and f32 work about as long again.
// What the design does about it:
//   * No transpose and no padding: a head's rows are 64 contiguous values at
//     a fixed distance, so the kernel takes each operand's batch, token and
//     head strides and addresses the [B, N, H, 64] tensor in place. The same
//     kernel therefore reads separately projected q, k, v, and the three
//     column slices of one fused [B, N, 3 H 64] projection (token stride
//     3 H 64) without a copy. The output is a new contiguous [B, N, H, 64].
//   * bf16: the strides become the 4-D tensor maps of K1's program
//     (flash_wgmma.cu): TMA loads by a producer warp, wgmma products by
//     a consumer warpgroup of 64 query rows, the softmax between them in
//     registers. K8 and K1 launch the same kernel, so on the same
//     memory they give the same bits. A stride the tensor-map encoder
//     refuses raises in the wrapper.
//   * f32 (strict policy): flash_f32.cuh's register-tiled program, K1's,
//     on the operands' own row strides; cp.async reads 16-byte chunks, so
//     every stride is a multiple of 4 elements.
#include "flash_f32.cuh"
#include "flash_wgmma.cuh"

#include <climits>

namespace caim {

__global__ void __launch_bounds__(FA_THREADS, 2)
flash_bnhd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, HeadStrides sq,
                      HeadStrides sk, HeadStrides sv, int N, int H, float scale) {
  const int q0 = blockIdx.x * FA_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * HEAD_DIM;
  flash_f32_body<false>(q + b * sq.b + h * sq.h, (int)sq.n, k + b * sk.b + h * sk.h,
                        (int)sk.n, v + b * sv.b + h * sv.h, (int)sv.n, nullptr,
                        out + (size_t)b * N * HD + (size_t)h * HEAD_DIM, HD, q0, b, N, scale);
}

// 16-byte rows for the f32 program's cp.async copies: every stride a multiple of
// 4 elements, and the token stride within an int
bool f32_strides_ok(const HeadStrides& s) {
  return s.b >= 0 && s.n > 0 && s.h >= 0 && s.n <= INT_MAX && s.b % 4 == 0 && s.n % 4 == 0 &&
         s.h % 4 == 0;
}

}  // namespace caim

// q, k, v: [B, N, H, head_dim] with a contiguous last dimension, 16-byte
// aligned, and the element strides (batch, token, head) given in q_strides,
// k_strides, v_strides, each a multiple of 16 bytes; head_dim 64. out:
// contiguous [B, N, H, head_dim]. dtype: 0 float32, 1 bfloat16. Launches on
// `stream`, does not synchronize, returns cudaGetLastError() after the launch.
extern "C" int caim_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    const long long* q_strides, const long long* k_strides,
                                    const long long* v_strides, int B, int N, int H,
                                    int head_dim, float scale, int dtype, void* stream) {
  using namespace caim;
  if (head_dim != HEAD_DIM || B <= 0 || N <= 0 || H <= 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const HeadStrides sq{q_strides[0], q_strides[1], q_strides[2]};
  const HeadStrides sk{k_strides[0], k_strides[1], k_strides[2]};
  const HeadStrides sv{v_strides[0], v_strides[1], v_strides[2]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch_flash_bf16(q, sq, k, sk, v, sv, nullptr, out, B, N, H, scale, st);
  if (!f32_strides_ok(sq) || !f32_strides_ok(sk) || !f32_strides_ok(sv))
    return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  cudaError_t err = smem_allowance_once(smem_set, (const void*)flash_bnhd_f32_kernel, F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + FA_ROWS - 1) / FA_ROWS, H, B);
  flash_bnhd_f32_kernel<<<grid, FA_THREADS, F32_SMEM, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, sv, N, H, scale);
  return (int)cudaGetLastError();
}
