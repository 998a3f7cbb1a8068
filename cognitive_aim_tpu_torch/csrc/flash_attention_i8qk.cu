// K10, K10b and K9: packed multi-head attention with an int8 first product
// on pre-quantised q and k, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py:
//   K10  flash_attention_packed_i8qk -> _i8qk_fwd_only
//        (body _flash_packed_i8qk_kernel);
//   K10b flash_attention_packed_i8qk_bias -> _i8qk_bias_fwd_only
//        (body _flash_packed_i8qk_bias_kernel): the BIAS instantiation;
//   K9   flash_attention_packed(..., int8_dots=True) -> _flash_packed_fwd_only
//        (body _flash_packed_int8_kernel, its quantiser _quant_rows): K10's
//        kernel on scales of another layout, below.
// Computes, per head h,
//   softmax(float(Q8_h K8_h^T) * sq[row] * sk[key] (+ bias[b, key])) V_h
// with q8, k8 int8 [B, N, H*64] quantised per row over all heads (the
// wrapper does that in one launch for both, as the JAX package does it
// outside its kernel), sq [B, N] and sk [B, N] f32 (the kernel folds the
// softmax scale into sq), v and out bf16. The integer product is exact (64
// products of at most 127^2); the softmax is f32; P is rounded to bf16 before
// the P V product, which is K1's.
//
// What bounds it on this card: at B 8, N 1370, H 12 one call is 23 GOP of
// int8 and 23 GFLOP of bf16 products against 50 MB (q8, k8 one byte a value,
// v and out two): operation-bound like K1, with the first half of the work
// at twice the tensor-core rate. The kernel is the I8QK instantiation of K1's
// program (flash_wgmma.cu, whose notes say what differs): q8 and k8 by TMA
// in the 64-byte swizzle, S = Q8 K8^T on wgmma m64n64k32 s8, the int32
// scores dequantised inside the softmax. This file keeps the C entries.
//
// K9 differs from K10 only in its scales: q and k quantised per (row, head)
// over each head's 64 values, sq and sk f32 [B, H, N], where K10 has one per
// row over all H*64 values. The TPU kernel quantises inside the attention
// kernel, so every query tile's block quantises its head's K again (22 times
// at N 1370); here the wrapper quantises q and k once, in one launch
// (quant_heads_pair_kernel, int8_block.cu: a warp a row, each head's maximum
// reduced over the 8 lanes that hold it; scales head-major, so that a key
// tile's 64 scales of one head are contiguous), and the attention program
// stages the head's sk beside K. The program is K10's
// I8QK instantiation, so its costs and its bound are K10's.
#include "flash_wgmma.cuh"

// q8, k8: int8 [B, N, H*head_dim]; sq, sk: f32 [B, N] row scales; scale: the
// softmax scale; v, out: bf16 [B, N, H*head_dim]; bias: null (K10) or f32
// [B, N] (K10b). All contiguous; q8, k8, v, out 16-byte aligned;
// head_dim 64. Launches on `stream`, does not synchronize, returns
// cudaGetLastError() after the launch.
extern "C" int caim_flash_attention_i8qk(const void* q8, const void* sq, const void* k8,
                                         const void* sk, const void* v, const void* bias,
                                         void* out, int B, int N, int H, int head_dim,
                                         float scale, void* stream) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return (int)caim::launch_flash_i8qk(q8, static_cast<const float*>(sq), k8,
                                      static_cast<const float*>(sk), false, v,
                                      static_cast<const float*>(bias), out, B, N, H, scale,
                                      static_cast<cudaStream_t>(stream));
}

// K9: the same on q8, k8 quantised per (row, head), sq and sk f32 [B, H, N];
// no bias.
extern "C" int caim_flash_attention_i8qk_heads(const void* q8, const void* sq, const void* k8,
                                               const void* sk, const void* v, void* out, int B,
                                               int N, int H, int head_dim, float scale,
                                               void* stream) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return (int)caim::launch_flash_i8qk(q8, static_cast<const float*>(sq), k8,
                                      static_cast<const float*>(sk), true, v, nullptr, out, B,
                                      N, H, scale, static_cast<cudaStream_t>(stream));
}

// Blocks of the attention program resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for its instantiation
// <bias, i8qk>, or minus a CUDA error.
extern "C" int caim_flash_blocks_per_sm(int bias, int i8qk) {
  int n = 0;
  const cudaError_t err = caim::flash_blocks_per_sm(bias != 0, i8qk != 0, &n);
  return err == cudaSuccess ? n : -(int)err;
}
