// K11: packed multi-head attention with the int8 attn_out projection, the
// LayerScale and the residual add fused behind it, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/flash_attention.py,
//   flash_attention_packed_out_res (body _flash_packed_out_res_kernel).
// Computes, for q, k, v, res bf16 [B, N, H*64], wq int8 [HD, HD] ([out, in]),
// ws, b, ls f32 [HD]:
//   ctx = concat_h softmax(Q_h K_h^T * scale) V_h          (f32, never rounded)
//   c8, sc = quantise(ctx) per row over all HD values      (s = max(max|x| / 127,
//                                  1e-12), true division, round-half-even, clip)
//   out = res + ls * (float(c8 wq^T) * sc * ws + b)        (f32, one cast to bf16)
// The f32 context never reaches device memory.
//
// What bounds it on this card: K1's work plus K3's (at B 8, N 1370, H 12:
// 46 GFLOP of bf16 and 12.9 GOP of int8 products against 84 MB): operations.
// The scale of a row needs every head of it, so the H blocks of a 64-row
// tile, one a head, run as one thread-block cluster: the OUT_RES
// instantiation of K1's attention program (flash_wgmma.cu, whose notes give
// the design), which exchanges the rows' maxima and the int8 context between
// its CTAs and runs the projection on wgmma. This file keeps the C entries.
#include "flash_wgmma.cuh"

// q, k, v, res, out: bf16 [B, N, H*head_dim] contiguous, 16-byte aligned;
// head_dim 64, H a count caim_out_res_cluster_size takes, scale > 0. wq: int8
// [HD, HD], rows the output channels; ws, bias, ls: f32 [HD]. ctx8: int8 [B,
// N, HD], written with the quantised context (the kernel's scratch; the
// wrapper returns it on request); sc: null, or f32 [B, N] that receives the
// row scales. Launches on `stream`, does not synchronize, returns the first
// CUDA error.
extern "C" int caim_flash_attention_out_res(const void* q, const void* k, const void* v,
                                            const void* wq, const void* ws, const void* bias,
                                            const void* ls, const void* res, void* out,
                                            void* ctx8, void* sc, int B, int N, int H,
                                            int head_dim, float scale, void* stream) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  return (int)caim::launch_flash_out_res(
      q, k, v, wq, static_cast<const float*>(ws), static_cast<const float*>(bias),
      static_cast<const float*>(ls), res, out, ctx8, static_cast<float*>(sc), B, N, H, scale,
      static_cast<cudaStream_t>(stream));
}

// The CTAs of K11's cluster at H heads (one a head of a 64-row tile), 0
// where it takes no H; kernels/flash_attention.py out_res_cluster_size is
// this rule.
extern "C" int caim_out_res_cluster_size(int H) { return caim::out_res_cluster_size(H); }

// How many of K11's clusters at H heads the device runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int caim_out_res_active_clusters(int H) {
  int n = 0;
  const cudaError_t err = caim::out_res_active_clusters(H, &n);
  return err == cudaSuccess ? n : -(int)err;
}
