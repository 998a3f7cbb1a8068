// The attention program of K1, K7 (flash_attention_packed.cu), K8
// (flash_attention.cu), K10, K10b and K9 (flash_attention_i8qk.cu) and K11
// (flash_attention_out_res.cu), for Hopper: wgmma fed by TMA, one producer
// warp and one consumer warpgroup of 64 query rows. The design notes are in
// flash_wgmma.cu.
#pragma once

#include <cuda_runtime.h>

namespace caim {

// element strides of one [B, N, H, 64] operand (the last dimension is 1)
struct HeadStrides {
  long long b, n, h;
};

// out[b, i, h, :] = softmax(Q_bh K_bh^T * scale [+ bias[b, :]]) V_bh for
// bf16 q, k, v, each given by its base pointer (16-byte aligned) and its
// element strides (multiples of 8, i.e. 16 bytes), a contiguous bf16 [B, N,
// H, 64] out, and bias null or f32 [B, N] contiguous. Launches on `stream`,
// does not synchronize; returns cudaErrorInvalidValue for what it does not take (among it strides
// the tensor-map encoder refuses), else cudaGetLastError() after the launch.
cudaError_t launch_flash_bf16(const void* q, HeadStrides sq, const void* k, HeadStrides sk,
                              const void* v, HeadStrides sv, const float* bias, void* out,
                              int B, int N, int H, float scale, cudaStream_t stream);

// The same with an int8 first product: q8, k8 contiguous int8 [B, N, H*64]
// (16-byte aligned), q_scale, k_scale their f32 scales: [B, N], one a row
// over all heads, or with head_scales [B, H, N], one a (row, head); scores
// float(Q8 K8^T) * q_scale[(h,) row] * k_scale[(h,) key] * scale (+ bias). v
// and out contiguous bf16 [B, N, H*64]. Returns as above.
cudaError_t launch_flash_i8qk(const void* q8, const float* q_scale, const void* k8,
                              const float* k_scale, bool head_scales, const void* v,
                              const float* bias, void* out, int B, int N, int H, float scale,
                              cudaStream_t stream);

// Blocks of the program's instantiation <biased, i8qk> resident on one SM of
// the current device (the occupancy query), in *n.
cudaError_t flash_blocks_per_sm(bool biased, bool i8qk, int* n);

// K11: out = res + ls * (float(quant(ctx) wq^T) * sc * ws + b), ctx the f32
// context of K1's attention on q, k, v over all H heads of a row, quant its
// per-row int8 quantisation over the H*64 values. q, k, v, res, out
// contiguous bf16 [B, N, H*64]; wq int8 [H*64, H*64] ([out, in]); ws, bias,
// ls f32 [H*64]; ctx8 int8 [B, N, H*64], which receives quant(ctx) (the CTAs
// of a cluster share it through L2); sc null or f32 [B, N], which receives
// the rows' scales. All 16-byte aligned; scale > 0; H in 1 ..
// out_res_cluster_size's range. Launches on `stream`, does not synchronize;
// returns cudaErrorInvalidValue for what it does not take, else the error of
// the launch.
cudaError_t launch_flash_out_res(const void* q, const void* k, const void* v, const void* wq,
                                 const float* ws, const float* bias, const float* ls,
                                 const void* res, void* out, void* ctx8, float* sc, int B, int N,
                                 int H, float scale, cudaStream_t stream);

// The CTAs of K11's cluster for H heads (one a head), 0 where it takes no H
int out_res_cluster_size(int H);

// How many of K11's clusters at H heads the device runs at once
// (cudaOccupancyMaxActiveClusters), in *n.
cudaError_t out_res_active_clusters(int H, int* n);

}  // namespace caim
