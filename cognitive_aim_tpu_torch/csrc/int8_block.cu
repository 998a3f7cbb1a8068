// K2, K3, K4a, K4b, K5: the chained int8 transformer-block GEMMs and the
// focal qkv GEMM, written for Hopper.
//
// Replaces, in cognitive_aim_tpu/kernels/int8_block.py:
//   K2  int8_qkv_proj_ln            (body _qkv_ln_split_kernel)
//   K5  int8_qkv_proj               (body _qkv_split_kernel)
//   K3  int8_out_residual           (body _out_res_kernel)
//   K4a int8_fc1_gelu_ln            (body _fc1_ln_kernel)
//   K4b int8_out_residual_prequant  (body _out_res_prequant_kernel)
// and, as K4a followed by K4b, K4 int8_mlp_ln (body _mlp_ln_kernel);
//   K13 int8_proj                   (body _qkv_kernel)
//   K14 int8_fc1_gelu               (body _fc1_kernel): K4a without the layernorm
// and, in cognitive_aim_tpu/kernels/int8_gemm.py,
//   K15 int8_gemm_fused             (body _kernel): K13's function on rows
//                                   flattened to [M, K].
//
// All of them are one int8 GEMM, acc[m][n] = sum_k a[m][k] w[n][k] in int32 on
// the tensor cores (wgmma m64nBNk32), between a prologue that makes the
// int8 A operand and an epilogue that consumes the accumulators:
//   prologue  quant_rows_kernel<LN>: one warp per row of the bf16 input;
//             optional layernorm in f32 (variance as the mean of squared
//             deviations, two passes over the row held in registers), then
//             s = max(max|x| / 127, 1e-12), q = clip(rint(x / s)) with a
//             true division, on the f32 value. Writes int8 [M, K] + f32 [M].
//             K4b takes its int8 input and scales as they are. Rows wider
//             than 1024 (K13 at the fc2 shape, K 3072) go through
//             quant_rows_wide_kernel: the same arithmetic without the
//             layernorm, the row read twice (maximum, then quantise; the
//             second read is served by L1/L2) instead of held in registers.
//             quant_rows_pair_kernel quantises one or two tensors' rows
//             without layernorm in one launch: K10's q and k, for no GEMM;
//             quant_heads_pair_kernel the same per (row, head): K9's.
//   epilogue  kQKV:       acc * s_x * s_w + b -> bf16, split at columns D and
//                         2D into three contiguous [M, D] tensors;
//             kResidual:  res + ls * (acc * s_x * s_w + b) -> bf16;
//             kPlain:     acc * s_x * s_w + b -> bf16 [M, N], unsplit (K13, K15).
// K4a and K14 run a GEMM of their own after the same
// prologue: fc1_gelu_quant_kernel, tanh-GELU and the requantisation over the
// whole F-wide row in its epilogue (its notes below).
// Every f32 step is written with round-to-nearest intrinsics, so no
// multiply-add is contracted: the values are those of the plain PyTorch
// version on the same int8 inputs.
//
// The TPU kernels kept a whole weight and a 352- or 704-row activation tile
// in 16 MB of VMEM. An SM has 227 KB, so the GEMM (int8_gemm_tma_kernel, its
// notes below) streams 128-deep slices of A and W through a TMA ring into
// persistent CTAs that each own a 128-row output tile at a time; the weights
// (<= 2.4 MB) and the int8 A operand (8.4 MB at M 10960) stay in the 50 MB L2.
// Rows are independent, so [B, N, K] is flattened to [B N, K] and only the
// last row tile is ragged: the tensor maps read its rows past M as zeros and
// store none of them. K4a needs each row's maximum over all F GELU outputs
// before it can quantise one of them; fc1_gelu_quant_kernel finds it on chip,
// in one GEMM pass. The int8 activations make one trip through L2 between
// the prologue kernel and the GEMM (~0.013 ms a prologue at M 10960).
// K12, the post-attention half of the block in one kernel, is
// int8_fused_block.cu.
#include "tile_common.cuh"

namespace caim {

constexpr int BK = 128;             // contraction depth of a stage: one 128-byte
                                    // swizzled row of int8
constexpr int MAX_QUANT_K = 1024;   // widest row quant_rows_kernel holds in registers
constexpr int QUANT_THREADS = 256;  // 8 rows a block

enum Epilogue : int { kQKV = 0, kResidual = 1, kPlain = 2 };

struct GemmArgs {
  const int8_t* a;    // [M, K] int8 activations
  const float* sa;    // [M] their row scales
  const int8_t* w;    // [N, K] int8 weights
  const float* ws;    // [N] per-output-channel scales
  const float* bias;  // [N]
  int M, K, N;
  bf16* out;          // kQKV: [3, M, D]; kResidual, kPlain: [M, N]
  int D;              // kQKV: width of each of q, k, v (a multiple of the tile's BN)
  const bf16* res;    // kResidual: [M, N]
  const float* ls;    // kResidual: [N]
};

// (the f32 arithmetic, dequant, quant_scale, quant_value, quant_pack4 and
// gelu_tanh: tile_common.cuh)

// ------------------------------------------------------------ prologue -----
// eight consecutive values of a row (16-byte aligned at p) as f32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}

// Row `row` of x [M, K], K <= MAX_QUANT_K, quantised by one warp (lane
// `lane`) into the same row of xq and sx[row]
template <bool LN>
__device__ __forceinline__ void quant_row(const bf16* __restrict__ x, const float* __restrict__ gamma,
                                          const float* __restrict__ beta, float eps,
                                          int8_t* __restrict__ xq, float* __restrict__ sx,
                                          int row, int K, int lane) {
  constexpr int CH = MAX_QUANT_K / 256;  // 8-element chunks a lane may hold
  const bf16* xr = x + (size_t)row * K;
  float v[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int k = i * 256 + lane * 8;
    if (k < K) {
      load8(xr + k, v[i]);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) v[i][t] = 0.0f;
    }
  }
  if constexpr (LN) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int t = 0; t < 8; ++t) s += v[i][t];  // entries past K are 0
    const float mean = __fdiv_rn(warp_sum(s), (float)K);
    float d2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i * 256 + lane * 8 < K) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float d = __fsub_rn(v[i][t], mean);
          d2 = __fadd_rn(d2, __fmul_rn(d, d));
        }
      }
    }
    const float var = __fdiv_rn(warp_sum(d2), (float)K);
    const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int k = i * 256 + lane * 8;
      if (k < K) {
        __align__(16) float gb[16];
        *reinterpret_cast<float4*>(gb) = *reinterpret_cast<const float4*>(gamma + k);
        *reinterpret_cast<float4*>(gb + 4) = *reinterpret_cast<const float4*>(gamma + k + 4);
        *reinterpret_cast<float4*>(gb + 8) = *reinterpret_cast<const float4*>(beta + k);
        *reinterpret_cast<float4*>(gb + 12) = *reinterpret_cast<const float4*>(beta + k + 4);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[i][t] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(v[i][t], mean), rs), gb[t]), gb[8 + t]);
      }
    }
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[i][t]));
  const float s = quant_scale(warp_max(amax));
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int k = i * 256 + lane * 8;
    if (k < K) {
      *reinterpret_cast<uint2*>(xq + (size_t)row * K + k) =
          make_uint2(quant_pack4(v[i][0], v[i][1], v[i][2], v[i][3], s),
                     quant_pack4(v[i][4], v[i][5], v[i][6], v[i][7], s));
    }
  }
  if (lane == 0) sx[row] = s;
}

template <bool LN>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float eps, int8_t* __restrict__ xq,
                  float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
  launch_dependents();  // the GEMM that reads xq, sx may be scheduled now
  if (row >= M) return;
  quant_row<LN>(x, gamma, beta, eps, xq, sx, row, K, threadIdx.x % 32);
}

// gridDim.y bf16 tensors (one or two) of M rows each, without layernorm, in
// one launch (blockIdx.y picks the tensor): the int8-QK^T attention's q and k
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_pair_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ x1,
                       int8_t* __restrict__ xq0, int8_t* __restrict__ xq1,
                       float* __restrict__ sx0, float* __restrict__ sx1, int M, int K) {
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const bool second = blockIdx.y != 0;
  quant_row<false>(second ? x1 : x0, nullptr, nullptr, 0.0f, second ? xq1 : xq0,
                         second ? sx1 : sx0, row, K, threadIdx.x % 32);
}

// Row `row` = b N + n of x [B N, K] (K = H 64 <= MAX_QUANT_K) quantised per
// head, over each head's 64 values, by one warp (lane `lane`) into the same
// row of xq and sx [B, H, N] at (b H + head) N + n (head-major: the attention
// program stages a key tile's 64 scales of one head from contiguous memory):
// quant_row's arithmetic on each head's slice. A lane holds 8 values of a
// chunk of 256, so the 8 lanes 8 (lane / 8) .. + 7 hold one head and reduce
// its maximum among themselves.
__device__ __forceinline__ void quant_row_heads(const bf16* __restrict__ x,
                                                int8_t* __restrict__ xq, float* __restrict__ sx,
                                                int row, int K, int N, int lane) {
  const int H = K / 64;
  float* srow = sx + (size_t)(row / N) * H * N + row % N;  // head 0's scale of the row
  constexpr int CH = MAX_QUANT_K / 256;
  const bf16* xr = x + (size_t)row * K;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int k = i * 256 + lane * 8;
    if (i * 256 >= K) break;  // the same for every lane
    float v[8], amax = 0.0f;
    if (k < K) {
      load8(xr + k, v);
#pragma unroll
      for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (k < K) {
      const float s = quant_scale(amax);
      *reinterpret_cast<uint2*>(xq + (size_t)row * K + k) =
          make_uint2(quant_pack4(v[0], v[1], v[2], v[3], s), quant_pack4(v[4], v[5], v[6], v[7], s));
      if ((lane & 7) == 0) srow[(size_t)(k / 64) * N] = s;
    }
  }
}

// quant_rows_pair_kernel per (row, head): K9's q and k, N rows a batch
__global__ void __launch_bounds__(QUANT_THREADS)
quant_heads_pair_kernel(const bf16* __restrict__ x0, const bf16* __restrict__ x1,
                        int8_t* __restrict__ xq0, int8_t* __restrict__ xq1,
                        float* __restrict__ sx0, float* __restrict__ sx1, int M, int K, int N) {
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const bool second = blockIdx.y != 0;
  quant_row_heads(second ? x1 : x0, second ? xq1 : xq0, second ? sx1 : sx0, row, K, N,
                  threadIdx.x % 32);
}

// Rows of any width K (a multiple of 8), no layernorm: the row is read
// twice, once for its maximum and once to quantise.
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_wide_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                       float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
  launch_dependents();  // the GEMM that reads xq, sx may be scheduled now
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * K;
  float amax = 0.0f;
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(v[t]));
  }
  const float s = quant_scale(warp_max(amax));
  for (int k = lane * 8; k < K; k += 256) {
    float v[8];
    load8(xr + k, v);
    *reinterpret_cast<uint2*>(xq + (size_t)row * K + k) =
        make_uint2(quant_pack4(v[0], v[1], v[2], v[3], s), quant_pack4(v[4], v[5], v[6], v[7], s));
  }
  if (lane == 0) sx[row] = s;
}

// ---------------------------------------------------------------- GEMM -----
// One program for every epilogue: K2, K5 (kQKV), K3, K4b (kResidual), K13,
// K15 (kPlain).
//   * A CTA is a producer warp and two consumer warpgroups. It owns a 128-row
//     x BN-column output tile at a time (BN 192 or 128: gemm_tile_cols) and walks the tiles t = blockIdx.x, + gridDim.x, ...
//     row-tile-major, one CTA an SM: the CTAs at work hold a few neighbouring
//     row tiles, whose A slices every column tile reads from L2 while they
//     are there.
//   * Mainloop: the producer loads 128-deep slices of the A tile (rows past M
//     read as zeros by the tensor map) and of BN weight rows by TMA into a
//     ring of up to 6 stages behind full / empty mbarriers, running on into
//     the next tile while the consumers are in an epilogue. Each consumer
//     warpgroup runs wgmma m64nBNk32 on its 64 rows straight from the ring,
//     one group in flight, and releases a stage once its group is done.
//   * Epilogue from the accumulators in registers: dequantise, apply the
//     residual, pack to bf16 into a staging tile in shared memory (each
//     warpgroup its 64 rows, boxes of 64 rows x 128 bytes in the 128-byte
//     swizzle; four 8 x 8 tiles of the accumulator fragment a stmatrix, which
//     fall on distinct banks), then one thread of the warpgroup stores them
//     with 2-D TMA stores through a tensor map of exactly M rows: nothing past
//     M is written. The store runs on during the next tile's mainloop; its
//     thread waits for it to have read the staging rows at the next
//     epilogue. The residual epilogues have the producer load the next
//     residual tile by TMA into the staging rows once they are free (its
//     thread waits for the store after the next tile's first wgmma group),
//     so that it lands during the mainloop, and each thread reads its
//     residual values (ldmatrix) where it then writes its outputs.
//   * Launched as a programmatic dependent of the quantising prologue, which
//     lets it be scheduled at its start: the CTAs set up (barriers, tensor
//     maps) while the prologue's last blocks run, and wait for it to end
//     before they read.
// What bounds it at the slice's shapes (M 10960, D 768, F 3072): K2 and K5
// 38.8 GOP against 69 MB (20 us at the int8 peak, 21 us at the memory rate;
// the bf16 q, k, v written are 73% of the bytes), K3 12.9 GOP against 51 MB
// (15 us, bytes), K4b 51.7 GOP against 70 MB (26 us, operations). A 128 x 192
// tile reads 40 KB from L2 per 128-deep slice, 0.0065 bytes an operation:
// 12.9 TB/s at the int8 peak, more than L2 delivers to the SMs. Yet fewer
// bytes did not pay: measured slower or no faster on an H100 (development
// builds) were a 2-CTA cluster along M sharing each weight slice by TMA
// multicast (28 KB a slice and CTA), two wgmma groups in flight, a ring of
// 4 stages in place of 6, and 128-column tiles everywhere; 192-column tiles
// everywhere were slower at N 768 and 3072, hence gemm_tile_cols.
constexpr int BM = 128;                // rows of a tile: two warpgroups of 64
constexpr int GEMM_THREADS = 256 + 32; // two consumer warpgroups, a producer warp
constexpr int GEMM_MAX_STAGES = 6;
constexpr int BOX_BYTES = 64 * 128;    // a staging box: 64 rows of 128 bytes
constexpr int GEMM_TILE_COLS[] = {192, 128};

// Columns of the GEMM's output tile for M rows and N output columns made of
// `parts` equal outputs (kQKV: q, k, v, so that a tile lies within one of
// them), on a card of `sms` SMs (one CTA an SM): of the widths of
// GEMM_TILE_COLS that divide N / parts, the one whose tiles cost the least
// counted in rounds of `sms` tiles times the tile's width, ceil(tiles / sms)
// BN, the wider on a tie; 0 where none divides. A 192-column tile reads A from
// L2 fewer times and runs fewer epilogues, a 128-column one fills the last
// round better: at M 10960 on 132 SMs, 192 for the qkv GEMMs (N 2304: 8
// rounds either way), 128 for N 768 (4 rounds of 128 against 3 of 192) and
// 3072; ViT-L's 1024 and 4096 take 128 only. kernels/int8_block.py
// gemm_tile_cols is this rule; a card test holds the two equal.
int gemm_tile_cols(int M, int N, int parts, int sms) {
  if (M <= 0 || N <= 0 || parts <= 0 || N % parts != 0 || sms <= 0) return 0;
  const long long row_tiles = (M + BM - 1) / BM;
  int best = 0;
  long long best_cost = 0;
  for (int bn : GEMM_TILE_COLS) {
    if ((N / parts) % bn != 0) continue;
    const long long cost = (row_tiles * (N / bn) + sms - 1) / sms * bn;
    if (best == 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int EPI, int BN>
struct GemmTile {
  static constexpr bool RES = EPI == kResidual;  // reads a bf16 residual [M, N]
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE = A_BYTES + BN * BK;
  static constexpr int HALF = 64 * BN * 2;  // a warpgroup's staging rows: its 64 bf16 rows
  static constexpr int BOXES = BN * 2 / 128;  // staging boxes of a row (out and residual)
  static constexpr int FIXED = 2 * HALF + 1024 + 64;  // + alignment + barriers
  static constexpr int FIT = (int)((MAX_SMEM - FIXED) / STAGE);
  static constexpr int STAGES = FIT < GEMM_MAX_STAGES ? FIT : GEMM_MAX_STAGES;
  static constexpr int STAGING_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = STAGING_OFF + 2 * HALF;
  static constexpr size_t SMEM = (size_t)BAR_OFF + (2 * STAGES + 4) * 8 + 1024;
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "ring and staging tile fit");
  static_assert(BN * 2 % 128 == 0, "whole staging boxes");
};

struct GemmMaps {
  CUtensorMap a;       // int8 [M, K], boxes of BK x BM
  CUtensorMap w;       // int8 [N, K], boxes of BK x BN
  CUtensorMap out[3];  // the output [M, N] (kQKV: q, k, v [M, D]), boxes of 128 bytes x 64 rows
  CUtensorMap res;     // the residual epilogues: [M, N], boxes as out
};

// byte offset in a warpgroup's staging rows of row r (< 64), byte column bc:
// boxes of 128-byte columns, each 64 rows in the 128-byte swizzle
__device__ __forceinline__ int staging_offset(int r, int bc) {
  return (bc >> 7) * BOX_BYTES + r * 128 + ((((bc >> 4) & 7) ^ (r & 7)) << 4) + (bc & 15);
}

template <int EPI, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
int8_gemm_tma_kernel(const __grid_constant__ GemmMaps maps, const GemmArgs p) {
  using T = GemmTile<EPI, BN>;
  constexpr bool RES = T::RES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the address: start on a 1024-byte boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;
  uint64_t* res_full = empty + T::STAGES;  // [2]: a warpgroup's residual rows landed
  uint64_t* res_free = res_full + 2;       // [2]: its last store has read its staging rows
  const int n_tiles = p.N / BN, tiles = (p.M + BM - 1) / BM * n_tiles;
  const int KT = p.K / BK, tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    prefetch_tensormap(&maps.a);
    prefetch_tensormap(&maps.w);
    for (int h = 0; h < 2; ++h) {
      mbar_init(&res_full[h], 1);
      mbar_init(&res_free[h], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // launched as a programmatic dependent of the quantising prologue, the CTA
  // may start while the prologue runs: nothing it wrote is read before it is done
  wait_for_prerequisite_grids();

  if (tid >= 256) {  // ---- producer warp
    if (tid == 256) {
      const int fill = KT < T::STAGES ? KT : T::STAGES;
      int it = 0;  // slices loaded, over all of this CTA's tiles
      for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % T::STAGES;
          mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);  // released by both warpgroups
          unsigned char* st = smem + (size_t)s * T::STAGE;
          mbar_arrive_expect_tx(&full[s], T::STAGE);
          tma_load_2d(st, &maps.a, &full[s], kt * BK, m0);
          tma_load_2d(st + T::A_BYTES, &maps.w, &full[s], kt * BK, n0);
          if constexpr (RES) {
            // the ring holds this tile's first slices: its residual next, into
            // each warpgroup's staging rows once the last tile's store has read them
            if (kt == fill - 1) {
              for (int h = 0; h < 2; ++h) {
                if (i > 0) mbar_wait(&res_free[h], (i - 1) & 1);
                unsigned char* rows = smem + T::STAGING_OFF + h * T::HALF;
                if (m0 + 64 * h < p.M) {
                  mbar_arrive_expect_tx(&res_full[h], T::BOXES * BOX_BYTES);
                  for (int b = 0; b < T::BOXES; ++b)
                    tma_load_2d(rows + b * BOX_BYTES, &maps.res, &res_full[h], n0 + b * 64,
                                m0 + 64 * h);
                } else {
                  mbar_arrive(&res_full[h]);  // rows all past M: nothing to read or store
                }
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows wg 64 .. + 63 of each tile
  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  unsigned char* rows = smem + T::STAGING_OFF + wg * T::HALF;
  // a stage is released by lane 0 of each warp once the warp's wgmma group
  // that read it is done
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int acc[BN / 2];
  int it = 0;  // slices consumed
  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    const int row0 = m0 + wg * 64;
#pragma unroll
    for (int q = 0; q < BN / 2; ++q) acc[q] = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int s = it % T::STAGES;
      mbar_wait(&full[s], (it / T::STAGES) & 1);
      const unsigned char* st = smem + (size_t)s * T::STAGE;
      const uint64_t da = wgmma_desc_sw128(st + wg * 64 * BK);
      const uint64_t db = wgmma_desc_sw128(st + T::A_BYTES);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks) wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      if constexpr (RES) {
        if (kt == 0 && i > 0 && wtid == 0) {  // free the rows for the next residual
          tma_store_wait_read();              // once the last tile's store has read them
          mbar_arrive(&res_free[wg]);
        }
      }
      __syncwarp();
      wgmma_wait<1>();  // slice kt - 1's group is done: its stage may be refilled
      fence_operands(acc);
      if (kt > 0) release((it - 1) % T::STAGES);
    }
    wgmma_wait<0>();
    fence_operands(acc);
    release((it - 1) % T::STAGES);

    // ---- epilogue: rows row0 + r0 (+ 8), columns n0 + 8j + 2c (+ 1)
    float sx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r0 + 8 * h;
      sx[h] = row < p.M ? p.sa[row] : 0.0f;
    }
    if constexpr (RES) {
      mbar_wait(&res_full[wg], i & 1);  // the residual rows landed (the last store read them)
    } else {
      if (wtid == 0) tma_store_wait_read();  // the last tile's store has read the rows
      named_barrier_sync(1 + wg, 128);
    }
    // bf16 out (and residual): the 8 x 8 tiles of columns 8j.. of rows
    // warp 16 (+ 8) and of the next j moved by one stmatrix (one ldmatrix)
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      unsigned char* at = rows + staging_offset(warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                (j + (lane >> 4)) * 16);
      uint32_t rv[4], ov[4];
      if constexpr (RES) ldsm_x4(rv, at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // columns 8 (j + e) + 2c (+ 1): tiles 2e, 2e + 1
        const int jq = j + e, col = 8 * jq + 2 * c;
        const float2 w2 = *reinterpret_cast<const float2*>(p.ws + n0 + col);
        const float2 b2 = *reinterpret_cast<const float2*>(p.bias + n0 + col);
        float2 l2 = make_float2(0.0f, 0.0f);
        if constexpr (RES) l2 = *reinterpret_cast<const float2*>(p.ls + n0 + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows + 8 h: tile 2e + h
          float y0 = dequant(acc[4 * jq + 2 * h], sx[h], w2.x, b2.x);
          float y1 = dequant(acc[4 * jq + 2 * h + 1], sx[h], w2.y, b2.y);
          if constexpr (RES) {
            const float2 r2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[2 * e + h]));
            y0 = __fadd_rn(r2.x, __fmul_rn(l2.x, y0));
            y1 = __fadd_rn(r2.y, __fmul_rn(l2.y, y1));
          }
          ov[2 * e + h] = pack_bf16(y0, y1);
        }
      }
      stsm_x4(at, ov);
    }
    fence_proxy_async();  // the staging rows, written here, are read by TMA
    named_barrier_sync(1 + wg, 128);
    if (wtid == 0 && row0 < p.M) {
      const CUtensorMap* om = &maps.out[0];
      int ocol = n0;
      if constexpr (EPI == kQKV) {  // a column tile lies within one of q, k, v
        const int which = n0 / p.D;
        om = &maps.out[which];
        ocol = n0 - which * p.D;
      }
#pragma unroll
      for (int b = 0; b < T::BOXES; ++b)
        tma_store_2d(om, rows + b * BOX_BYTES, ocol + b * 64, row0);
      tma_store_commit();
    }
  }
  if (wtid == 0) tma_store_wait_all();  // before the CTA's shared memory goes
}

// ------------------------------------------ K4a, K14: one GEMM pass -----
// h = gelu_tanh(acc s_x s_w + b) over a whole row of F columns, quantised with
// that row's scale s = max(max|h| / 127, 1e-12): int8 h8 [M, F] and f32 sh [M].
// Replaces the TPU body _fc1_ln_kernel's GEMM, GELU and requantisation (the
// layernorm and the first quantisation are the prologue above).
//
// The row's maximum over all F GELU outputs is needed before any of them can
// be quantised, so one thread-block cluster owns a 64-row tile and all F
// columns: C CTAs (C = F / (2 NW) <= 8, the portable cluster size), each
// 2 NW columns, split between two consumer warpgroups of NW columns (NW =
// 192 at F 3072, 256 at F 4096: 96 or 128 int32 accumulators a thread; one
// CTA an SM).
//   * Mainloop: a producer warp loads 128-deep slices of the int8 A tile (64
//     rows) and of the CTA's 2 NW weight rows by TMA (128-byte swizzle, rows
//     past M read as zeros) into a ring of up to 4 stages behind full / empty
//     mbarriers; each consumer warpgroup runs wgmma m64nNWk32 straight from
//     the ring, one group in flight, releasing a stage once its group is done.
//   * Epilogue on the accumulators in registers: dequantise, GELU (kept in
//     place as f32 bits), |h| reduced to a row maximum across the 4 lanes of
//     a row (shuffles), the two warpgroups (shared memory), and the cluster:
//     each CTA leaves its 64 maxima in its shared memory, barrier.cluster,
//     then every CTA reads its peers' through distributed shared memory
//     (mapa + ld.shared::cluster); a second barrier.cluster before any CTA
//     exits keeps its shared memory alive while a peer reads. Then quantise
//     from registers into a staging tile in the free ring (rows padded by 16
//     bytes: the 2-byte stores of a warp's 8 rows fall on distinct banks) and
//     store whole rows, 16 bytes a thread; CTA rank 0 writes sh. Rows past M
//     are never stored.
// What bounds it at M 10960, K 768, F 3072: 51.7 GOP of int8 products
// (0.026 ms at 1,979 TOP/s) against 53 MB in and out (0.016 ms). Beside the
// products, every 64-row tile reads the whole weight (2.4 MB) into shared
// memory, 0.46 GB a call, and the epilogue spends ~50 f32 instructions an
// output on the dequantisation, the tanh GELU and the quantising division
// (33.7 M outputs), which the tile's products do not overlap. Measured
// slower on an H100 or no faster: a persistent grid (the next tile's slices
// loading during the epilogue), clusters of 16 CTAs sharing A and W by
// multicast, two 128-thread CTAs an SM, three consumer warpgroups of 128
// columns, the weight slice held resident with two warpgroups taking tiles in
// turns, and 128-row CTAs whose two warpgroups share each weight stage.
constexpr int FC1_ROWS = 64;           // rows of a cluster's tile: one wgmma M
constexpr int FC1_THREADS = 256 + 32;  // two consumer warpgroups, a producer warp
constexpr int FC1_MAX_CLUSTER = 8;

template <int NW>
struct Fc1Tile {
  static constexpr int A_BYTES = FC1_ROWS * BK;
  static constexpr int STAGE = A_BYTES + 2 * NW * BK;  // A, then each warpgroup's W rows
  static constexpr int OUT_LD = 2 * NW + 16;           // row stride of the int8 staging tile
  static constexpr int RED_BYTES = 4 * FC1_ROWS * 4;   // f32 [2][64], [64], [64]
  static constexpr int FIXED = RED_BYTES + 2 * 4 * 8 + 1024;  // + barriers + alignment
  static constexpr int STAGES =
      (int)((MAX_SMEM - FIXED) / STAGE) < 4 ? (int)((MAX_SMEM - FIXED) / STAGE) : 4;
  static constexpr int RED_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr size_t SMEM = (size_t)BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "ring fits");
  static_assert(FC1_ROWS * OUT_LD <= STAGES * STAGE, "staging tile fits in the ring");
};

// columns of a consumer warpgroup at width F (a cluster of F / (2 NW) CTAs),
// 0 where no cluster of at most 8 CTAs splits F evenly. The instantiations:
// 64 up to F 1024, 192 at ViT-S's 1536 and ViT-B's 3072, 256 at ViT-L's 4096
// (kernels/int8_block.py FC1_WARPGROUP_COLS is this list; a card test holds
// the two equal)
int fc1_warpgroup_cols(int F) {
  for (int nw : {64, 192, 256})
    if (F > 0 && F % (2 * nw) == 0 && F / (2 * nw) <= FC1_MAX_CLUSTER) return nw;
  return 0;
}

template <int NW>
__global__ void __launch_bounds__(FC1_THREADS, 1)
fc1_gelu_quant_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tw, const float* __restrict__ sa,
                      const float* __restrict__ ws, const float* __restrict__ bias,
                      int8_t* __restrict__ h8, float* __restrict__ sh, int M, int K, int F) {
  using T = Fc1Tile<NW>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the address: start on a 1024-byte boundary
  // (the same offset in every CTA, so a peer's maxima lie where ours do)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + T::RED_OFF);  // [2][64] warpgroup maxima
  float* cta_max = red + 2 * FC1_ROWS;                        // [64], read by the peers
  float* row_scale = cta_max + FC1_ROWS;                      // [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;
  const int rank = blockIdx.x, csize = F / (2 * NW);  // the cluster spans the grid's x
  const int m0 = blockIdx.y * FC1_ROWS, n_cta = rank * 2 * NW;
  const int KT = K / BK, tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // launched as a programmatic dependent of the quantising prologue, the CTA
  // may start while the prologue runs: nothing it wrote is read before it is done
  wait_for_prerequisite_grids();

  if (tid >= 256) {  // ---- producer warp
    if (tid == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % T::STAGES;
        mbar_wait(&empty[s], ((kt / T::STAGES) & 1) ^ 1);  // released by both warpgroups
        unsigned char* st = smem + (size_t)s * T::STAGE;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
        tma_load_2d(st, &ta, &full[s], kt * BK, m0);
        tma_load_2d(st + T::A_BYTES, &tw, &full[s], kt * BK, n_cta);
        tma_load_2d(st + T::A_BYTES + NW * BK, &tw, &full[s], kt * BK, n_cta + NW);
      }
    }
    __syncwarp();
    cluster_arrive();  // the two barrier.cluster of the epilogue
    cluster_wait();
    cluster_arrive();
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg owns columns n_cta + wg NW .. + NW - 1
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  int acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % T::STAGES;
    mbar_wait(&full[s], (kt / T::STAGES) & 1);
    const unsigned char* st = smem + (size_t)s * T::STAGE;
    const uint64_t da = wgmma_desc_sw128(st);
    const uint64_t db = wgmma_desc_sw128(st + T::A_BYTES + wg * NW * BK);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) wgmma_s8<NW>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();  // slice kt - 1's group is done: its stage may be refilled
    fence_operands(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % T::STAGES]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // ---- epilogue: rows r0 and r0 + 8 of the tile, columns n0 + 8j + 2c (+ 1)
  const int r0 = warp * 16 + g, n0 = n_cta + wg * NW;
  float sx[2], rmax[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r0 + 8 * h;
    sx[h] = row < M ? sa[row] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = n0 + 8 * j + 2 * c;
    const float2 w2 = *reinterpret_cast<const float2*>(ws + col);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = gelu_tanh(dequant(acc[4 * j + 2 * h], sx[h], w2.x, b2.x));
      const float y1 = gelu_tanh(dequant(acc[4 * j + 2 * h + 1], sx[h], w2.y, b2.y));
      acc[4 * j + 2 * h] = __float_as_int(y0);
      acc[4 * j + 2 * h + 1] = __float_as_int(y1);
      rmax[h] = fmaxf(rmax[h], fmaxf(fabsf(y0), fabsf(y1)));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 lanes of a row
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
  }
  if (c == 0) {
    red[wg * FC1_ROWS + r0] = rmax[0];
    red[wg * FC1_ROWS + r0 + 8] = rmax[1];
  }
  named_barrier_sync(1, 256);  // the consumers of this CTA
  if (tid < FC1_ROWS) cta_max[tid] = fmaxf(red[tid], red[FC1_ROWS + tid]);
  cluster_arrive();  // every CTA's maxima are written ...
  cluster_wait();
  if (tid < FC1_ROWS) {  // ... and read here, from every CTA of the cluster
    float m = 0.0f;
    for (int q = 0; q < csize; ++q) m = fmaxf(m, ld_cluster_f32(cluster_map(cta_max + tid, q)));
    const float s = quant_scale(m);
    row_scale[tid] = s;
    if (rank == 0 && m0 + tid < M) sh[m0 + tid] = s;
  }
  cluster_arrive();  // this CTA reads no peer's shared memory from here on
  named_barrier_sync(1, 256);

  // quantise into the staging tile (the ring is free: every slice landed and
  // both warpgroups' products are done), then whole rows to h8
  int8_t* out_s = reinterpret_cast<int8_t*>(smem);
  const float s0 = row_scale[r0], s1 = row_scale[r0 + 8];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = h ? s1 : s0;
      const int q0 = quant_value(__int_as_float(acc[4 * j + 2 * h]), s);
      const int q1 = quant_value(__int_as_float(acc[4 * j + 2 * h + 1]), s);
      *reinterpret_cast<uint16_t*>(out_s + (r0 + 8 * h) * T::OUT_LD + wg * NW + 8 * j + 2 * c) =
          (uint16_t)((q0 & 0xff) | (q1 & 0xff) << 8);
    }
  }
  named_barrier_sync(1, 256);
  constexpr int CPR = 2 * NW / 16;  // 16-byte chunks of a row
  for (int i = tid; i < FC1_ROWS * CPR; i += 256) {
    const int r = i / CPR, ch = i % CPR;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(h8 + (size_t)(m0 + r) * F + n_cta + ch * 16) =
          *reinterpret_cast<const uint4*>(out_s + r * T::OUT_LD + ch * 16);
  }
  cluster_wait();  // the peers have read this CTA's maxima
}

// ------------------------------------------------------------- launches -----
cudaError_t launch_quant_rows(const void* x, const void* gamma, const void* beta, float eps,
                              void* xq, void* sx, int M, int K, cudaStream_t stream) {
  const int rows = QUANT_THREADS / 32;
  const dim3 grid((M + rows - 1) / rows);
  if (gamma != nullptr)
    quant_rows_kernel<true><<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), eps, static_cast<int8_t*>(xq),
        static_cast<float*>(sx), M, K);
  else if (K <= MAX_QUANT_K)
    quant_rows_kernel<false><<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), nullptr, nullptr, 0.0f, static_cast<int8_t*>(xq),
        static_cast<float*>(sx), M, K);
  else
    quant_rows_wide_kernel<<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  return cudaGetLastError();
}

// x1 null: x0 alone; heads_n > 0: per (row, head) of 64 values, heads_n rows
// a batch (scales [B, H, N])
cudaError_t launch_quant_rows_pair(const void* x0, const void* x1, void* xq0, void* xq1,
                                   void* sx0, void* sx1, int M, int K, int heads_n,
                                   cudaStream_t stream) {
  const int rows = QUANT_THREADS / 32;
  const dim3 grid((M + rows - 1) / rows, x1 != nullptr ? 2 : 1);
  const bf16 *a = static_cast<const bf16*>(x0), *b = static_cast<const bf16*>(x1);
  int8_t *qa = static_cast<int8_t*>(xq0), *qb = static_cast<int8_t*>(xq1);
  float *sa = static_cast<float*>(sx0), *sb = static_cast<float*>(sx1);
  if (heads_n > 0)
    quant_heads_pair_kernel<<<grid, QUANT_THREADS, 0, stream>>>(a, b, qa, qb, sa, sb, M, K,
                                                                heads_n);
  else
    quant_rows_pair_kernel<<<grid, QUANT_THREADS, 0, stream>>>(a, b, qa, qb, sa, sb, M, K);
  return cudaGetLastError();
}

// SMs of the current device, found once per device
cudaError_t device_sms(int* n) {
  static std::atomic<int> found[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = found[dev & 63].load(std::memory_order_relaxed);
  if (v == 0) {
    if ((err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    found[dev & 63].store(v, std::memory_order_relaxed);
  }
  *n = v;
  return cudaSuccess;
}

// CTAs of the GEMM that the current device holds at once (SMs x CTAs an SM),
// found once per device and instantiation; the grid of a launch is at most
// that many: persistent CTAs, each walking several tiles.
template <int EPI, int BN>
cudaError_t gemm_resident_ctas(int* n) {
  static std::atomic<int> found[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = found[dev & 63].load(std::memory_order_relaxed);
  if (v == 0) {
    static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
    const void* kernel = (const void*)int8_gemm_tma_kernel<EPI, BN>;
    int sms = 0, per_sm = 0;
    if ((err = smem_allowance_once(smem_set, kernel, GemmTile<EPI, BN>::SMEM)) != cudaSuccess ||
        (err = device_sms(&sms)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, GEMM_THREADS, GemmTile<EPI, BN>::SMEM)) != cudaSuccess)
      return err;
    v = sms * per_sm;
    found[dev & 63].store(v, std::memory_order_relaxed);
  }
  *n = v;
  return v > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int EPI, int BN>
cudaError_t launch_gemm_cols(const GemmArgs& p, cudaStream_t stream) {
  using T = GemmTile<EPI, BN>;
  int ctas = 0;
  cudaError_t err = gemm_resident_ctas<EPI, BN>(&ctas);  // sets the allowance too
  if (err != cudaSuccess) return err;
  constexpr auto BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  GemmMaps maps{};
  bool ok = encode_2d(&maps.a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.a, p.M, p.K, BK, BM) &&
            encode_2d(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.w, p.N, p.K, BK, BN);
  if constexpr (EPI == kQKV) {
    for (int q = 0; q < 3; ++q)
      ok = ok && encode_2d(&maps.out[q], BF16, 2, p.out + (size_t)q * p.M * p.D, p.M, p.D, 64,
                           64);
  } else {
    ok = ok && encode_2d(&maps.out[0], BF16, 2, p.out, p.M, p.N, 64, 64);
  }
  if constexpr (T::RES) ok = ok && encode_2d(&maps.res, BF16, 2, p.res, p.M, p.N, 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  const int tiles = (p.M + BM - 1) / BM * (p.N / BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles < ctas ? tiles : ctas);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;  // may start before the kernel ahead of it on the stream ends
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_tma_kernel<EPI, BN>, maps, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  switch (gemm_tile_cols(p.M, p.N, EPI == kQKV ? 3 : 1, sms)) {
    case 192: return launch_gemm_cols<EPI, 192>(p, stream);
    case 128: return launch_gemm_cols<EPI, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// GemmArgs of a [M, K] x [N, K]^T product on quantised rows aq, sa.
GemmArgs gemm_args(const void* aq, const void* sa, const void* wq, const void* ws,
                   const void* bias, int M, int K, int N) {
  GemmArgs p{};
  p.a = static_cast<const int8_t*>(aq);
  p.sa = static_cast<const float*>(sa);
  p.w = static_cast<const int8_t*>(wq);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.M = M, p.K = K, p.N = N;
  return p;
}

// M rows, depth K, N output columns in `parts` equal outputs that the GEMM takes
bool gemm_shape_ok(int M, int K, int N, int parts = 1) {
  return K > 0 && K % BK == 0 && gemm_tile_cols(M, N, parts, 1) != 0;
}

}  // namespace caim

using caim::GemmArgs;

// Common to the entry points below: activations are bf16 [M, K] (or int8
// where said), weights int8 [N, K] with K contiguous, scales, biases,
// layernorm parameters and LayerScales f32; K and N multiples of 128; every
// pointer 16-byte aligned. xq [M, K] int8 and sx [M] f32 are scratch for the
// quantised activations. Each launches on `stream`, does not synchronize,
// and returns the first CUDA error of its launches (0: none).

// The quantising prologue alone, without layernorm, on one or two tensors in
// one launch (the int8-QK^T attention's q and k): x bf16 [M, K] -> xq int8
// [M, K], sx f32 [M] (s = max(max|x| / 127, 1e-12), q = clip(rint(x / s))),
// and likewise y -> yq, sy unless y is null. K a multiple of 8.
extern "C" int caim_quantize_rows(const void* x, const void* y, void* xq, void* yq, void* sx,
                                  void* sy, int M, int K, void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > caim::MAX_QUANT_K)
    return (int)cudaErrorInvalidValue;
  return (int)caim::launch_quant_rows_pair(x, y, xq, yq, sx, sy, M, K, 0,
                                           static_cast<cudaStream_t>(stream));
}

// The same per (row, head) over each head's 64 values (K9's q and k): x bf16
// [B, N, K] -> xq int8 [B, N, K], sx f32 [B, K / 64, N] (head-major), and y
// likewise unless null. K a multiple of 64 up to 1024.
extern "C" int caim_quantize_heads(const void* x, const void* y, void* xq, void* yq, void* sx,
                                   void* sy, int B, int N, int K, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || K % 64 != 0 || K > caim::MAX_QUANT_K)
    return (int)cudaErrorInvalidValue;
  return (int)caim::launch_quant_rows_pair(x, y, xq, yq, sx, sy, B * N, K, N,
                                           static_cast<cudaStream_t>(stream));
}

// The columns of the int8 GEMM's output tile for M rows and N output columns
// in `parts` equal outputs on a card of `sms` SMs (gemm_tile_cols), 0 where
// no tile width divides N / parts: no entry point takes that width.
extern "C" int caim_gemm_tile_cols(int M, int N, int parts, int sms) {
  return caim::gemm_tile_cols(M, N, parts, sms);
}

// How many CTAs of the int8 GEMM with tiles `cols` wide (the kPlain epilogue)
// the device holds at once, the most a launch starts (each then walks several
// tiles), or minus a CUDA error; 0 for a width that is not a tile width.
extern "C" int caim_gemm_resident_ctas(int cols) {
  using namespace caim;
  int n = 0;
  cudaError_t err = cudaSuccess;
  switch (cols) {
    case 192: err = gemm_resident_ctas<kPlain, 192>(&n); break;
    case 128: err = gemm_resident_ctas<kPlain, 128>(&n); break;
    default: break;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// K2 (gamma, beta given) and K5 (both null): x [M, D] -> qkv [3, M, D] bf16.
extern "C" int caim_int8_qkv(const void* x, const void* gamma, const void* beta, float eps,
                             const void* wq, const void* ws, const void* bias, void* qkv,
                             void* xq, void* sx, int M, int D, void* stream) {
  if (!caim::gemm_shape_ok(M, D, 3 * D, 3) || D > caim::MAX_QUANT_K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = caim::launch_quant_rows(x, gamma, beta, eps, xq, sx, M, D, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs p = caim::gemm_args(xq, sx, wq, ws, bias, M, D, 3 * D);
  p.D = D;
  p.out = static_cast<caim::bf16*>(qkv);
  return (int)caim::launch_gemm<caim::kQKV>(p, st);
}

// K3 (x bf16 [M, K] given: quantised into aq, sa first) and K4b (x null:
// aq int8 [M, K] and sa [M] are the input): out = res + ls * (a w^T + b),
// res and out bf16 [M, N].
extern "C" int caim_int8_out_residual(const void* x, void* aq, void* sa, const void* wq,
                                      const void* ws, const void* bias, const void* ls,
                                      const void* res, void* out, int M, int K, int N,
                                      void* stream) {
  if (!caim::gemm_shape_ok(M, K, N) || (x != nullptr && K > caim::MAX_QUANT_K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x != nullptr) {
    cudaError_t err = caim::launch_quant_rows(x, nullptr, nullptr, 0.0f, aq, sa, M, K, st);
    if (err != cudaSuccess) return (int)err;
  }
  GemmArgs p = caim::gemm_args(aq, sa, wq, ws, bias, M, K, N);
  p.ls = static_cast<const float*>(ls);
  p.res = static_cast<const caim::bf16*>(res);
  p.out = static_cast<caim::bf16*>(out);
  return (int)caim::launch_gemm<caim::kResidual>(p, st);
}

namespace caim {

// x bf16 [M, K] -> out bf16 [M, N] = quant(x) wq^T * s_x * s_w + bias.
int int8_linear(const void* x, void* xq, void* sx, const void* wq, const void* ws,
                const void* bias, void* out, int M, int K, int N, cudaStream_t st) {
  if (!gemm_shape_ok(M, K, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_quant_rows(x, nullptr, nullptr, 0.0f, xq, sx, M, K, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs p = gemm_args(xq, sx, wq, ws, bias, M, K, N);
  p.out = static_cast<bf16*>(out);
  return (int)launch_gemm<kPlain>(p, st);
}

template <int NW>
cudaLaunchConfig_t fc1_config(int M, int F, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F / (2 * NW), (M + FC1_ROWS - 1) / FC1_ROWS);
  cfg.blockDim = dim3(FC1_THREADS);
  cfg.dynamicSmemBytes = Fc1Tile<NW>::SMEM;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = F / (2 * NW);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NW>
cudaError_t fc1_smem_once() {
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  return smem_allowance_once(smem_set, (const void*)fc1_gelu_quant_kernel<NW>,
                             Fc1Tile<NW>::SMEM);
}

// Quantised rows xq [M, K], sx [M] -> h8 int8 [M, F], sh f32 [M]: one launch
template <int NW>
cudaError_t launch_fc1(const void* xq, const void* sx, const void* wq, const void* ws,
                       const void* bias, void* h8, void* sh, int M, int K, int F,
                       cudaStream_t st) {
  cudaError_t err = fc1_smem_once<NW>();
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tw;
  if (!encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, xq, M, K, BK, FC1_ROWS) ||
      !encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, F, K, BK, NW))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fc1_config<NW>(M, F, st, &attr);
  err = cudaLaunchKernelEx(&cfg, fc1_gelu_quant_kernel<NW>, ta, tw, static_cast<const float*>(sx),
                           static_cast<const float*>(ws), static_cast<const float*>(bias),
                           static_cast<int8_t*>(h8), static_cast<float*>(sh), M, K, F);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many of its clusters at width F the device runs at once
// (cudaOccupancyMaxActiveClusters)
template <int NW>
cudaError_t fc1_active_clusters(int F, int* n) {
  cudaError_t err = fc1_smem_once<NW>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = fc1_config<NW>(FC1_ROWS, F, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, fc1_gelu_quant_kernel<NW>, &cfg);
}

cudaError_t fc1_gelu_gemm(const void* xq, const void* sx, const void* wq, const void* ws,
                          const void* bias, void* h8, void* sh, int M, int K, int F,
                          cudaStream_t st) {
  switch (fc1_warpgroup_cols(F)) {
    case 64: return launch_fc1<64>(xq, sx, wq, ws, bias, h8, sh, M, K, F, st);
    case 192: return launch_fc1<192>(xq, sx, wq, ws, bias, h8, sh, M, K, F, st);
    case 256: return launch_fc1<256>(xq, sx, wq, ws, bias, h8, sh, M, K, F, st);
    default: return cudaErrorInvalidValue;
  }
}

bool fc1_shape_ok(int M, int K, int F) {
  return M > 0 && K > 0 && K % BK == 0 && fc1_warpgroup_cols(F) != 0;
}

// x [M, K] -> h8 int8 [M, F], sh f32 [M]; gamma and beta null: no layernorm.
int fc1_gelu(const void* x, const void* gamma, const void* beta, float eps, const void* wq,
             const void* ws, const void* bias, void* h8, void* sh, void* xq, void* sx, int M,
             int K, int F, cudaStream_t st) {
  if (!fc1_shape_ok(M, K, F) || (gamma != nullptr && K > MAX_QUANT_K))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_quant_rows(x, gamma, beta, eps, xq, sx, M, K, st);
  if (err != cudaSuccess) return (int)err;
  return (int)fc1_gelu_gemm(xq, sx, wq, ws, bias, h8, sh, M, K, F, st);
}

}  // namespace caim

// K4a: layernorm (gamma, beta, eps) -> quantise -> GEMM -> tanh GELU ->
// requantise over the whole row: the prologue, then one GEMM launch. F a
// width caim_fc1_cluster_size accepts.
extern "C" int caim_int8_fc1_gelu(const void* x, const void* gamma, const void* beta,
                                  float eps, const void* wq, const void* ws,
                                  const void* bias, void* h8, void* sh, void* xq, void* sx,
                                  int M, int K, int F, void* stream) {
  if (gamma == nullptr || beta == nullptr) return (int)cudaErrorInvalidValue;
  return caim::fc1_gelu(x, gamma, beta, eps, wq, ws, bias, h8, sh, xq, sx, M, K, F,
                        static_cast<cudaStream_t>(stream));
}

// K14: K4a without the layernorm.
extern "C" int caim_int8_fc1_gelu_rows(const void* x, const void* wq, const void* ws,
                                       const void* bias, void* h8, void* sh, void* xq,
                                       void* sx, int M, int K, int F, void* stream) {
  return caim::fc1_gelu(x, nullptr, nullptr, 0.0f, wq, ws, bias, h8, sh, xq, sx, M, K, F,
                        static_cast<cudaStream_t>(stream));
}

// The CTAs of the fc1 GEMM's cluster at width F (each 2 NW columns of a
// 64-row tile), 0 where no cluster of at most 8 CTAs splits F evenly.
extern "C" int caim_fc1_cluster_size(int F) {
  const int nw = caim::fc1_warpgroup_cols(F);
  return nw == 0 ? 0 : F / (2 * nw);
}

// How many of the fc1 GEMM's clusters at width F the device runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int caim_fc1_active_clusters(int F) {
  using namespace caim;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (fc1_warpgroup_cols(F)) {
    case 64: err = fc1_active_clusters<64>(F, &n); break;
    case 192: err = fc1_active_clusters<192>(F, &n); break;
    case 256: err = fc1_active_clusters<256>(F, &n); break;
    default: break;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// K13: x [B N, K] -> out [B N, Nout] = quant(x) wq^T * s_x * s_w + bias, rows of
// any width K that is a multiple of 128.
extern "C" int caim_int8_proj(const void* x, void* xq, void* sx, const void* wq,
                              const void* ws, const void* bias, void* out, int M, int K,
                              int N, void* stream) {
  return caim::int8_linear(x, xq, sx, wq, ws, bias, out, M, K, N,
                           static_cast<cudaStream_t>(stream));
}

// K15: the same function on rows already flattened to [M, K].
extern "C" int caim_int8_gemm_fused(const void* x, void* xq, void* sx, const void* wq,
                                    const void* ws, const void* bias, void* out, int M, int K,
                                    int N, void* stream) {
  return caim::int8_linear(x, xq, sx, wq, ws, bias, out, M, K, N,
                           static_cast<cudaStream_t>(stream));
}
