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
//   K12 int8_attnout_mlp_ln         (body _attnout_mlp_kernel): K3 then K4 with
//                                   the post-attention residual carried in f32
//                                   (the note above caim_int8_attnout_mlp)
// and, in cognitive_aim_tpu/kernels/int8_gemm.py,
//   K15 int8_gemm_fused             (body _kernel): K13's function on rows
//                                   flattened to [M, K].
//
// All of them are one int8 GEMM, acc[m][n] = sum_k a[m][k] w[n][k] in int32 on
// the tensor cores (wgmma m64n128k32), between a prologue that makes the
// int8 A operand and an epilogue that consumes the accumulators:
//   prologue  quant_rows_kernel<LN, T>: one warp per row of the bf16 input (K12's
//             second prologue: of the f32 residual stream);
//             optional layernorm in f32 (variance as the mean of squared
//             deviations, two passes over the row held in registers), then
//             s = max(max|x| / 127, 1e-12), q = clip(rint(x / s)) with a
//             true division, on the f32 value. Writes int8 [M, K] + f32 [M].
//             K4b takes its int8 input and scales as they are. Rows wider
//             than 1024 (K13 at the fc2 shape, K 3072) go through
//             quant_rows_wide_kernel: the same arithmetic without the
//             layernorm, the row read twice (maximum, then quantise; the
//             second read is served by L1/L2) instead of held in registers.
//   epilogue  kQKV:       acc * s_x * s_w + b -> bf16, split at columns D and
//                         2D into three contiguous [M, D] tensors;
//             kResidual:  res + ls * (acc * s_x * s_w + b) -> bf16;
//             kResidualToF32, kResidualFromF32 (K12): the same value left in
//                         f32 [M, N], and the same with res read as f32;
//             kPlain:     acc * s_x * s_w + b -> bf16 [M, N], unsplit (K13, K15).
// K4a, K14 and K12's fc1 stage run a GEMM of their own after the same
// prologue: fc1_gelu_quant_kernel, tanh-GELU and the requantisation over the
// whole F-wide row in its epilogue (its notes below).
// Every f32 step is written with round-to-nearest intrinsics, so no
// multiply-add is contracted: the values are those of the plain PyTorch
// version on the same int8 inputs.
//
// What bounds them on this card. At the slice's shapes (M = 8 x 1370 rows,
// D 768, F 3072) K2 and K5 are 38.8 GOP against 69 MB (20 us at the int8
// peak, 21 us at the memory rate), K3 12.9 GOP against 51 MB (memory-bound,
// 15 us), K4a and K4b 51.7 GOP each against 53 and 70 MB (operation-bound,
// 26 us); K15 on the adapter path is K5's shape, K13 one of the above by its
// widths, K14 K4a's. What the design does about it:
//   * The TPU kernel kept a whole weight and a 352- or 704-row activation
//     tile in 16 MB of VMEM. An SM has 227 KB, so a block owns a 128 x 128
//     output tile and streams 128-deep slices of A and W through a 3-stage
//     cp.async ring (97 KB; two blocks per SM). The weights (<= 2.4 MB) and
//     the int8 A operand (8.4 MB) stay in the 50 MB L2 across blocks; column
//     tiles of one row tile are neighbours in the grid.
//   * Two warpgroups, 64 rows each, run the products as wgmma straight from
//     shared memory: rows of 128 bytes in the 128-byte swizzle, which the
//     cp.async copies write (chunk ch of row r at chunk ch ^ (r & 7)); 64
//     int32 accumulators a thread. Each stage's wgmma group is waited for
//     before the next barrier; keeping one in flight measured no faster.
//   * Rows are independent, so [B, N, K] is flattened to [B N, K] and only
//     the last row tile is ragged: its rows are zero-filled on load and
//     never stored.
//   * The epilogue passes the f32 tile through the ring's shared memory
//     once the products are done, so that the bf16 and int8 outputs and the
//     residual are written and read as whole rows, 16 bytes a thread.
//   * K4a needs each row's maximum over all F GELU outputs before it can
//     quantise one of them; fc1_gelu_quant_kernel finds it on chip, in one
//     GEMM pass (its notes below).
//   * With 128 x 128 tiles every block pulls 32 KB from L2 per 128-deep
//     slice (400 MB a call for K4b, near what L2 delivers), and at K = 768 a
//     tile runs only 6 slices between a ring fill and an epilogue. A
//     persistent block whose producer warp prefetches the next tile through
//     TMA, larger tiles, or clusters sharing one multicast load are the next
//     step; so is quantising inside the GEMM block (the int8 activations
//     make one trip through L2 between the prologue kernel and the GEMM).
#include "tile_common.cuh"

namespace caim {

constexpr int BM = 128, BN = 128;   // output tile of a block
constexpr int BK = 128;             // contraction depth of a stage: one 128-byte
                                    // swizzled row of int8
constexpr int STAGES = 3;
constexpr int GEMM_THREADS = 256;   // 2 warpgroups, 64 rows x 128 columns each
constexpr int TILE_BYTES = BM * BK;  // one stage of one operand (BM == BN)
// the ring, plus room to start it on a 1024-byte boundary
constexpr size_t GEMM_SMEM = (size_t)STAGES * 2 * TILE_BYTES + 1024;
constexpr int LDC = BN + 8;         // row stride of the epilogue's f32 tile: 8-byte
                                    // stores of a half-warp fall on distinct banks
static_assert(BM == BN && (BM * LDC + BM) * sizeof(float) <= GEMM_SMEM - 1024,
              "epilogue tile fits");
constexpr int MAX_QUANT_K = 1024;   // widest row quant_rows_kernel holds in registers
constexpr int QUANT_THREADS = 256;  // 8 rows a block

enum Epilogue : int {
  kQKV = 0, kResidual = 1, kPlain = 2, kResidualToF32 = 3, kResidualFromF32 = 4
};

struct GemmArgs {
  const int8_t* a;    // [M, K] int8 activations
  const float* sa;    // [M] their row scales
  const int8_t* w;    // [N, K] int8 weights
  const float* ws;    // [N] per-output-channel scales
  const float* bias;  // [N]
  int M, K, N;
  bf16* out;          // kQKV: [3, M, D]; kResidual, kPlain: [M, N]
  int D;              // kQKV: width of each of q, k, v (a multiple of BN)
  const bf16* res;    // kResidual, kResidualToF32: [M, N]
  const float* ls;    // the residual epilogues: [N]
  float* xf;          // kResidualToF32 writes: [M, N] f32
  const float* resf;  // kResidualFromF32: the residual in f32 [M, N]
};

// ------------------------------------------------------ f32 arithmetic -----
// (dequant, quant_scale, quant_value, quant_pack4: tile_common.cuh)
// 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3))));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// ------------------------------------------------------------ prologue -----
// eight consecutive values of a row (16-byte aligned at p) as f32
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(e[t]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <bool LN, typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, float eps, int8_t* __restrict__ xq,
                  float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
  if (row >= M) return;
  constexpr int CH = MAX_QUANT_K / 256;  // 8-element chunks a lane may hold
  const T* xr = x + (size_t)row * K;
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

// Rows of any width K (a multiple of 8), no layernorm: the row is read
// twice, once for its maximum and once to quantise.
__global__ void __launch_bounds__(QUANT_THREADS)
quant_rows_wide_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                       float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (QUANT_THREADS / 32) + threadIdx.x / 32;
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
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2) int8_gemm_kernel(const GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the address: start on a 1024-byte boundary
  unsigned char* smem =
      smem_raw + ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM rows of 128 bytes]
  int8_t* Ws = As + (size_t)STAGES * TILE_BYTES; // [STAGES][BN rows of 128 bytes]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;  // warpgroup: rows wg * 64 .. + 63 of the tile
  const int g = lane >> 2, c = lane & 3;
  const int KT = p.K / BK;

  auto load_stage = [&](int stage, int kt) {
    const size_t k0 = (size_t)kt * BK;
    int8_t* as = As + (size_t)stage * TILE_BYTES;
    int8_t* wsm = Ws + (size_t)stage * TILE_BYTES;
    constexpr int CPR = BK / 16;  // 16-byte chunks a row
    for (int i = tid; i < BM * CPR; i += GEMM_THREADS) {
      const int r = i / CPR, ch = i % CPR;
      const int dst = r * BK + ((ch ^ (r & 7)) << 4);  // 128-byte swizzle
      const bool ok = m0 + r < p.M;  // rows past M: zero-filled, nothing read
      cp_async16(as + dst, p.a + (ok ? (size_t)(m0 + r) * p.K + k0 + ch * 16 : 0), ok);
      cp_async16(wsm + dst, p.w + (size_t)(n0 + r) * p.K + k0 + ch * 16, true);
    }
  };

  int acc[64];  // wgmma fragment of this warpgroup's 64 x 128 tile (tile_common.cuh)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's part of slice kt has landed
    fence_proxy_async();          // ... and is visible to wgmma
    __syncthreads();              // ... for every thread; slice kt - 1 is consumed
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int stage = kt % STAGES;
    const uint64_t da = wgmma_desc_sw128(As + (size_t)stage * TILE_BYTES + wg * 64 * BK);
    const uint64_t db = wgmma_desc_sw128(Ws + (size_t)stage * TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  // ---- epilogue. This thread's accumulators: rows m0 + wg 64 + w 16 + g
  // (+ 8), columns n0 + 8j + 2c (+ 1) for j < 16. Phase 1 turns them into
  // the f32 value y = acc s_x s_w + b; phase 2 reads whole rows back from
  // shared memory, so that every global load and store is 16 contiguous
  // bytes a thread and a full row of the tile a half-warp.
  const int row_l = wg * 64 + (warp % 4) * 16 + g;  // + h * 8
  __syncthreads();  // every warp is done with the pipeline's shared memory
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC] f32 tile

  float sx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + row_l + h * 8;
    sx[h] = row < p.M ? p.sa[row] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col_l = j * 8 + 2 * c;
    const float2 w2 = *reinterpret_cast<const float2*>(p.ws + n0 + col_l);
    const float2 b2 = *reinterpret_cast<const float2*>(p.bias + n0 + col_l);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = dequant(acc[4 * j + 2 * h], sx[h], w2.x, b2.x);
      const float y1 = dequant(acc[4 * j + 2 * h + 1], sx[h], w2.y, b2.y);
      *reinterpret_cast<float2*>(Cs + (row_l + h * 8) * LDC + col_l) = make_float2(y0, y1);
    }
  }
  __syncthreads();

  // phase 2: 8 columns a thread, 16 threads a row
  bf16* out = p.out;
  int ldo = p.N, ocol = n0;
  if constexpr (EPI == kQKV) {  // a column tile lies within one of q, k, v
    const int which = n0 / p.D;
    out += (size_t)which * p.M * p.D;
    ldo = p.D;
    ocol = n0 - which * p.D;
  }
  for (int idx = tid; idx < BM * (BN / 8); idx += GEMM_THREADS) {
    const int rl = idx / (BN / 8), cl = (idx % (BN / 8)) * 8;
    const int row = m0 + rl;
    if (row >= p.M) continue;
    __align__(16) float y[8];
    *reinterpret_cast<float4*>(y) = *reinterpret_cast<const float4*>(Cs + rl * LDC + cl);
    *reinterpret_cast<float4*>(y + 4) = *reinterpret_cast<const float4*>(Cs + rl * LDC + cl + 4);
    const size_t o = (size_t)row * ldo + ocol + cl;
    if constexpr (EPI == kResidual || EPI == kResidualToF32 || EPI == kResidualFromF32) {
      float r[8];
      if constexpr (EPI == kResidualFromF32)
        load8(p.resf + o, r);
      else
        load8(p.res + o, r);
      __align__(16) float l[8];
      *reinterpret_cast<float4*>(l) = *reinterpret_cast<const float4*>(p.ls + n0 + cl);
      *reinterpret_cast<float4*>(l + 4) = *reinterpret_cast<const float4*>(p.ls + n0 + cl + 4);
#pragma unroll
      for (int t = 0; t < 8; ++t) y[t] = __fadd_rn(r[t], __fmul_rn(l[t], y[t]));
    }
    if constexpr (EPI == kResidualToF32) {  // K12: the residual stream stays f32
      *reinterpret_cast<float4*>(p.xf + o) = *reinterpret_cast<const float4*>(y);
      *reinterpret_cast<float4*>(p.xf + o + 4) = *reinterpret_cast<const float4*>(y + 4);
    } else {
      *reinterpret_cast<uint4*>(out + o) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                     pack_bf16(y[6], y[7]));
    }
  }
}

// ------------------------------------- K4a, K14, K12's fc1: one GEMM pass -----
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
    quant_rows_kernel<true, bf16><<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), eps, static_cast<int8_t*>(xq),
        static_cast<float*>(sx), M, K);
  else if (K <= MAX_QUANT_K)
    quant_rows_kernel<false, bf16><<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), nullptr, nullptr, 0.0f, static_cast<int8_t*>(xq),
        static_cast<float*>(sx), M, K);
  else
    quant_rows_wide_kernel<<<grid, QUANT_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  return cudaGetLastError();
}

// The layernorm prologue on f32 rows [M, K], K <= MAX_QUANT_K (K12's second).
cudaError_t launch_quant_rows_ln_f32(const float* x, const void* gamma, const void* beta,
                                     float eps, void* xq, void* sx, int M, int K,
                                     cudaStream_t stream) {
  const int rows = QUANT_THREADS / 32;
  quant_rows_kernel<true, float><<<dim3((M + rows - 1) / rows), QUANT_THREADS, 0, stream>>>(
      x, static_cast<const float*>(gamma), static_cast<const float*>(beta), eps,
      static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  cudaError_t err =
      smem_allowance_once(smem_set, (const void*)int8_gemm_kernel<EPI>, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  int8_gemm_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(p);
  return cudaGetLastError();
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

bool gemm_shape_ok(int M, int K, int N) {
  return M > 0 && K > 0 && N > 0 && K % BK == 0 && N % BN == 0;
}

}  // namespace caim

using caim::GemmArgs;

// Common to the entry points below: activations are bf16 [M, K] (or int8
// where said), weights int8 [N, K] with K contiguous, scales, biases,
// layernorm parameters and LayerScales f32; K and N multiples of 128; every
// pointer 16-byte aligned. xq [M, K] int8 and sx [M] f32 are scratch for the
// quantised activations. Each launches on `stream`, does not synchronize,
// and returns the first CUDA error of its launches (0: none).

// The quantising prologue alone, without layernorm: x bf16 [M, K] -> xq int8
// [M, K], sx f32 [M] (s = max(max|x| / 127, 1e-12), q = clip(rint(x / s))).
// The int8-QK^T attention quantises q and k with it. K a multiple of 8.
extern "C" int caim_quantize_rows(const void* x, void* xq, void* sx, int M, int K,
                                  void* stream) {
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > caim::MAX_QUANT_K)
    return (int)cudaErrorInvalidValue;
  return (int)caim::launch_quant_rows(x, nullptr, nullptr, 0.0f, xq, sx, M, K,
                                      static_cast<cudaStream_t>(stream));
}

// K2 (gamma, beta given) and K5 (both null): x [M, D] -> qkv [3, M, D] bf16.
extern "C" int caim_int8_qkv(const void* x, const void* gamma, const void* beta, float eps,
                             const void* wq, const void* ws, const void* bias, void* qkv,
                             void* xq, void* sx, int M, int D, void* stream) {
  if (!caim::gemm_shape_ok(M, D, 3 * D) || D > caim::MAX_QUANT_K)
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
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)F};
  const cuuint64_t stride[1] = {(cuuint64_t)K};
  const cuuint32_t abox[2] = {BK, FC1_ROWS}, wbox[2] = {BK, NW};
  if (!encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, adims, stride, abox) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, stride, wbox))
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
  return gemm_shape_ok(M, K, F) && fc1_warpgroup_cols(F) != 0;
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

// K12: the whole post-attention half of the chained int8 block,
//   xf  = res + ls1 * (quant(ctx) wo^T * s * so + bo)                 (f32)
//   out = xf + ls2 * fc2(quant(gelu(fc1(quant(LN2(xf))))))            (one cast, at the end)
// ctx, res, out bf16 [M, K]; wo [K, K], w1 [F, K], w2 [K, F] int8; K <= 1024.
// Scratch: xf f32 [M, K]; aq int8 [M, K] and sa f32 [M] (ctx quantised, then
// LN2(xf) quantised); h8 int8 [M, F], sh f32 [M].
//
// Replaces cognitive_aim_tpu/kernels/int8_block.py int8_attnout_mlp_ln (body
// _attnout_mlp_kernel), one TPU program that keeps the three weights (5.2 MB)
// and a row tile's f32 residual and f32 hidden resident in VMEM. A thread block
// has 227 KB, and the requantisation needs a row's maximum over all F hidden
// columns before fc2 may start, so K12 here is a chain over this file's GEMM:
// quantise ctx -> GEMM (kResidualToF32) -> layernorm and quantise the f32 rows
// -> the fc1 GEMM (fc1_gelu_quant_kernel) -> GEMM (kResidualFromF32): five
// launches, as K3 followed by K4. What it lets through device memory that the TPU kernel
// kept on chip: the int8 activations and scales between each prologue and its
// GEMM, the int8 hidden and its scales (as K4 does), and the residual stream xf
// in f32, written once and read twice (33.7 MB at M 10960, inside the 50 MB
// L2), where K3 -> K4 moves the same rows rounded to bf16 (half the bytes).
// The arithmetic is the TPU kernel's: xf never rounds to bf16. Bound: 116 GOP
// of int8 products (0.059 ms at the peak) against 2 x 16.8 MB of activations
// in, 16.8 MB out and 5.3 MB of weights (0.017 ms): operations. Keeping xf on
// chip (a block owning a row tile across all K / 128 column tiles of attn_out,
// layernorm in its epilogue) is the next step.
extern "C" int caim_int8_attnout_mlp(const void* ctx, const void* wo, const void* so,
                                     const void* bo, const void* ls1, const void* res,
                                     const void* gamma, const void* beta, float eps,
                                     const void* w1, const void* s1, const void* b1,
                                     const void* w2, const void* s2, const void* b2,
                                     const void* ls2, void* out, void* xf, void* aq, void* sa,
                                     void* h8, void* sh, int M, int K, int F, void* stream) {
  using namespace caim;
  if (!gemm_shape_ok(M, K, K) || !fc1_shape_ok(M, K, F) || K > MAX_QUANT_K ||
      gamma == nullptr || beta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_quant_rows(ctx, nullptr, nullptr, 0.0f, aq, sa, M, K, st);
  if (err != cudaSuccess) return (int)err;
  GemmArgs p = gemm_args(aq, sa, wo, so, bo, M, K, K);
  p.ls = static_cast<const float*>(ls1);
  p.res = static_cast<const bf16*>(res);
  p.xf = static_cast<float*>(xf);
  err = launch_gemm<kResidualToF32>(p, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_quant_rows_ln_f32(static_cast<const float*>(xf), gamma, beta, eps, aq, sa, M, K,
                                 st);
  if (err != cudaSuccess) return (int)err;
  err = fc1_gelu_gemm(aq, sa, w1, s1, b1, h8, sh, M, K, F, st);
  if (err != cudaSuccess) return (int)err;
  p = gemm_args(h8, sh, w2, s2, b2, M, F, K);
  p.ls = static_cast<const float*>(ls2);
  p.resf = static_cast<const float*>(xf);
  p.out = static_cast<bf16*>(out);
  return (int)launch_gemm<kResidualFromF32>(p, st);
}
