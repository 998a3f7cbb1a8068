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
//             kPlain:     acc * s_x * s_w + b -> bf16 [M, N], unsplit (K13, K15);
//             kGeluMax:   max |tanh-GELU(acc * s_x * s_w + b)| per row and
//                         column tile -> f32 [M, N / 128];
//             kGeluQuant: the same GELU value again, quantised with the
//                         row's scale from those maxima -> int8 + f32 scale.
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
//     quantise one of them, and 128 rows x 3072 f32 is 1.5 MB. It runs the
//     GEMM and the GELU twice: once to reduce |h| to a maximum per row and
//     column tile, once more to quantise with the row's scale. That doubles
//     its tensor-core work but keeps the f32 hidden out of device memory
//     (268 MB of traffic a call otherwise) and the arithmetic exact: the
//     value quantised is the f32 GELU output, the scale its full-row maximum.
//     A thread-block cluster that holds the row in registers and exchanges
//     maxima through distributed shared memory would do it in one pass.
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
  kQKV = 0, kResidual = 1, kGeluMax = 2, kGeluQuant = 3, kPlain = 4,
  kResidualToF32 = 5, kResidualFromF32 = 6
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
  int8_t* h8;         // kGeluQuant: [M, N]
  float* sh;          // kGeluQuant: [M]
  float* partial;     // kGeluMax writes, kGeluQuant reads: [M, N / BN]
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
    for (int ks = 0; ks < BK / 32; ++ks) wgmma_s8_64x128x32(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  // ---- epilogue. This thread's accumulators: rows m0 + wg 64 + w 16 + g
  // (+ 8), columns n0 + 8j + 2c (+ 1) for j < 16. Phase 1 turns them into
  // the f32 value y = acc s_x s_w + b (the GELU epilogues: h = gelu(y));
  // phase 2 reads whole rows back from shared memory, so that every global
  // load and store is 16 contiguous bytes a thread and a full row of the
  // tile a half-warp.
  const int row_l = wg * 64 + (warp % 4) * 16 + g;  // + h * 8
  __syncthreads();  // every warp is done with the pipeline's shared memory
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC] f32 tile (not kGeluMax)
  float* red = Cs + BM * LDC;                  // kGeluQuant: the rows' scales [BM]
  const int NT = p.N / BN;

  float sx[2], rmax[2] = {0.0f, 0.0f};
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
      float y0 = dequant(acc[4 * j + 2 * h], sx[h], w2.x, b2.x);
      float y1 = dequant(acc[4 * j + 2 * h + 1], sx[h], w2.y, b2.y);
      if constexpr (EPI == kGeluMax || EPI == kGeluQuant) {
        y0 = gelu_tanh(y0);
        y1 = gelu_tanh(y1);
      }
      if constexpr (EPI == kGeluMax)
        rmax[h] = fmaxf(rmax[h], fmaxf(fabsf(y0), fabsf(y1)));
      else
        *reinterpret_cast<float2*>(Cs + (row_l + h * 8) * LDC + col_l) = make_float2(y0, y1);
    }
  }

  if constexpr (EPI == kGeluMax) {  // a row's 128 columns lie in its 4 lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rmax[h];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int row = m0 + row_l + h * 8;
      if (c == 0 && row < p.M) p.partial[(size_t)row * NT + blockIdx.x] = m;
    }
    return;
  }

  if constexpr (EPI == kGeluQuant) {  // the row's scale from its column tiles' maxima
    if (tid < BM) {
      float s = 1.0f;
      if (m0 + tid < p.M) {
        const float* pr = p.partial + (size_t)(m0 + tid) * NT;
        float m = 0.0f;
        for (int t = 0; t < NT; ++t) m = fmaxf(m, pr[t]);
        s = quant_scale(m);
        if (blockIdx.x == 0) p.sh[m0 + tid] = s;
      }
      red[tid] = s;
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
    if constexpr (EPI == kGeluQuant) {
      const float s = red[rl];
      *reinterpret_cast<uint2*>(p.h8 + (size_t)row * p.N + n0 + cl) =
          make_uint2(quant_pack4(y[0], y[1], y[2], y[3], s),
                     quant_pack4(y[4], y[5], y[6], y[7], s));
    } else {
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
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
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

// Quantised rows xq [M, K], sx [M] -> h8 int8 [M, F], sh f32 [M]: the GEMM and
// the GELU twice, for each row's maximum and then to quantise with it.
cudaError_t fc1_gelu_gemms(const void* xq, const void* sx, const void* wq, const void* ws,
                           const void* bias, void* h8, void* sh, void* partial, int M, int K,
                           int F, cudaStream_t st) {
  GemmArgs p = gemm_args(xq, sx, wq, ws, bias, M, K, F);
  p.h8 = static_cast<int8_t*>(h8);
  p.sh = static_cast<float*>(sh);
  p.partial = static_cast<float*>(partial);
  cudaError_t err = launch_gemm<kGeluMax>(p, st);
  if (err != cudaSuccess) return err;
  return launch_gemm<kGeluQuant>(p, st);
}

// x [M, K] -> h8 int8 [M, F], sh f32 [M]; gamma and beta null: no layernorm.
int fc1_gelu(const void* x, const void* gamma, const void* beta, float eps, const void* wq,
             const void* ws, const void* bias, void* h8, void* sh, void* xq, void* sx,
             void* partial, int M, int K, int F, cudaStream_t st) {
  if (!gemm_shape_ok(M, K, F) || (gamma != nullptr && K > MAX_QUANT_K))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_quant_rows(x, gamma, beta, eps, xq, sx, M, K, st);
  if (err != cudaSuccess) return (int)err;
  return (int)fc1_gelu_gemms(xq, sx, wq, ws, bias, h8, sh, partial, M, K, F, st);
}

}  // namespace caim

// K4a: layernorm (gamma, beta, eps) -> quantise -> GEMM -> tanh GELU ->
// requantise over the whole row. partial is f32 scratch [M, F / 128].
extern "C" int caim_int8_fc1_gelu(const void* x, const void* gamma, const void* beta,
                                  float eps, const void* wq, const void* ws,
                                  const void* bias, void* h8, void* sh, void* xq, void* sx,
                                  void* partial, int M, int K, int F, void* stream) {
  if (gamma == nullptr || beta == nullptr) return (int)cudaErrorInvalidValue;
  return caim::fc1_gelu(x, gamma, beta, eps, wq, ws, bias, h8, sh, xq, sx, partial, M, K, F,
                        static_cast<cudaStream_t>(stream));
}

// K14: K4a without the layernorm.
extern "C" int caim_int8_fc1_gelu_rows(const void* x, const void* wq, const void* ws,
                                       const void* bias, void* h8, void* sh, void* xq,
                                       void* sx, void* partial, int M, int K, int F,
                                       void* stream) {
  return caim::fc1_gelu(x, nullptr, nullptr, 0.0f, wq, ws, bias, h8, sh, xq, sx, partial, M, K,
                        F, static_cast<cudaStream_t>(stream));
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
// LN2(xf) quantised); h8 int8 [M, F], sh f32 [M], partial f32 [M, F / 128].
//
// Replaces cognitive_aim_tpu/kernels/int8_block.py int8_attnout_mlp_ln (body
// _attnout_mlp_kernel), one TPU program that keeps the three weights (5.2 MB)
// and a row tile's f32 residual and f32 hidden resident in VMEM. A thread block
// has 227 KB, and the requantisation needs a row's maximum over all F hidden
// columns before fc2 may start, so K12 here is a chain over this file's GEMM:
// quantise ctx -> GEMM (kResidualToF32) -> layernorm and quantise the f32 rows
// -> GEMM twice (kGeluMax, kGeluQuant) -> GEMM (kResidualFromF32): six launches,
// as K3 followed by K4. What it lets through device memory that the TPU kernel
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
                                     void* h8, void* sh, void* partial, int M, int K, int F,
                                     void* stream) {
  using namespace caim;
  if (!gemm_shape_ok(M, K, K) || !gemm_shape_ok(M, K, F) || K > MAX_QUANT_K ||
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
  err = fc1_gelu_gemms(aq, sa, w1, s1, b1, h8, sh, partial, M, K, F, st);
  if (err != cudaSuccess) return (int)err;
  p = gemm_args(h8, sh, w2, s2, b2, M, F, K);
  p.ls = static_cast<const float*>(ls2);
  p.resf = static_cast<const float*>(xf);
  p.out = static_cast<bf16*>(out);
  return (int)launch_gemm<kResidualFromF32>(p, st);
}
