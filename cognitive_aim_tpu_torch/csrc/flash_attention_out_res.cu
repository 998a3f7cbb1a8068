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
// The context never reaches device memory in any type.
//
// What bounds it on this card: K1's work plus K3's (at B 8, N 1370, H 12:
// 46 GFLOP of bf16 and 12.9 GOP of int8 products) against 84 MB (q, k, v, res
// in, out out) and the 0.6 MB weight: operations. What shapes the design is
// neither: the quantisation scale is the maximum over the whole HD-wide f32
// context row, so one block must own all heads of its query rows and hold their
// f32 context until the last head is done. 64 rows x 768 f32 is 192 KB of the
// 227 KB a block may use, so:
//   * A block owns 32 query rows of one batch element: the f32 context tile is
//     32 x (HD + 8) floats, 97 KB at HD 768 and 129 KB at HD 1024; one block an
//     SM, ceil(N / 32) x B blocks (344 at the slice's shape, 2.6 waves).
//   * Attention is K1's program (flash_step.cuh) with the 4 warps arranged as
//     2 row groups of 16 rows x the 2 heads of a pair. The heads of a pair
//     are 128 neighbouring columns of the packed layout, so one 64-key x
//     128-column cp.async tile of K and of V feeds both; the pairs' key loops
//     run one after the other through one double buffer (the next pair's Q
//     tile and first K and V tile are fetched under the last tile of the
//     current pair). P is rounded to bf16 un-normalised, as in K1; each head's
//     accumulator is divided by its f32 row sum and written to the context
//     tile in f32.
//   * Then each warp quantises 8 rows of the tile (row maximum by shuffles)
//     into an int8 tile that takes over the Q/K/V buffers, and the block runs
//     c8 wq^T as mma.sync m16n8k32: the weight streams from L2 in 128 x 128
//     tiles through a cp.async double buffer, each warp owns 32 of a tile's
//     128 output columns for both 16-row groups, and the epilogue
//     (acc * sc * ws + b, res + ls * y, bf16) runs on the accumulators.
// What the f32 context tile costs: with 32 query rows a block (K1: 64) every
// K and V tile is fetched from L2 twice as often for the same work: 344 blocks
// x 4.2 MB = 1.45 GB a call at the slice's shape against K1's 0.74 GB. Splitting
// a tile's keys over 2 or 4 warps of each (row group, head), 8 or 16 warps a
// block, was tried and did not change the time, so it is not the 4 warps'
// exposed latency that bounds the kernel. Next: a thread-block cluster whose
// blocks share each K and V tile (TMA multicast), 48 rows at HD 768
// (single-head tiles leave the room), wgmma for both products.
#include "flash_step.cuh"

namespace caim {

constexpr int OR_ROWS = 32;              // query rows of a block
constexpr int OR_WARPS = 4;              // (row group of 16) x (head of the pair)
constexpr int OR_THREADS = OR_WARPS * 32;
constexpr int OR_HEAD = 64;
constexpr int OR_PAIR = 2 * OR_HEAD;     // columns of a head pair
constexpr int LDP = OR_PAIR + 8;         // smem row stride of a Q/K/V tile (elements)
constexpr int OR_BN = OR_WARPS * 32;     // weight tile: output channels ...
constexpr int OR_BK = 128;               // ... by contraction depth (bytes)
constexpr int LDW = OR_BK + 16;          // smem row stride of a weight tile (bytes)
constexpr int OR_MAX_HD = 1024;
// phase 1: Q x 2, K x 2, V x 2; phase 2 reuses it for the int8 context and the
// weight ring
constexpr size_t OR_QKV_BYTES = (size_t)(2 * OR_ROWS + 4 * TILE) * LDP * sizeof(bf16);
static_assert((size_t)OR_ROWS * (OR_MAX_HD + 16) + 2 * OR_BN * LDW <= OR_QKV_BYTES,
              "the int8 context tile and the weight ring fit the Q/K/V buffers");

inline size_t out_res_smem(int HD) {
  return (size_t)OR_ROWS * (HD + 8) * sizeof(float) + OR_QKV_BYTES;
}

__global__ void __launch_bounds__(OR_THREADS)
flash_out_res_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int8_t* __restrict__ wq,
                     const float* __restrict__ ws, const float* __restrict__ bias,
                     const float* __restrict__ ls, const bf16* __restrict__ res,
                     bf16* __restrict__ out, int8_t* __restrict__ ctx8_out,
                     float* __restrict__ sc_out, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float Sc[OR_ROWS];  // the rows' quantisation scales
  const int HD = H * OR_HEAD;
  const int ldc = HD + 8;   // f32 context rows: a half-warp's float2 stores on distinct banks
  const int lda = HD + 16;  // int8 context rows (bytes): fragment loads on distinct banks
  float* Cs = reinterpret_cast<float*>(smem);                              // [OR_ROWS][ldc]
  bf16* Qs = reinterpret_cast<bf16*>(smem + (size_t)OR_ROWS * ldc * sizeof(float));
  bf16* Ks = Qs + 2 * OR_ROWS * LDP;                                       // [2][TILE][LDP]
  bf16* Vs = Ks + 2 * TILE * LDP;
  int8_t* A8 = reinterpret_cast<int8_t*>(Qs);                              // [OR_ROWS][lda]
  int8_t* Wr = A8 + (size_t)OR_ROWS * lda;                                 // [2][OR_BN][LDW]

  const int q0 = blockIdx.x * OR_ROWS, b = blockIdx.y;
  const size_t base = (size_t)b * N * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rg = warp & 1, hp = warp >> 1;  // row group; head of the pair
  const int r0 = rg * 16 + g;               // this thread's rows in the tile: r0, r0 + 8
  const int ntiles = (N + TILE - 1) / TILE;
  const int nsteps = (H / 2) * ntiles;      // (head pair, key tile), pairs outermost
  const float scale_log2 = scale * LOG2E;

  // ------------------------------------------------ phase 1: attention -----
  auto load_step = [&](int step) {
    const int j = step / ntiles, k0 = (step % ntiles) * TILE, buf = step & 1;
    const size_t col = base + (size_t)j * OR_PAIR;
    if (k0 == 0)  // the pair's Q tile, into the buffer the previous pair does not read
      load_tile_async(Qs + (j & 1) * OR_ROWS * LDP, LDP, q + col + (size_t)q0 * HD, HD,
                      OR_ROWS, OR_PAIR, N - q0);
    load_tile_async(Ks + buf * TILE * LDP, LDP, k + col + (size_t)k0 * HD, HD, TILE, OR_PAIR,
                    N - k0);
    load_tile_async(Vs + buf * TILE * LDP, LDP, v + col + (size_t)k0 * HD, HD, TILE, OR_PAIR,
                    N - k0);
  };

  uint32_t qf[4][4];  // A fragments of this warp's 16 x 64 Q block
  float o[8][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r0, r0 + 8

  load_step(0);
  cp_async_commit();
  for (int step = 0; step < nsteps; ++step) {
    const int j = step / ntiles, t = step % ntiles, buf = step & 1, k0 = t * TILE;
    if (step + 1 < nsteps) {
      load_step(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles visible to all warps
    if (t == 0) {     // a new head: its Q fragments, a fresh softmax state
      const bf16* Qp = Qs + (j & 1) * OR_ROWS * LDP + hp * OR_HEAD;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = lds32(&Qp[r0 * LDP + 16 * kk + 2 * c]);
        qf[kk][1] = lds32(&Qp[(r0 + 8) * LDP + 16 * kk + 2 * c]);
        qf[kk][2] = lds32(&Qp[r0 * LDP + 16 * kk + 8 + 2 * c]);
        qf[kk][3] = lds32(&Qp[(r0 + 8) * LDP + 16 * kk + 8 + 2 * c]);
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.0f;
    }
    const bf16* Kt = Ks + buf * TILE * LDP + hp * OR_HEAD;
    const bf16* Vt = Vs + buf * TILE * LDP + hp * OR_HEAD;

    float s[8][4];  // S = Q K^T for 16 rows x 64 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const bf16* kr = &Kt[(8 * nt + g) * LDP + 2 * c];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_16816(s[nt], qf[kk], lds32(kr + 16 * kk), lds32(kr + 16 * kk + 8));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {  // base 2, keys past N at -inf
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + 8 * nt + 2 * c + e < N;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][2 + e] = ok ? s[nt][2 + e] * scale_log2 : -INFINITY;
      }
    }
    flash_softmax_pv<LDP>(s, o, m0, m1, l0, l1, Vt, lane);

    if (t == ntiles - 1) {  // the head's normalised f32 context -> the tile
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // a row's sum lies in its 4 lanes
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      float* c0 = Cs + (size_t)r0 * ldc + (2 * j + hp) * OR_HEAD + 2 * c;
      float* c1 = c0 + 8 * ldc;
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        *reinterpret_cast<float2*>(c0 + 8 * dt) = make_float2(o[dt][0] / l0, o[dt][1] / l0);
        *reinterpret_cast<float2*>(c1 + 8 * dt) = make_float2(o[dt][2] / l1, o[dt][3] / l1);
      }
    }
    __syncthreads();  // all warps are done with this step's buffers
  }

  // ------------------------------- phase 2: quantise, project, residual -----
  for (int r = warp; r < OR_ROWS; r += OR_WARPS) {  // a warp a row
    const float* cr = Cs + (size_t)r * ldc;
    float amax = 0.0f;
    for (int kx = lane * 4; kx < HD; kx += 128) {
      const float4 x = *reinterpret_cast<const float4*>(cr + kx);
      amax = fmaxf(fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y))), fmaxf(fabsf(x.z), fabsf(x.w)));
    }
    const float s = quant_scale(warp_max(amax));
    const bool keep = ctx8_out != nullptr && q0 + r < N;
    for (int kx = lane * 4; kx < HD; kx += 128) {
      const float4 x = *reinterpret_cast<const float4*>(cr + kx);
      const uint32_t w = quant_pack4(x.x, x.y, x.z, x.w, s);
      *reinterpret_cast<uint32_t*>(A8 + (size_t)r * lda + kx) = w;
      if (keep) *reinterpret_cast<uint32_t*>(ctx8_out + base + (size_t)(q0 + r) * HD + kx) = w;
    }
    if (lane == 0) {
      Sc[r] = s;
      if (keep) sc_out[(size_t)b * N + q0 + r] = s;
    }
  }

  const int KS = HD / OR_BK, ntw = (HD / OR_BN) * KS;  // weight tiles, output chunk outermost
  auto load_w = [&](int tile) {
    const int nc = tile / KS, ks = tile % KS;
    load_tile_async_bytes(Wr + (tile & 1) * OR_BN * LDW, LDW,
                          wq + (size_t)nc * OR_BN * HD + (size_t)ks * OR_BK, HD, OR_BN, OR_BK,
                          OR_BN);
  };
  __syncthreads();  // the int8 tile and the scales visible; the weight ring is free
  load_w(0);
  cp_async_commit();
  int acc[2][4][4];  // [row group][8-column tile of this warp's 32][m16n8 fragment]
  for (int tile = 0; tile < ntw; ++tile) {
    const int nc = tile / KS, ks = tile % KS;
    if (tile + 1 < ntw) {
      load_w(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          acc[mt][jn][0] = acc[mt][jn][1] = acc[mt][jn][2] = acc[mt][jn][3] = 0;
    }
    const int8_t* Wt = Wr + (tile & 1) * OR_BN * LDW;
#pragma unroll
    for (int kk = 0; kk < OR_BK / 32; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* ar = A8 + (size_t)(mt * 16 + g) * lda + ks * OR_BK + 32 * kk + 4 * c;
        af[mt][0] = lds32(ar);
        af[mt][1] = lds32(ar + 8 * lda);
        af[mt][2] = lds32(ar + 16);
        af[mt][3] = lds32(ar + 8 * lda + 16);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int8_t* wr = Wt + (warp * 32 + 8 * jn + g) * LDW + 32 * kk + 4 * c;
        const uint32_t b0 = lds32(wr), b1 = lds32(wr + 16);
        mma_16832_s8(acc[0][jn], af[0], b0, b1);
        mma_16832_s8(acc[1][jn], af[1], b0, b1);
      }
    }
    if (ks == KS - 1) {  // the chunk's columns are complete
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = nc * OR_BN + warp * 32 + 8 * jn + 2 * c;
        const float2 w2 = *reinterpret_cast<const float2*>(ws + col);
        const float2 b2 = *reinterpret_cast<const float2*>(bias + col);
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int rl = mt * 16 + g + 8 * h;
            if (q0 + rl >= N) continue;
            const float sx = Sc[rl];
            const float y0 = dequant(acc[mt][jn][2 * h], sx, w2.x, b2.x);
            const float y1 = dequant(acc[mt][jn][2 * h + 1], sx, w2.y, b2.y);
            const size_t off = base + (size_t)(q0 + rl) * HD + col;
            const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + off);
            *reinterpret_cast<uint32_t*>(out + off) =
                pack_bf16(__fadd_rn(__low2float(r2), __fmul_rn(l2.x, y0)),
                          __fadd_rn(__high2float(r2), __fmul_rn(l2.y, y1)));
          }
        }
      }
    }
    __syncthreads();  // the ring slot is free before its refill
  }
}

}  // namespace caim

// q, k, v, res, out: bf16 [B, N, H*head_dim] contiguous, 16-byte aligned;
// head_dim 64, H even, H * 64 <= 1024. wq: int8 [HD, HD], rows the output
// channels; ws, bias, ls: f32 [HD]. ctx8, sc: null, or int8 [B, N, HD] and f32
// [B, N] that receive the quantised context and its row scales (for checks).
// Launches on `stream`, does not synchronize, returns the first CUDA error.
extern "C" int caim_flash_attention_out_res(const void* q, const void* k, const void* v,
                                            const void* wq, const void* ws, const void* bias,
                                            const void* ls, const void* res, void* out,
                                            void* ctx8, void* sc, int B, int N, int H,
                                            int head_dim, float scale, void* stream) {
  using namespace caim;
  if (head_dim != OR_HEAD || B <= 0 || N <= 0 || H <= 0 || H % 2 != 0 ||
      H * OR_HEAD > OR_MAX_HD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = out_res_smem(H * OR_HEAD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_out_res_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + OR_ROWS - 1) / OR_ROWS, B);
  flash_out_res_kernel<<<grid, OR_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<const float*>(ls),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), static_cast<int8_t*>(ctx8),
      static_cast<float*>(sc), N, H, scale);
  return (int)cudaGetLastError();
}
