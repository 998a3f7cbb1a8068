// K12: the post-attention half of the chained int8 transformer block in one
// kernel, written for Hopper.
//
// Replaces cognitive_aim_tpu/kernels/int8_block.py int8_attnout_mlp_ln (body
// _attnout_mlp_kernel):
//   xf  = res + ls1 (quant(ctx) wo^T s_c s_o + b_o)                  (f32)
//   xn  = LN2(xf)     (mean, then the mean of squared deviations)
//   h   = gelu_tanh(quant(xn) w1^T s_x s_1 + b_1)                    (F wide)
//   out = xf + ls2 (quant(h) w2^T s_h s_2 + b_2)                     (one cast to bf16)
// with ctx, res, out bf16 [M, K], wo [K, K], w1 [F, K], w2 [K, F] int8 and f32
// per-channel scales, biases, layernorm parameters and LayerScales. Every
// quantiser is the int8 block's (tile_common.cuh): s = max(max|x| / 127,
// 1e-12) with a true division, q = clip(rint(x / s)). xf is never rounded to
// bf16. The layernorm's sums are taken in another order than the plain
// version's, so K12 is held to it by a tolerance, not bit for bit.
//
// The TPU kernel keeps the three weights and a row tile's f32 residual and
// hidden in VMEM. A block has 227 KB of shared memory, and every quantiser
// needs a row's maximum over all of its columns (K over the model width, F
// over the hidden) before it may quantise one of them. So one thread-block
// cluster of C CTAs (8 at ViT-B and ViT-L) owns a 64-row tile across all of
// its columns: CTA `rank` owns the model columns rank KC .. + KC - 1 (KC =
// K / C: 96 at ViT-B, 128 at ViT-L) and the hidden columns rank FC .. + FC -
// 1 (FC = F / C: 384, 512), and the CTAs exchange what a row needs through
// distributed shared memory (DSMEM). A CTA is two consumer warpgroups, a TMA
// producer warp and a copy warp (one CTA an SM). Per tile, in order:
//   1. quant(ctx): each CTA reads its own KC columns of the ctx rows (the
//      cluster reads each byte of ctx once, with no 96 KB staging tile that
//      a TMA multicast of whole rows would need), exchanges its part of each
//      row's maximum, quantises its columns into its A operand and copies
//      them into every peer's (one bulk copy of 64 KC bytes a peer): each CTA
//      then holds quant(ctx) for the whole 64 x K tile.
//   2. attn_out: wgmma m64n(KC/2)k32, a warpgroup's KC / 2 columns over the
//      depth K, A from that operand, the weight rows by TMA. The epilogue
//      forms xf in f32 and keeps it in shared memory until the last epilogue.
//   3. LN2 across the cluster: each row's sums (the 4 lanes of a row, the two
//      warpgroups, then the C CTAs in rank order, so that every CTA finds the
//      same mean), then the sums of squared deviations from that mean, then
//      the maxima of |xn|; quant(xn) is shared as quant(ctx) is in 1.
//   4. fc1 + GELU: wgmma m64nNWCk32, a warpgroup's NWC hidden columns a
//      sweep, the weight slice by TMA; K4a's epilogue (dequantise, tanh GELU)
//      and an exchange of the row maxima over all F columns; each CTA
//      quantises its hidden slice ([64, FC] int8) into its shared memory.
//   5. fc2 over the depth F in 128-deep slices. Each CTA walks them starting
//      with its own hidden's, then the next CTA's, and so on (the int32 sums
//      do not depend on the order), so that at each step every CTA serves
//      one peer. For each step the producer loads the weight slice by TMA
//      and asks the CTA holding that slice of the hidden for it; that CTA's
//      copy warp copies the 8 KB into the stage by bulk copy. fc2's stages
//      (8 KB of hidden, KC weight rows) are packed into fc1's ring. The
//      epilogue adds ls2 y to the xf still in shared memory and stores bf16.
// The A operands are kept in wgmma's interleaved K-major layout (a_off), so
// that a CTA's columns and a 128-deep slice are contiguous. A row statistic
// is exchanged by writing each CTA's part into every CTA's slot of it
// (st.shared::cluster) and arriving on their mbarrier (release at cluster
// scope); the waiters acquire and combine the C parts in rank order. Every
// cluster-wide mbarrier is used once a launch (parity 0). barrier.cluster is
// used twice: after the barriers are initialised and before a CTA exits.
//
// What bounds it: at M 10960, K 768, F 3072, 116 GOP of int8 products (0.059
// ms at 1,979 TOP/s) against 2 x 16.8 MB of activations in, 16.8 MB out and
// 5.3 MB of weights (0.017 ms): operations. The kernel is far from that: a
// tile's phases run one after another with the tensor cores idle between
// them (10.75 waves of 15-16 resident clusters); every cluster reads all 5.3
// MB of weights from L2 for each 64-row tile (0.91 GB a call); the epilogues
// spend ~50 f32 instructions on each of the 33.7 M hidden values (K4a's
// cost); and DSMEM moves ~16-22 GB/s out of an SM on an H100 (bulk copies;
// 16-byte loads and stores by threads about half that), so fc2's 168 KB of
// hidden a CTA and tile takes a third of the tile. What the design keeps out
// of device memory against K3 then K4: the f32 or bf16 residual between the
// halves, the int8 activations between each quantiser and its GEMM, and the
// 33.7 MB int8 hidden (through L2 instead, the hidden made the kernel 7%
// faster in a development build, at the price of that scratch).
//
// Shared memory (ViT-B): the A operand 48 KB, xf 26 KB (rows padded by 8
// floats: the epilogue's float2 stores of a warp fall on distinct banks), a
// ring of 3 slots of 48 KB (a fc1 stage: 384 weight rows x 128 bytes; fc2
// packs 7 stages of 20 KB into it), row vectors and barriers: 228 KB; the
// hidden takes the A operand's place. ViT-L needs 64 KB for the A operand and 32 KB for
// its hidden, and a warpgroup's 256 hidden columns would take 128
// accumulators a thread (K4a's build at F 4096 spills at 128): it sweeps fc1
// in two chunks of 128 columns, twice (once for the row maxima, once to
// quantise), with a ring of 2 slots of 32 KB.
#include "tile_common.cuh"

namespace caim {

namespace {

constexpr int AO_ROWS = 64;           // rows of a cluster's tile: one wgmma M
constexpr int AO_THREADS = 256 + 64;  // two consumer warpgroups, a producer and a copy warp
constexpr int AO_BK = 128;            // contraction depth of a stage: one swizzled row
constexpr int SLICE = AO_ROWS * AO_BK;  // a 64-row x 128-deep int8 block (8 KB)
constexpr int AO_MAX_STAGES = 4;
constexpr int AO_MAX_FC2_STAGES = 8;

constexpr int cmax3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// One instantiation: a cluster of C CTAs, KC model columns and 2 NWC NCH
// hidden columns a CTA (a warpgroup's NCH chunks of NWC)
template <int C_, int KC_, int NWC_, int NCH_>
struct AoTile {
  static constexpr int C = C_, KC = KC_, NWC = NWC_, NCH = NCH_;
  static constexpr int K = C * KC;           // the model width
  static constexpr int FC = 2 * NWC * NCH;   // hidden columns of a CTA
  static constexpr int F = C * FC;
  static constexpr int HALF = KC / 2;        // a warpgroup's attn_out and fc2 columns
  static constexpr int CH16 = KC / 16;       // 16-byte int8 chunks of a row's KC columns
  static constexpr int KT1 = K / AO_BK;      // stages of attn_out and of one fc1 sweep
  static constexpr int KT2 = F / AO_BK;      // stages of fc2
  static constexpr int SPP = FC / AO_BK;     // fc2 slices in a CTA's hidden
  static constexpr int SWEEPS = NCH == 1 ? 1 : 2 * NCH;
  static constexpr int XLD = KC + 8;         // f32 row stride of the xf tile
  static constexpr int A_BYTES = AO_ROWS * K;
  // the hidden slice takes the A operand's place once fc1 has read it, where
  // fc1 reads it once (one sweep) and it fits
  static constexpr bool HID_IN_A = NCH == 1 && AO_ROWS * FC <= A_BYTES;
  static constexpr int HID_BYTES = HID_IN_A ? 0 : AO_ROWS * FC;
  static constexpr int SLOT =
      (cmax3(KC * AO_BK, 2 * NWC * AO_BK, SLICE + KC * AO_BK) + 1023) / 1024 * 1024;
  static constexpr int VEC_BYTES = (8 + 2 * C) * AO_ROWS * 4;  // row vectors, see the kernel
  static constexpr int NBARS = 2 * AO_MAX_STAGES + 2 * AO_MAX_FC2_STAGES + 8 + SPP * C;
  static constexpr int FIXED = A_BYTES + HID_BYTES + AO_ROWS * XLD * 4 + VEC_BYTES + NBARS * 8;
  static constexpr int FIT = (int)((MAX_SMEM - 1024 - FIXED) / SLOT);
  static constexpr int STAGES = FIT < AO_MAX_STAGES ? FIT : AO_MAX_STAGES;
  static constexpr int A_OFF = 0;
  static constexpr int HID_OFF = HID_IN_A ? A_OFF : A_BYTES;
  static constexpr int RING_OFF = A_BYTES + HID_BYTES;
  static constexpr int XF_OFF = RING_OFF + STAGES * SLOT;
  static constexpr int VEC_OFF = XF_OFF + AO_ROWS * XLD * 4;
  static constexpr int BAR_OFF = VEC_OFF + VEC_BYTES;
  static constexpr size_t SMEM = (size_t)BAR_OFF + NBARS * 8 + 1024;  // + room to align
  // fc2's stages (a hidden slice and KC weight rows) packed into the ring
  static constexpr int FC2_STAGE = SLICE + KC * AO_BK;
  static constexpr int FC2_FIT = STAGES * SLOT / FC2_STAGE;
  static constexpr int FC2_STAGES = FC2_FIT < AO_MAX_FC2_STAGES ? FC2_FIT : AO_MAX_FC2_STAGES;
  static_assert(STAGES >= 2 && SMEM <= MAX_SMEM, "ring and buffers fit");
  static_assert(FC2_STAGE % 1024 == 0 && FC2_STAGES >= 2, "fc2 stages in the ring");
  static_assert(K % AO_BK == 0 && FC % AO_BK == 0 && KC % 32 == 0, "whole slices and chunks");
  static_assert(NWC % 64 == 0 && NWC <= 256 && KC <= 256, "wgmma widths and TMA boxes");
};

// The instantiations and the (K, F) each takes; kernels/int8_block.py
// ATTNOUT_MLP_SHAPES is this table (a card test holds the two equal)
struct AoShape {
  int K, F, C, NWC, NCH;
};
constexpr AoShape AO_SHAPES[] = {
    {768, 3072, 8, 192, 1},   // ViT-B
    {1024, 4096, 8, 128, 2},  // ViT-L
    {128, 512, 2, 128, 1},    // the tests' width
};
using AoVitB = AoTile<8, 96, 192, 1>;
using AoVitL = AoTile<8, 128, 128, 2>;
using AoTest = AoTile<2, 64, 128, 1>;
static_assert(AoVitB::K == 768 && AoVitB::F == 3072 && AoVitL::K == 1024 && AoVitL::F == 4096 &&
                  AoTest::K == 128 && AoTest::F == 512,
              "AO_SHAPES names each instantiation's widths");

struct AoArgs {
  const bf16* ctx;  // [M, K]
  const bf16* res;  // [M, K]
  bf16* out;        // [M, K]
  const float *so, *bo, *ls1, *gamma, *beta;  // [K]
  const float *s1, *b1;                       // [F]
  const float *s2, *b2, *ls2;                 // [K]
  float eps;
  int M;
};

// The A operands (quant(ctx), quant(xn), the hidden) are [64, width] int8
// tiles in the interleaved K-major layout of wgmma: 16-byte column chunks,
// each the 64 rows' 16 bytes (1 KB, 8-row core matrices of 128 bytes), so
// that a CTA's columns (whole chunks) and a 128-deep slice are contiguous
// and move between CTAs as one bulk copy. Byte offset of (row r, column col):
__device__ __forceinline__ int a_off(int r, int col) {
  return (col >> 4) * (AO_ROWS * 16) + r * 16 + (col & 15);
}
constexpr uint32_t A_LBO = AO_ROWS * 16;  // core matrices along K: the next chunk
constexpr uint32_t A_SBO = 128;           // along M: the next 8 rows

template <class T>
__global__ void __launch_bounds__(AO_THREADS, 1)
attnout_mlp_kernel(const __grid_constant__ CUtensorMap two, const __grid_constant__ CUtensorMap tw1,
                   const __grid_constant__ CUtensorMap tw2, const AoArgs p) {
  constexpr int C = T::C, KC = T::KC, NWC = T::NWC, NCH = T::NCH, K = T::K, FC = T::FC;
  constexpr int HALF = T::HALF, STAGES = T::STAGES, SPP = T::SPP;
  constexpr int OWN = AO_ROWS * KC;  // bytes of this CTA's columns of an A operand
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the address: start on a 1024-byte boundary
  // (the same offset in every CTA, so a peer's buffers lie where ours do)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* abuf = smem + T::A_OFF;  // the A operand of attn_out, then of fc1
  unsigned char* hid = smem + T::HID_OFF;  // this CTA's quantised hidden, read by fc2
  unsigned char* ring = smem + T::RING_OFF;
  float* xf = reinterpret_cast<float*>(smem + T::XF_OFF);  // [64][XLD]
  // row vectors [64]: red the two warpgroups' partials ([2][64]); cmax this
  // CTA's max |ctx| of each row (bits); the rows' results (scales of ctx, xn,
  // h; mean, 1 / standard deviation); xbuf [2][C][64], where each CTA of the
  // cluster writes its part of a row statistic (two buffers, used in turn)
  float* vec = reinterpret_cast<float*>(smem + T::VEC_OFF);
  float* red = vec;
  unsigned* cmax = reinterpret_cast<unsigned*>(vec + 2 * AO_ROWS);
  float* sc = vec + 3 * AO_ROWS;
  float* mean = vec + 4 * AO_ROWS;
  float* rstd = vec + 5 * AO_ROWS;
  float* sx = vec + 6 * AO_ROWS;
  float* sh = vec + 7 * AO_ROWS;
  float* xbuf = vec + 8 * AO_ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + AO_MAX_STAGES;
  uint64_t* full2 = empty + AO_MAX_STAGES;  // fc2's stages
  uint64_t* empty2 = full2 + AO_MAX_FC2_STAGES;
  uint64_t* xch = empty2 + AO_MAX_FC2_STAGES;  // [5] the row statistics' exchanges
  uint64_t* a_ready = xch + 5;             // [2] quant(ctx), quant(xn) complete
  uint64_t* hid_ready = a_ready + 2;       // this CTA's hidden quantised
  uint64_t* hwant = hid_ready + 1;         // [SPP][C] a peer's stage free for slice j
  enum { X_CMAX, X_SUM, X_SSD, X_XMAX, X_HMAX };
  const int rank = blockIdx.x;  // the cluster spans the grid's x
  const int m0 = blockIdx.y * AO_ROWS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 8);  // each consumer warp
    }
    for (int s = 0; s < T::FC2_STAGES; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], 8);
    }
    for (int x = 0; x < 5; ++x) mbar_init(&xch[x], C);  // one arrival from each CTA
    for (int x = 0; x < 2; ++x) mbar_init(&a_ready[x], 1);  // and the peers' bytes
    mbar_init(hid_ready, 1);
    for (int x = 0; x < SPP * C; ++x) mbar_init(&hwant[x], 1);
    mbar_init_fence();
  }
  if (tid < AO_ROWS) cmax[tid] = 0u;
  __syncthreads();
  cluster_arrive();  // every CTA's barriers exist before any peer arrives on them
  cluster_wait();

  // fc2 walks the depth F in an order of its own in each CTA, starting with
  // the slices of its own hidden, then the next CTA's: at any step each CTA
  // serves one peer (int32 sums: the order does not change them). Position p
  // of CTA `at`'s walk is slice kt of the hidden:
  auto fc2_slice = [&](int at, int p) { return (at * SPP + p) % T::KT2; };
  auto stage2 = [&](int p) { return ring + (p % T::FC2_STAGES) * T::FC2_STAGE; };

  if (tid >= 256) {
    auto slot = [&](int i) { return ring + (i % STAGES) * T::SLOT; };
    if (tid == 256) {  // ---- producer: the weight slices by TMA
      auto acquire = [&](int i, uint32_t bytes) {
        mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[i % STAGES], bytes);
      };
      int it = 0;
      for (int kt = 0; kt < T::KT1; ++kt, ++it) {  // attn_out: wo rows rank KC ..
        acquire(it, KC * AO_BK);
        tma_load_2d(slot(it), &two, &full[it % STAGES], kt * AO_BK, rank * KC);
      }
      for (int sw = 0; sw < T::SWEEPS; ++sw) {  // fc1: a warpgroup's chunk sw % NCH
        const int n0 = rank * FC + (sw % NCH) * NWC;
        for (int kt = 0; kt < T::KT1; ++kt, ++it) {
          acquire(it, 2 * NWC * AO_BK);
          tma_load_2d(slot(it), &tw1, &full[it % STAGES], kt * AO_BK, n0);
          tma_load_2d(slot(it) + NWC * AO_BK, &tw1, &full[it % STAGES], kt * AO_BK,
                      n0 + NCH * NWC);
        }
      }
      for (int i = it; i < it + STAGES; ++i)  // the ring is free: fc1 is done with it
        mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
      // fc2: the weight slice of position p, then a request to the CTA that
      // holds slice kt of the hidden, which copies it into the stage (its
      // bytes complete here)
      for (int p = 0; p < T::KT2; ++p) {
        const int s2 = p % T::FC2_STAGES, kt = fc2_slice(rank, p);
        mbar_wait(&empty2[s2], ((p / T::FC2_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full2[s2], T::FC2_STAGE);
        tma_load_2d(stage2(p) + SLICE, &tw2, &full2[s2], kt * AO_BK, rank * KC);
        mbar_arrive_cluster(cluster_map(&hwant[(kt % SPP) * C + rank], kt / SPP));
      }
    } else if (tid == 288) {  // ---- copies: this CTA's hidden slices to the peers
      mbar_wait(hid_ready, 0);
      // position p of CTA r's walk is slice j of this CTA's hidden where
      // r = rank - p / SPP (mod C), j = p % SPP: the order the requests come in
      for (int p = 0; p < T::KT2; ++p) {
        const int r = (rank - p / SPP + C) % C, j = p % SPP;
        mbar_wait_cluster(&hwant[j * C + r], 0);
        bulk_copy_cluster(cluster_map(stage2(p), r), hid + j * SLICE, SLICE,
                          cluster_map(&full2[p % T::FC2_STAGES], r));
      }
    }
    cluster_arrive();  // this CTA's hidden may go once every CTA is here
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg; this thread's rows r0, r0 + 8 of the tile
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3, r0 = warp * 16 + g;
  int it = 0;  // slices consumed
  auto slot = [&](int i) { return ring + (i % STAGES) * T::SLOT; };
  auto cta_sync = [&]() { named_barrier_sync(1, 256); };
  auto release = [&](uint64_t* bar) {  // the warp's wgmma group that read a stage is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // rows r0, r0 + 8 reduced over the 4 lanes of a row and the two warpgroups
  // (sums in a fixed order): row tid's value for tid < 64
  auto cta_rows = [&](float (&v)[2], bool is_max) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float w = __shfl_xor_sync(0xffffffffu, v[h], o);
        v[h] = is_max ? fmaxf(v[h], w) : __fadd_rn(v[h], w);
      }
    }
    if (c == 0) {
      red[wg * AO_ROWS + r0] = v[0];
      red[wg * AO_ROWS + r0 + 8] = v[1];
    }
    cta_sync();
    float a = 0.0f;
    if (tid < AO_ROWS)
      a = is_max ? fmaxf(red[tid], red[AO_ROWS + tid]) : __fadd_rn(red[tid], red[AO_ROWS + tid]);
    return a;
  };
  // the cluster's value of row tid (< 64): each CTA writes its part into
  // every CTA's xbuf and releases it to their barrier x; the parts are
  // combined in rank order, so every CTA finds the same value
  auto cluster_rows = [&](float v, int x, bool is_max) {
    float* xb = xbuf + (x & 1) * C * AO_ROWS;
    if (tid < AO_ROWS)
      for (int q = 0; q < C; ++q) st_cluster_f32(cluster_map(xb + rank * AO_ROWS + tid, q), v);
    cta_sync();
    if (tid < C) mbar_arrive_cluster(cluster_map(&xch[x], tid));
    mbar_wait_cluster(&xch[x], 0);
    float a = 0.0f;
    if (tid < AO_ROWS) {
      a = xb[tid];
      for (int q = 1; q < C; ++q)
        a = is_max ? fmaxf(a, xb[q * AO_ROWS + tid]) : __fadd_rn(a, xb[q * AO_ROWS + tid]);
    }
    return a;
  };
  // this CTA's columns of an A operand, written here, into every peer's A
  // operand by the bulk-copy engine; then the peers' columns here
  auto share_own_columns = [&](int x) {
    fence_proxy_async();  // the writes below are read by the bulk copies and wgmma
    cta_sync();
    if (tid == 0) {
      mbar_arrive_expect_tx(&a_ready[x], (C - 1) * OWN);
      for (int q = 1; q < C; ++q) {
        const int peer = (rank + q) % C;
        bulk_copy_cluster(cluster_map(abuf + rank * OWN, peer), abuf + rank * OWN, OWN,
                          cluster_map(&a_ready[x], peer));
      }
    }
    mbar_wait(&a_ready[x], 0);
  };
  // one 128-deep slice of a product into acc: A at a (the interleaved
  // layout), N columns of B at b (128-byte swizzle), one wgmma group in flight
  auto mma_slice = [&](auto& acc, const unsigned char* a, const unsigned char* b,
                       uint64_t* bar, uint32_t parity) {
    constexpr int N = 2 * (int)(sizeof(acc) / sizeof(acc[0]));
    mbar_wait(bar, parity);
    const uint64_t da = wgmma_desc_interleave(a, A_LBO, A_SBO), db = wgmma_desc_sw128(b);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < AO_BK / 32; ++ks)
      wgmma_s8<N>(acc, da + ks * (2 * A_LBO / 16), db + 2 * ks);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
  };
  auto mma_done = [&](auto& acc, uint64_t* bar) {
    wgmma_wait<0>();
    fence_operands(acc);
    release(bar);
  };
  // slice it of the ring's walk (attn_out, fc1)
  auto ring_slice = [&](auto& acc, const unsigned char* a, int boff) {
    mma_slice(acc, a, slot(it) + boff, &full[it % STAGES], (it / STAGES) & 1);
  };

  // ---- 1. quant(ctx) into every CTA's A operand: this CTA's KC columns,
  // 16 of a row an item, consecutive threads on consecutive rows
  {
    constexpr int ITEMS = (AO_ROWS * T::CH16 + 255) / 256;
    uint4 w[ITEMS][2];  // all loads in flight first (rows past M: row M - 1's)
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = tid + 256 * u, r = i % AO_ROWS, ch = (i / AO_ROWS) % T::CH16;
      const bf16* src = p.ctx + (size_t)min(m0 + r, p.M - 1) * K + rank * KC + 16 * ch;
      w[u][0] = *reinterpret_cast<const uint4*>(src);
      w[u][1] = *reinterpret_cast<const uint4*>(src + 8);
    }
    float v[ITEMS][16];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = tid + 256 * u, r = i % AO_ROWS;
      const bool valid = i < AO_ROWS * T::CH16, real = valid && m0 + r < p.M;
      float amax = 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float x = __bfloat162float(reinterpret_cast<const bf16*>(&w[u][e / 8])[e % 8]);
        v[u][e] = real ? x : 0.0f;  // rows past M count as zeros
        amax = fmaxf(amax, fabsf(v[u][e]));
      }
      if (valid) atomicMax(reinterpret_cast<int*>(&cmax[r]), __float_as_int(amax));
    }
    cta_sync();
    const float m = cluster_rows(tid < AO_ROWS ? __int_as_float(cmax[tid]) : 0.0f, X_CMAX, true);
    if (tid < AO_ROWS) sc[tid] = quant_scale(m);
    cta_sync();
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int i = tid + 256 * u, r = i % AO_ROWS, ch = i / AO_ROWS;
      if (i < AO_ROWS * T::CH16) {
        const float s = sc[r];
        *reinterpret_cast<uint4*>(abuf + a_off(r, rank * KC + 16 * ch)) =
            make_uint4(quant_pack4(v[u][0], v[u][1], v[u][2], v[u][3], s),
                       quant_pack4(v[u][4], v[u][5], v[u][6], v[u][7], s),
                       quant_pack4(v[u][8], v[u][9], v[u][10], v[u][11], s),
                       quant_pack4(v[u][12], v[u][13], v[u][14], v[u][15], s));
      }
    }
    share_own_columns(0);
  }

  // ---- 2. attn_out, its epilogue (xf), 3. LN2 across the cluster
  {
    float xv[HALF / 2];  // this thread's xf, then xn: the accumulator's layout
    {
      // the residual of this thread's outputs, loaded while the products run
      // (rows past M: row M - 1's, never stored)
      uint32_t rb[HALF / 4];
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rb[2 * j + h] = *reinterpret_cast<const uint32_t*>(
              p.res + (size_t)min(m0 + r0 + 8 * h, p.M - 1) * K + rank * KC + wg * HALF + 8 * j +
              2 * c);
      int acc[HALF / 2];
#pragma unroll
      for (int i = 0; i < HALF / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < T::KT1; ++kt, ++it) {
        ring_slice(acc, abuf + kt * SLICE, wg * HALF * AO_BK);
        if (kt > 0) release(&empty[(it - 1) % STAGES]);
      }
      mma_done(acc, &empty[(it - 1) % STAGES]);
      const float s2[2] = {sc[r0], sc[r0 + 8]};
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int lc = wg * HALF + 8 * j + 2 * c, gc = rank * KC + lc;
        const float2 w2 = *reinterpret_cast<const float2*>(p.so + gc);
        const float2 b2 = *reinterpret_cast<const float2*>(p.bo + gc);
        const float2 l2 = *reinterpret_cast<const float2*>(p.ls1 + gc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rb[2 * j + h]));
          const float x0 =
              __fadd_rn(rv.x, __fmul_rn(l2.x, dequant(acc[4 * j + 2 * h], s2[h], w2.x, b2.x)));
          const float x1 =
              __fadd_rn(rv.y, __fmul_rn(l2.y, dequant(acc[4 * j + 2 * h + 1], s2[h], w2.y, b2.y)));
          xv[4 * j + 2 * h] = x0;
          xv[4 * j + 2 * h + 1] = x1;
          *reinterpret_cast<float2*>(xf + r * T::XLD + lc) = make_float2(x0, x1);
          s[h] = __fadd_rn(__fadd_rn(s[h], x0), x1);
        }
      }
      const float sum = cluster_rows(cta_rows(s, false), X_SUM, false);
      if (tid < AO_ROWS) mean[tid] = __fdiv_rn(sum, (float)K);
      cta_sync();
    }
    {
      float d2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = __fsub_rn(xv[4 * j + 2 * h + e], mean[r0 + 8 * h]);
            d2[h] = __fadd_rn(d2[h], __fmul_rn(d, d));
          }
      const float ssd = cluster_rows(cta_rows(d2, false), X_SSD, false);
      if (tid < AO_ROWS) rstd[tid] = rsqrtf(__fadd_rn(__fdiv_rn(ssd, (float)K), p.eps));
      cta_sync();
    }
    {
      float mx[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j) {
        const int gc = rank * KC + wg * HALF + 8 * j + 2 * c;
        const float2 ga = *reinterpret_cast<const float2*>(p.gamma + gc);
        const float2 be = *reinterpret_cast<const float2*>(p.beta + gc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float mu = mean[r0 + 8 * h], rs = rstd[r0 + 8 * h];
          float& a = xv[4 * j + 2 * h];
          float& b = xv[4 * j + 2 * h + 1];
          a = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(a, mu), rs), ga.x), be.x);
          b = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(b, mu), rs), ga.y), be.y);
          mx[h] = fmaxf(mx[h], fmaxf(fabsf(a), fabsf(b)));
        }
      }
      const float m = cluster_rows(cta_rows(mx, true), X_XMAX, true);
      if (tid < AO_ROWS) sx[tid] = quant_scale(m);
      cta_sync();
    }
    // quant(xn) of this CTA's columns into its own A operand: its attn_out
    // products are done, the bulk copies of its quant(ctx) columns have
    // landed in every peer (each peer's part of X_SUM came after them), and
    // no peer writes these columns
    const float sxr[2] = {sx[r0], sx[r0 + 8]};  // (the stores below may alias sx)
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int gc = rank * KC + wg * HALF + 8 * j + 2 * c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int q0 = quant_value(xv[4 * j + 2 * h], sxr[h]);
        const int q1 = quant_value(xv[4 * j + 2 * h + 1], sxr[h]);
        *reinterpret_cast<uint16_t*>(abuf + a_off(r, gc)) =
            (uint16_t)((q0 & 0xff) | (q1 & 0xff) << 8);
      }
    }
    share_own_columns(1);
  }

  // ---- 4. fc1 + GELU, the hidden quantised over all F columns of a row
  {
    int acc[NWC / 2];
    float mx[2] = {0.0f, 0.0f};
    // one sweep over the 128-deep slices of the A operand into acc
    auto sweep = [&]() {
#pragma unroll
      for (int i = 0; i < NWC / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < T::KT1; ++kt, ++it) {
        ring_slice(acc, abuf + kt * SLICE, wg * NWC * AO_BK);
        if (kt > 0) release(&empty[(it - 1) % STAGES]);
      }
      mma_done(acc, &empty[(it - 1) % STAGES]);
    };
    // the GELU of chunk ch in place (as f32 bits) and the rows' maxima;
    // quantise: also store quant(h) into the hidden
    auto gelu = [&](int ch, bool quantise) {
      const int hc0 = wg * NCH * NWC + ch * NWC;  // CTA-local hidden column of acc's first
      const float sxr[2] = {sx[r0], sx[r0 + 8]}, shr[2] = {sh[r0], sh[r0 + 8]};
#pragma unroll
      for (int j = 0; j < NWC / 8; ++j) {
        const int hc = hc0 + 8 * j + 2 * c;
        const float2 w2 = *reinterpret_cast<const float2*>(p.s1 + rank * FC + hc);
        const float2 b2 = *reinterpret_cast<const float2*>(p.b1 + rank * FC + hc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const float y0 = gelu_tanh(dequant(acc[4 * j + 2 * h], sxr[h], w2.x, b2.x));
          const float y1 = gelu_tanh(dequant(acc[4 * j + 2 * h + 1], sxr[h], w2.y, b2.y));
          acc[4 * j + 2 * h] = __float_as_int(y0);
          acc[4 * j + 2 * h + 1] = __float_as_int(y1);
          mx[h] = fmaxf(mx[h], fmaxf(fabsf(y0), fabsf(y1)));
          if (quantise) {
            const int q0 = quant_value(y0, shr[h]), q1 = quant_value(y1, shr[h]);
            *reinterpret_cast<uint16_t*>(hid + a_off(r, hc)) =
                (uint16_t)((q0 & 0xff) | (q1 & 0xff) << 8);
          }
        }
      }
    };
    if constexpr (NCH == 1) {
      sweep();
      gelu(0, false);
    } else {  // the maxima first, then the chunks again, quantised
      for (int ch = 0; ch < NCH; ++ch) {
        sweep();
        gelu(ch, false);
      }
    }
    // (cta_rows' barrier: both warpgroups' products are done)
    const float m = cluster_rows(cta_rows(mx, true), X_HMAX, true);
    if (tid < AO_ROWS) sh[tid] = quant_scale(m);
    cta_sync();
    if constexpr (NCH == 1) {
      // into the hidden (HID_IN_A: the A operand's place, which nothing reads
      // any more)
      const float shr[2] = {sh[r0], sh[r0 + 8]};
#pragma unroll
      for (int j = 0; j < NWC / 8; ++j) {
        const int hc = wg * NWC + 8 * j + 2 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int q0 = quant_value(__int_as_float(acc[4 * j + 2 * h]), shr[h]);
          const int q1 = quant_value(__int_as_float(acc[4 * j + 2 * h + 1]), shr[h]);
          *reinterpret_cast<uint16_t*>(hid + a_off(r, hc)) =
              (uint16_t)((q0 & 0xff) | (q1 & 0xff) << 8);
        }
      }
    } else {
      for (int ch = 0; ch < NCH; ++ch) {
        sweep();
        gelu(ch, true);
      }
    }
    fence_proxy_async();  // the bulk copies read the hidden
    cta_sync();
    if (tid == 0) mbar_arrive(hid_ready);
  }

  // ---- 5. fc2, out = xf + ls2 y
  {
    int acc[HALF / 2];
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] = 0;
    for (int p = 0; p < T::KT2; ++p) {
      unsigned char* st = stage2(p);
      mma_slice(acc, st, st + SLICE + wg * HALF * AO_BK, &full2[p % T::FC2_STAGES],
                (p / T::FC2_STAGES) & 1);
      if (p > 0) release(&empty2[(p - 1) % T::FC2_STAGES]);
    }
    mma_done(acc, &empty2[(T::KT2 - 1) % T::FC2_STAGES]);
    const float shr[2] = {sh[r0], sh[r0 + 8]};
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int lc = wg * HALF + 8 * j + 2 * c, gc = rank * KC + lc;
      const float2 w2 = *reinterpret_cast<const float2*>(p.s2 + gc);
      const float2 b2 = *reinterpret_cast<const float2*>(p.b2 + gc);
      const float2 l2 = *reinterpret_cast<const float2*>(p.ls2 + gc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, row = m0 + r;
        const float2 x = *reinterpret_cast<const float2*>(xf + r * T::XLD + lc);
        const float y0 =
            __fadd_rn(x.x, __fmul_rn(l2.x, dequant(acc[4 * j + 2 * h], shr[h], w2.x, b2.x)));
        const float y1 =
            __fadd_rn(x.y, __fmul_rn(l2.y, dequant(acc[4 * j + 2 * h + 1], shr[h], w2.y, b2.y)));
        if (row < p.M) *reinterpret_cast<uint32_t*>(p.out + (size_t)row * K + gc) = pack_bf16(y0, y1);
      }
    }
  }
  cluster_arrive();  // this CTA's statistics and columns may go once every CTA is here
  cluster_wait();
}

template <class T>
cudaError_t ao_smem_once() {
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  return smem_allowance_once(smem_set, (const void*)attnout_mlp_kernel<T>, T::SMEM);
}

template <class T>
cudaLaunchConfig_t ao_config(int M, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T::C, (M + AO_ROWS - 1) / AO_ROWS);
  cfg.blockDim = dim3(AO_THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = T::C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class T>
cudaError_t launch_attnout_mlp(const AoArgs& p, const void* wo, const void* w1, const void* w2,
                               cudaStream_t st) {
  cudaError_t err = ao_smem_once<T>();
  if (err != cudaSuccess) return err;
  CUtensorMap two, tw1, tw2;
  if (!encode_2d(&two, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wo, T::K, T::K, AO_BK, T::KC) ||
      !encode_2d(&tw1, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w1, T::F, T::K, AO_BK, T::NWC) ||
      !encode_2d(&tw2, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w2, T::K, T::F, AO_BK, T::KC))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ao_config<T>(p.M, st, &attr);
  err = cudaLaunchKernelEx(&cfg, attnout_mlp_kernel<T>, two, tw1, tw2, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class T>
cudaError_t ao_active_clusters(int* n) {
  cudaError_t err = ao_smem_once<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = ao_config<T>(AO_ROWS, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, attnout_mlp_kernel<T>, &cfg);
}

// the row of AO_SHAPES that takes (K, F), or null
const AoShape* ao_shape(int K, int F) {
  for (const AoShape& s : AO_SHAPES)
    if (s.K == K && s.F == F) return &s;
  return nullptr;
}

}  // namespace
}  // namespace caim

// K12: ctx, res bf16 [M, K] -> out bf16 [M, K], the whole post-attention half
// of the chained int8 block in one launch (the notes at the top of this
// file); wo [K, K], w1 [F, K], w2 [K, F] int8 with K contiguous; so, bo, ls1,
// gamma, beta, s2, b2, ls2 f32 [K]; s1, b1 f32 [F]. (K, F) a pair that
// caim_attnout_mlp_cluster_size takes; every pointer 16-byte aligned. Launches
// on `stream`, does not synchronize, returns the CUDA error of the launch (0:
// none).
extern "C" int caim_int8_attnout_mlp(const void* ctx, const void* wo, const void* so,
                                     const void* bo, const void* ls1, const void* res,
                                     const void* gamma, const void* beta, float eps,
                                     const void* w1, const void* s1, const void* b1,
                                     const void* w2, const void* s2, const void* b2,
                                     const void* ls2, void* out, int M, int K, int F,
                                     void* stream) {
  using namespace caim;
  if (M <= 0 || ao_shape(K, F) == nullptr) return (int)cudaErrorInvalidValue;
  AoArgs p;
  p.ctx = static_cast<const bf16*>(ctx);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.so = static_cast<const float*>(so);
  p.bo = static_cast<const float*>(bo);
  p.ls1 = static_cast<const float*>(ls1);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.ls2 = static_cast<const float*>(ls2);
  p.eps = eps;
  p.M = M;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 768: return (int)launch_attnout_mlp<AoVitB>(p, wo, w1, w2, st);
    case 1024: return (int)launch_attnout_mlp<AoVitL>(p, wo, w1, w2, st);
    default: return (int)launch_attnout_mlp<AoTest>(p, wo, w1, w2, st);
  }
}

// The CTAs of K12's cluster at model width K and hidden width F, 0 where no
// instantiation takes (K, F).
extern "C" int caim_attnout_mlp_cluster_size(int K, int F) {
  const caim::AoShape* s = caim::ao_shape(K, F);
  return s == nullptr ? 0 : s->C;
}

// How many of K12's clusters at (K, F) the device runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int caim_attnout_mlp_active_clusters(int K, int F) {
  using namespace caim;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (ao_shape(K, F) != nullptr) {
    switch (K) {
      case 768: err = ao_active_clusters<AoVitB>(&n); break;
      case 1024: err = ao_active_clusters<AoVitL>(&n); break;
      default: err = ao_active_clusters<AoTest>(&n); break;
    }
  }
  return err == cudaSuccess ? n : -(int)err;
}
