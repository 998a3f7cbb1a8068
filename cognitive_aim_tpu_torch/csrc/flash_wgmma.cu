// The attention program of K1 and K7 (flash_attention_packed.cu), K8
// (flash_attention.cu), K10, K10b and K9 (flash_attention_i8qk.cu) and K11
// (flash_attention_out_res.cu), designed for Hopper.
//
// Computes, per (batch b, head h), softmax(Q K^T * scale [+ bias[b, key]]) V
// with bf16 operands, f32 scores, an f32 online softmax in base 2 (scale *
// log2 e folded in), keys past N masked, P rounded to bf16 un-normalised
// before the P V product, and the f32 accumulator divided by the f32 row sum
// at the end. Each operand is a [B, N, H, 64] view given by its element
// strides (batch, token, head): K1's packed [B, N, H*64] is the case (N H 64,
// H 64, 64), K8's views pass their own, so both launch this one kernel.
// The I8QK instantiation (K10, K10b, K9) takes q and k as int8 [B, N, H*64]
// with f32 scales sq, sk: K10's [B, N], one a row over all heads, or K9's
// [B, H, N], one a (row, head) over the head's 64 values; its scores are
// float(Q8 K8^T) * sq[(h,) row] * sk[(h,) key], the rest is the same.
//
// What bounds it on this card: at B 8, N 1370, H 12 one call is 46 GFLOP of
// bf16 products against 67 MB of q, k, v and out, ~690 FLOP/byte: above the
// ridge, so operation-bound (0.047 ms at 989 TFLOP/s). Beside the products
// the softmax spends an exp2 and a few f32 operations on each of the 180 M
// scores, as long again on the SM's multi-function and FMA pipes; and every
// block streams its head's K and V through shared memory, which the products
// read too. What the design does about it:
//   * A block owns 64 query rows of one (head, batch): one consumer
//     warpgroup and one producer warp, 64-key tiles. At 122 registers and
//     74 KB of shared memory a block, three blocks share an SM, whose
//     warpgroups run out of step, so that one's softmax covers the others'
//     products. The K and V traffic from L2 does not bound it: blocks of
//     128 query rows (two consumer warpgroups taking turns, 128-key tiles,
//     half the traffic) and a cluster of two 64-row blocks sharing each
//     tile by TMA multicast were both slower at every length measured, and
//     so were 128-key tiles for 64 rows (166 registers: ptxas serialises
//     the wgmmas) and fewer stages.
//   * Loads by TMA: a 4-D tensor map per operand over [B, N, H, 64] (d,
//     head, token, batch innermost first), box {64, 1, rows, 1}, 128-byte
//     swizzle (a head row of 64 bf16 is one 128-byte swizzle span). Rows past
//     N (N is a dimension of its own) arrive as zeros, so a tile never reads
//     the next batch's rows. One thread of the producer issues them: Q once,
//     then K and V of each key tile into a ring of stages with a full barrier
//     each for K and V and an empty barrier the consumers release.
//   * S = Q K^T: wgmma m64n64k16 over four k-steps of the head's 64 values,
//     B (K) from shared memory, K-major; A (Q) from registers, where a
//     64 x 64 x 16 product reading both operands from shared memory would
//     take its whole bandwidth.
//   * Softmax in place on the accumulators in registers: row maxima and
//     sums over the 4 lanes that share a row; P = exp2(S * scale log2 e - m)
//     in one FFMA and one MUFU.EX2 a score (ex2.approx.ftz: exp2f spends
//     three more instructions on subnormal results), then packed to bf16 as
//     the A fragments of the second product (the accumulator's 8-column tiles
//     2kk and 2kk + 1 are k-step kk's A fragment).
//   * O += P V: wgmma m64n64k16 with A from registers and B the V tile as it
//     lies, row-major [keys, 64], read MN-major (the transpose bit).
//   * Each iteration issues S of the next key tile and P V of this one, and
//     waits for both before the softmax. Overlapping the softmax with P V
//     inside a warpgroup (a second set of P registers, wgmma_wait<1>) was
//     slower: ptxas serialised every wgmma of the kernel (its warning C7514),
//     as it did when part of the exp2s ran on the FMA pipe.
//   * K7's bias row [B, N] f32 is only 4-byte aligned at N 481, so the
//     producer warp stages each key tile's slice with plain loads, times
//     log2 e and -inf past N, into the stage beside K, and arrives on K's
//     full barrier. K1 with a zero bias gives K7's bits: with b the staged
//     bias, K7's P is exp2(fma(S, scale log2 e, b - m)), K1's with b = 0.
//   * The epilogue writes O / l as bf16 into the consumer's Q tile (in the
//     same swizzle: no bank conflicts) and stores it with one TMA store,
//     which drops rows past N.
// The I8QK instantiation differs only where its operands do:
//   * q8 and k8 are read by TMA through int8 maps of the same shape, box
//     {64, 1, 64, 1}: a head row is 64 bytes, so the swizzle is 64-byte, and
//     a Q8 or K8 tile is 4 KB in place of 8. V and out keep K1's maps.
//   * S = Q8 K8^T is wgmma m64n64k32 s32.s8.s8, two k-steps for the head's
//     64 values, Q8 from registers (the int8 A fragment of mma.sync m16n8k32
//     within each warp's 16 rows), K8 from shared memory. Its int32 sums are
//     at most 64 x 127^2 < 2^24, so their conversion to f32 is exact.
//   * Dequantisation inside the softmax: the producer warp stages each key
//     tile's 64 sk values (K9's: its head's) beside K (as it stages K7's
//     bias, K's full barrier counting its 32 lanes), each consumer thread
//     holds sq * scale * log2 e of its two rows, and a score becomes
//     exp2(fma(float(acc) * sk_j, sq_i', b_j - m)): a conversion and a
//     multiply a score more than K1,
//     whose softmax's issue is what bounds it, so this is where the int8
//     program loses to K1 (the conversion as an integer add and an f32 add
//     on 1.5 x 2^23, which spares the conversion unit, was slower: one
//     instruction more a score). K10 masks its keys past N as K1 does.
//   * K10b's tile maximum is max(scores) * sq_i' + the tile's largest staged
//     bias (the producer reduces it over its warp): a bound of the biased
//     maximum, so its max pass is K10's, with no bias read and no FFMA a
//     score, and the bias is read once, in the exp2 pass. The softmax is the
//     same for any bound that no exp2 exceeds; the bound exceeds the true
//     maximum by at most the spread of the bias over the tile's keys, so the
//     tile's largest P is at least 2^-spread (the token filter's log-count
//     rows span < 31 in base 2; P underflows only past 126). With a zero row
//     it is K10's maximum, so K10b gives K10's bits, as K7's zero row gives
//     K1's. Taking the biased maximum as K7 does held 146 registers in this
//     instantiation: two blocks an SM, or spills under launch bounds for
//     three; both were slower at N 481 and 1370.
//   * The epilogue stages O (8 KB of bf16) in the V stage of the last key
//     tile, which the last P V has read and no load refills: the 4 KB Q8
//     tile is too small, and a tile of its own would cost 8 KB a block.
//   * 55 KB of shared memory and, under launch bounds for three blocks an SM
//     (5 warps a block: 128 registers a thread), 128 registers, no spill:
//     three blocks an SM, as K1.
// The OUT_RES instantiation (K11) is K1's block with the int8 attn_out
// projection, the LayerScale and the residual add behind it:
//   out = res + ls * (float(quant(ctx) wq^T) * sc * ws + b)
// where ctx is the f32 context of all H heads of a row and quant(ctx), sc
// its per-row quantisation over the whole H*64-wide row (s = max(max|x| /
// 127, 1e-12), true division, round-half-even, clip). The scale needs every
// head of a row, so the H blocks of one 64-row tile (one a head) run as a
// thread-block cluster (1, H, 1); H <= 16, the largest cluster the card
// takes (non-portable above 8), which covers every width of the port's
// models (ViT-B 12 heads, ViT-L 16). In order, in each CTA:
//   * Attention as K1's block, unchanged; then the head's context O (1 / l)
//     in f32 in registers, never rounded (P is rounded to bf16
//     un-normalised, as in K1; one reciprocal a row, as the TPU kernel
//     normalises: 32 divisions a thread took 1.5 us of the multi-function
//     unit, which the co-resident blocks' softmax keeps busy).
//   * The rows' max |ctx| over the head's 64 columns, pushed into every
//     CTA's row maxima by remote atomic max (red.shared::cluster: a maximum
//     does not depend on the order, so every CTA finds the same scale),
//     then an arrival on every CTA's mbarrier (release at cluster scope).
//     Once a CTA has all H arrivals, every CTA of the cluster has finished
//     its attention, so its Q, K and V buffers may be overwritten.
//   * The head's 64 columns quantised (div_rn) into its block of the int8
//     context tile A [64, H*64], which lies where Q and K were: H blocks of
//     64 rows x 64 bytes in the 64-byte swizzle, one per head, each a TMA
//     box of the int8 [B, N, H, 64] view of ctx8.
//   * The int8 context shared through L2: the CTA stores its block into
//     ctx8 (the wrapper's scratch, or the int8 context return_quantised
//     returns) by TMA, waits for the write, and loads it back with one TMA
//     multicast into every other CTA's A (rows past N drop on the store and
//     arrive as zeros; their outputs are never stored). A bulk copy of the
//     block into each peer's shared memory through distributed shared
//     memory was 4% slower end to end (a development build).
//   * attn_out for the CTA's own 64 output columns over the full depth
//     H*64: wgmma m64n64k32 s8 with A and B from shared memory, the producer
//     warp streaming wq's 64 rows in 64-deep stages (4 KB, 64-byte swizzle)
//     into the ring that K and V left (6 stages at ViT-B, 2 at ViT-L).
//   * The epilogue: res + ls (acc sc ws + b) in f32, one rounding to bf16,
//     staged in the ring in K1's swizzle and stored by TMA (rows past N
//     dropped); the residual is read into registers while the cluster
//     exchanges. A barrier.cluster at the start (every CTA's barriers
//     exist before a peer arrives on them) and one at the end (no CTA
//     leaves while a peer may still write into it).
// What bounds K11 on this card: K1's work and K3's (at B 8, N 1370, H 12:
// 46 GFLOP of bf16 and 12.9 GOP of int8 products, 84 MB of q, k, v, res
// and out) is operations, 0.053 ms; the kernel is far from it. The shared
// memory is K1's ring (72 KB): with the maxima and six more barriers a block
// keeps three an SM, so the attention runs as K1's does (K11 stopped after
// its attention takes 1.05x K1). What it adds: a cluster lives in one GPC,
// so 28 clusters of 12 are resident (336 of the 396 blocks three an SM
// would hold) and 176 clusters run in 6.3 waves; and a tile's tail runs in
// series behind its slowest CTA. Timer stamps of a development build (a
// cluster's life 30 us at ViT-B, N 1370, of which 20 us of attention): the
// maxima's exchange 1.3 us and the wait for the slowest CTA 0.8, the
// quantisation and the shared context 1.5, the projection 4.1 (24 wgmma of
// 64 x 64 x 32 in series, beside the co-resident blocks' attention; not the
// loads of wq: with no refill of the ring it was 1% faster), the epilogue
// 0.8 and the final barrier 1.3.
#include "flash_wgmma.cuh"
#include "tile_common.cuh"

namespace caim {

namespace {

constexpr int ROW_BYTES = 128;  // one head row of v and out: 64 bf16
constexpr int QT = 64;          // query rows of a block: one consumer warpgroup
constexpr int KT = 64;          // keys of a K or V tile
constexpr int THREADS = 128 + 32;  // the consumer warpgroup and a producer warp
constexpr int STAGES = 4;  // three blocks an SM still fit in shared memory
constexpr int W_BYTES = 64 * 64;  // OUT_RES: a stage of wq (64 rows x 64 bytes), a head's A block
constexpr int W_MAX_STAGES = 8;
constexpr int OUT_RES_MAX_HEADS = 16;  // K11: the largest cluster the card takes (non-portable)

// OUT_RES (K11): what the projection behind the attention reads
struct OutRes {
  const float *ws, *bias, *ls;  // [H*64]
  const bf16* res;              // [B, N, H*64]
  float* sc;                    // null, or [B, N]: the rows' quantisation scales
  int H;                        // heads, the CTAs of a cluster
};

template <bool BIAS, bool I8QK, bool OUT_RES = false>
struct FlashTile {
  static_assert(!OUT_RES || (!BIAS && !I8QK), "K11 is K1's block with a projection behind it");
  static constexpr int QK_ROW = I8QK ? 64 : ROW_BYTES;  // one head row of q, k in bytes
  static constexpr int Q_BYTES = QT * QK_ROW;
  static constexpr int K_BYTES = KT * QK_ROW;
  static constexpr int V_BYTES = KT * ROW_BYTES;
  static constexpr int K_OFF = Q_BYTES;  // every tile starts on a 1024-byte boundary
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int B_OFF = V_OFF + STAGES * V_BYTES;  // BIAS: the staged bias rows
  static constexpr int S_OFF = B_OFF + (BIAS ? STAGES * KT * 4 : 0);  // I8QK: staged sk
  // I8QK with BIAS: each stage's largest bias
  static constexpr int M_OFF = S_OFF + (I8QK ? STAGES * KT * 4 : 0);
  static constexpr int BAR_OFF = M_OFF + (I8QK && BIAS ? STAGES * 4 : 0);
  static constexpr int NBARS = 1 + 3 * STAGES;  // Q; K full, V full, empty per stage
  // OUT_RES: the cluster's maxima, the peers' int8 context, wq's full and
  // empty per stage; then the rows' max |ctx| (f32 bits)
  static constexpr int XBAR_OFF = BAR_OFF + NBARS * 8;
  static constexpr int ROWMAX_OFF = XBAR_OFF + (OUT_RES ? (2 + 2 * W_MAX_STAGES) * 8 : 0);
  static constexpr size_t SMEM = ROWMAX_OFF + (OUT_RES ? QT * 4 : 0) + 1024;  // + room to align
};

// S = Q K^T of one key tile: four k-steps of 16 head values, A (Q) from
// registers (qf). Both issue functions pin their register operands first: an
// instruction that the compiler let sink between wgmma.fence and the wgmma
// would make ptxas serialise every wgmma.
__device__ __forceinline__ void issue_qk(float (&s)[KT / 2], const uint32_t (&qf)[4][4],
                                         uint64_t dk) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_bf16_64x64_rs<false>(s, qf[kk], dk + 2 * kk, kk);
  wgmma_commit();
}

// The int8 S = Q8 K8^T: two k-steps of 32 head values (a k-step advances
// the 64-byte-swizzled descriptor by 32 bytes)
__device__ __forceinline__ void issue_qk(int (&s)[KT / 2], const uint32_t (&qf)[2][4],
                                         uint64_t dk) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wgmma_s8_64x64_rs(s, qf[kk], dk + 2 * kk, kk);
  wgmma_commit();
}

// O += P V of one key tile: KT / 16 k-steps of 16 keys
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&p)[KT / 16][4],
                                         uint64_t dv) {
  fence_operands(o);
  fence_operands(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) wgmma_bf16_64x64_rs<true>(o, p[kk], dv + 128 * kk, 1);
  wgmma_commit();
}

// The int8 scores of one key tile as f32 times the staged sk of their keys
// (columns 8j + 2c, + 1): float(acc) exact, one rounding for the product
__device__ __forceinline__ void dequant_keys(const int (&acc)[KT / 2], float (&s)[KT / 2],
                                             const float* ks, int c) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const float2 k2 = *reinterpret_cast<const float2*>(&ks[8 * j + 2 * c]);
    s[4 * j] = (float)acc[4 * j] * k2.x;
    s[4 * j + 1] = (float)acc[4 * j + 1] * k2.y;
    s[4 * j + 2] = (float)acc[4 * j + 2] * k2.x;
    s[4 * j + 3] = (float)acc[4 * j + 3] * k2.y;
  }
}

// The online softmax of one key tile, in place. s: its scores (this thread's
// rows g and g + 8, columns 8j + 2c, + 1), which become the un-normalised
// probabilities P in f32; sl0, sl1: the scale times log2 e of rows g and
// g + 8 (the same for bf16 q, k; times each row's sq for I8QK); bs: BIAS,
// the staged bias row (bias * log2 e, -inf past N). MASK: keys from kvalid
// on are past N (K1's and K10's last tile, K10b's too). BMAX (K10b): the
// tile's maximum is taken as max(s) * sl + bmax, bmax the largest staged
// bias of the tile: a bound of the biased maximum (the softmax does not
// depend on which bound it subtracts as long as no exp2 overflows) that
// costs no bias read and no FFMA a score, and that with a zero row is
// K10's maximum. Updates the running maxima m (base 2, scaled) and sums l,
// and gives the factors a0, a1 by which O's rows must be rescaled.
template <bool BIAS, bool MASK, bool BMAX>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], const float* bs, int kvalid,
                                             float sl0, float sl1, float bmax, int c, float& m0,
                                             float& m1, float& l0, float& l1, float& a0,
                                             float& a1) {
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      if (8 * (i / 4) + 2 * c + (i & 1) >= kvalid) s[i] = -INFINITY;
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    if constexpr (BIAS && !BMAX) {
      const float2 kb = *reinterpret_cast<const float2*>(&bs[8 * j + 2 * c]);
      mx0 = fmaxf(mx0, fmaxf(fmaf(s[4 * j], sl0, kb.x), fmaf(s[4 * j + 1], sl0, kb.y)));
      mx1 = fmaxf(mx1, fmaxf(fmaf(s[4 * j + 2], sl1, kb.x), fmaf(s[4 * j + 3], sl1, kb.y)));
    } else {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the 4 lanes of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  if constexpr (!BIAS) {  // scale >= 0: the maximum of the scaled scores
    mx0 *= sl0;
    mx1 *= sl1;
  } else if constexpr (BMAX) {
    mx0 = fmaf(mx0, sl0, bmax);
    mx1 = fmaf(mx1, sl1, bmax);
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a key is valid
  a0 = exp2_ftz(m0 - mn0);  // 0 on the first tile
  a1 = exp2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    float b0 = -mn0, b1 = -mn0, b2 = -mn1, b3 = -mn1;
    if constexpr (BIAS) {
      const float2 kb = *reinterpret_cast<const float2*>(&bs[8 * j + 2 * c]);
      b0 = kb.x - mn0;
      b1 = kb.y - mn0;
      b2 = kb.x - mn1;
      b3 = kb.y - mn1;
    }
    s[4 * j] = exp2_ftz(fmaf(s[4 * j], sl0, b0));
    s[4 * j + 1] = exp2_ftz(fmaf(s[4 * j + 1], sl0, b1));
    s[4 * j + 2] = exp2_ftz(fmaf(s[4 * j + 2], sl1, b2));
    s[4 * j + 3] = exp2_ftz(fmaf(s[4 * j + 3], sl1, b3));
    r0 += s[4 * j] + s[4 * j + 1];  // the f32 sum normalises
    r1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
}

// The last tile of K1, K10 and K10b masks its keys past N; every other tile
// and K7 (whose staged bias is -inf there) need no mask. K10b's maximum
// reads the scores without the bias, so they are masked too.
template <bool BIAS, bool I8QK>
__device__ __forceinline__ void softmax_any(float (&s)[KT / 2], const float* bs, int kvalid,
                                            float sl0, float sl1, float bmax, int c, float& m0,
                                            float& m1, float& l0, float& l1, float& a0,
                                            float& a1) {
  constexpr bool BMAX = BIAS && I8QK;
  if ((!BIAS || BMAX) && kvalid < KT)
    softmax_tile<BIAS, true, BMAX>(s, bs, kvalid, sl0, sl1, bmax, c, m0, m1, l0, l1, a0, a1);
  else
    softmax_tile<BIAS, false, BMAX>(s, bs, kvalid, sl0, sl1, bmax, c, m0, m1, l0, l1, a0, a1);
}

// P as bf16 A fragments of the P V product: the accumulator's 8-column tiles
// 2kk (registers 0, 1) and 2kk + 1 (registers 2, 3) are k-step kk's fragment
__device__ __forceinline__ void pack_p(const float (&s)[KT / 2], uint32_t (&p)[KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);      // row g
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);  // row g + 8
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Two int8 values, the first lowest
__device__ __forceinline__ uint16_t pack_s8x2(int a, int b) {
  return (uint16_t)((a & 0xff) | (b & 0xff) << 8);
}

// K11's projection: acc += A wq_h^T over the depth H*64, 64 a stage (wgmma
// m64n64k32, A's block s and wq's stage s from shared memory), one stage's
// products in flight behind the next's, each stage released to the producer
// once its products are done.
__device__ __forceinline__ void project(int (&acc)[32], const unsigned char* a,
                                        const unsigned char* ring, int wst, int H,
                                        uint64_t* w_full, uint64_t* w_empty, int lane) {
  for (int s = 0; s < H; ++s) {
    const int st = s % wst;
    mbar_wait(&w_full[st], (s / wst) & 1);
    const uint64_t da = wgmma_desc_sw64(a + s * W_BYTES);
    const uint64_t db = wgmma_desc_sw64(ring + st * W_BYTES);
    fence_operands(acc);
    wgmma_fence();
    wgmma_s8<64>(acc, da, db);
    wgmma_s8<64>(acc, da + 2, db + 2);  // a k-step of 32 bytes
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(acc);
    if (s > 0) {  // the previous stage's products are done
      __syncwarp();
      if (lane == 0) mbar_arrive(&w_empty[(s - 1) % wst]);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
}

// K11's part after the attention, for the consumer warpgroup of the head h
// (the CTA of cluster rank h) of query rows q0 .. q0 + 63: o holds the head's
// un-normalised context of rows r0, r0 + 8 (K1's accumulator), l0, l1 their
// f32 sums. The cluster's row maxima give the rows' scales; the head's
// columns are quantised into A's block h, stored into ctx8 and multicast
// into every other CTA's A; then out[:, h*64 .. h*64 + 63] = res + ls (quant
// (ctx) wq^T sc ws + b) over the full depth H*64, stored by TMA.
__device__ __forceinline__ void out_res_epilogue(
    float (&o)[32], float l0, float l1, unsigned char* smem, unsigned char* ring, int wst,
    uint64_t* x_full, uint64_t* a_ready, uint64_t* w_full, uint64_t* w_empty, uint32_t* rowmax,
    const CUtensorMap& to, const CUtensorMap& tc, const OutRes& ox, int N, int q0, int h, int b,
    int tid) {
  const int H = ox.H, HD = H * 64;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8
  // the f32 context, O (1 / l) as the TPU kernel normalises (one reciprocal
  // a row: the co-resident blocks' softmax keeps the multi-function unit
  // busy), never rounded to bf16; and each row's max |ctx| over the head
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  float mx0 = 0.0f, mx1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= i0;
    o[4 * j + 1] *= i0;
    o[4 * j + 2] *= i1;
    o[4 * j + 3] *= i1;
    mx0 = fmaxf(mx0, fmaxf(fabsf(o[4 * j]), fabsf(o[4 * j + 1])));
    mx1 = fmaxf(mx1, fmaxf(fabsf(o[4 * j + 2]), fabsf(o[4 * j + 3])));
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the 4 lanes of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  // into every CTA's row maxima (lane c serves CTAs c, c + 4, ...), then
  // one release-arrival on each CTA's x_full: all its maxima are in
  for (int p = c; p < H; p += 4) {
    red_max_cluster(cluster_map(&rowmax[r0], p), __float_as_uint(mx0));
    red_max_cluster(cluster_map(&rowmax[r0 + 8], p), __float_as_uint(mx1));
  }
  named_barrier_sync(1, 128);
  if (tid < H) mbar_arrive_cluster(cluster_map(x_full, tid));
  // the residual of this thread's outputs, loaded while the cluster
  // exchanges (rows past N: row N - 1's, never stored)
  uint32_t rb[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = min(q0 + r0 + 8 * e, N - 1);
      rb[2 * j + e] = *reinterpret_cast<const uint32_t*>(ox.res + ((size_t)b * N + row) * HD +
                                                          h * 64 + 8 * j + 2 * c);
    }
  mbar_wait_cluster(x_full, 0);  // every CTA's maxima, hence its attention, are done
  const float sx0 = quant_scale(__uint_as_float(rowmax[r0]));
  const float sx1 = quant_scale(__uint_as_float(rowmax[r0 + 8]));
  if (ox.sc != nullptr && h == 0 && c == 0) {
    if (q0 + r0 < N) ox.sc[(size_t)b * N + q0 + r0] = sx0;
    if (q0 + r0 + 8 < N) ox.sc[(size_t)b * N + q0 + r0 + 8] = sx1;
  }
  // the head's columns into A's block h: the 16-byte chunk ch of row r at
  // chunk ch ^ ((r >> 1) & 3) (64-byte swizzle; rows r0 and r0 + 8 alike)
  unsigned char* own = smem + h * W_BYTES;
  const int sw = (g >> 1) & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int off = (((j >> 1) ^ sw) << 4) + 8 * (j & 1) + 2 * c;
    *reinterpret_cast<uint16_t*>(own + r0 * 64 + off) =
        pack_s8x2(quant_value(o[4 * j], sx0), quant_value(o[4 * j + 1], sx0));
    *reinterpret_cast<uint16_t*>(own + (r0 + 8) * 64 + off) =
        pack_s8x2(quant_value(o[4 * j + 2], sx1), quant_value(o[4 * j + 3], sx1));
  }
  fence_proxy_async();  // the block is read by TMA and wgmma
  named_barrier_sync(1, 128);
  if (tid == 0) {
    mbar_arrive_expect_tx(a_ready, (H - 1) * W_BYTES);
    tma_store_4d(&tc, own, 0, h, q0, b);
    tma_store_commit();
    tma_store_wait_all();  // in L2 before it is read back
    fence_proxy_async_global();
    if (H > 1)
      tma_load_4d_multicast(own, &tc, a_ready, 0, h, q0, b,
                            (uint16_t)(((1u << H) - 1) & ~(1u << h)));
  }
  // out's columns h*64 .. + 63 over the depth H*64
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  mbar_wait(a_ready, 0);
  project(acc, smem, ring, wst, H, w_full, w_empty, lane);
  // res + ls (acc sc ws + b), one rounding, staged in the ring (its stages
  // are read) in the store's 128-byte swizzle; one TMA store of 64 rows
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = h * 64 + 8 * j + 2 * c;
    const float2 w2 = *reinterpret_cast<const float2*>(ox.ws + col);
    const float2 b2 = *reinterpret_cast<const float2*>(ox.bias + col);
    const float2 l2 = *reinterpret_cast<const float2*>(ox.ls + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sx = e ? sx1 : sx0;
      const float2 rv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rb[2 * j + e]));
      const float y0 =
          __fadd_rn(rv.x, __fmul_rn(l2.x, dequant(acc[4 * j + 2 * e], sx, w2.x, b2.x)));
      const float y1 =
          __fadd_rn(rv.y, __fmul_rn(l2.y, dequant(acc[4 * j + 2 * e + 1], sx, w2.y, b2.y)));
      *reinterpret_cast<uint32_t*>(ring + (r0 + 8 * e) * ROW_BYTES + ((j ^ g) << 4) + 4 * c) =
          pack_bf16(y0, y1);
    }
  }
  fence_proxy_async();
  named_barrier_sync(1, 128);
  if (tid == 0) {
    tma_store_4d(&to, ring, 0, h, q0, b);
    tma_store_wait();
  }
  cluster_arrive();  // no CTA leaves while a peer may still write into it
  cluster_wait();
}

// The block of (query tile blockIdx.x, head blockIdx.y, batch blockIdx.z).
// Warpgroup 0 consumes, warp 4 produces. q_scale, k_scale: I8QK's scales
// (null otherwise): K10's sq, sk [B, N], or with head_scales K9's [B, H, N].
// OUT_RES: the blocks of a query tile are one cluster, tw the map of wq
// (int8 [H*64, H*64], boxes of 64 rows x 64 bytes), tc that of ctx8 (int8
// [B, N, H, 64], boxes of 64 tokens of one head), ox the rest; the others
// pass any map there.
template <bool BIAS, bool I8QK, bool OUT_RES>
__global__ void __launch_bounds__(THREADS, I8QK || OUT_RES ? 3 : 2)  // 128 registers, 3 an SM
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tc,
                   const float* __restrict__ bias, const float* __restrict__ q_scale,
                   const float* __restrict__ k_scale, int head_scales, int N, float sl2,
                   const OutRes ox) {
  using T = FlashTile<BIAS, I8QK, OUT_RES>;
  constexpr bool STAGED = BIAS || I8QK;  // the producer warp stages rows beside K
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle is a function of the address: start on a 1024-byte boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;
  float* bias_stage = reinterpret_cast<float*>(smem + T::B_OFF);
  float* sk_stage = reinterpret_cast<float*>(smem + T::S_OFF);
  float* bmax_stage = reinterpret_cast<float*>(smem + T::M_OFF);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  // I8QK: this (batch, head)'s scales of rows 0 .. N - 1
  const size_t s0 = head_scales ? ((size_t)b * gridDim.y + h) * N : (size_t)b * N;
  const int ntiles = (N + KT - 1) / KT;
  const int tid = threadIdx.x % 128;
  // OUT_RES: the int8 context tile A (a 4 KB block a head) from offset 0, the
  // ring of wq's stages behind it, both where Q, K and V lay
  [[maybe_unused]] uint64_t* x_full = reinterpret_cast<uint64_t*>(smem + T::XBAR_OFF);
  [[maybe_unused]] uint64_t* a_ready = x_full + 1;
  [[maybe_unused]] uint64_t* w_full = x_full + 2;
  [[maybe_unused]] uint64_t* w_empty = w_full + W_MAX_STAGES;
  [[maybe_unused]] uint32_t* rowmax = reinterpret_cast<uint32_t*>(smem + T::ROWMAX_OFF);
  [[maybe_unused]] unsigned char* ring = smem + ox.H * W_BYTES;
  [[maybe_unused]] const int wst = min(W_MAX_STAGES, (T::B_OFF - ox.H * W_BYTES) / W_BYTES);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], STAGED ? 33 : 1);  // STAGED: + the producer warp's 32 lanes
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128);
    }
    if constexpr (OUT_RES) {
      mbar_init(x_full, ox.H);  // an arrival from each CTA of the cluster
      mbar_init(a_ready, 1);    // and the peers' bytes
      for (int s = 0; s < W_MAX_STAGES; ++s) {
        mbar_init(&w_full[s], 1);
        mbar_init(&w_empty[s], 4);  // each consumer warp
      }
    }
    mbar_init_fence();
  }
  if constexpr (OUT_RES) {
    if (threadIdx.x < QT) rowmax[threadIdx.x] = 0u;
  }
  __syncthreads();
  if constexpr (OUT_RES) {  // every CTA's barriers and maxima exist before a peer touches them
    cluster_arrive();
    cluster_wait();
  }

  if (threadIdx.x >= 128) {  // ---- producer: one warp
    if (!STAGED && tid != 0) {  // one thread loads
      if constexpr (OUT_RES) {  // (K11's final cluster barrier, below)
        cluster_arrive();
        cluster_wait();
      }
      return;
    }
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      tma_load_4d(smem, &tq, q_full, 0, h, q0, b);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);  // released by the consumers
      if constexpr (STAGED) {
        [[maybe_unused]] float bm = -INFINITY;  // K10b: the stage's largest bias
        for (int i = tid; i < KT; i += 32) {
          const int key = t * KT + i;
          if constexpr (BIAS) {
            const float kb =
                key < N ? (bias != nullptr ? bias[(size_t)b * N + key] * LOG2E : 0.0f)
                        : -INFINITY;
            bias_stage[s * KT + i] = kb;
            if constexpr (I8QK) bm = fmaxf(bm, kb);
          }
          if constexpr (I8QK)
            sk_stage[s * KT + i] = key < N ? k_scale[s0 + key] : 0.0f;
        }
        if constexpr (I8QK && BIAS) {
          bm = warp_max(bm);
          if (tid == 0) bmax_stage[s] = bm;
        }
        mbar_arrive(&k_full[s]);
      }
      if (tid == 0) {
        mbar_arrive_expect_tx(&k_full[s], T::K_BYTES);
        tma_load_4d(smem + T::K_OFF + s * T::K_BYTES, &tk, &k_full[s], 0, h, t * KT, b);
        mbar_arrive_expect_tx(&v_full[s], T::V_BYTES);
        tma_load_4d(smem + T::V_OFF + s * T::V_BYTES, &tv, &v_full[s], 0, h, t * KT, b);
      }
    }
    if constexpr (OUT_RES) {  // wq's rows of this head's output columns, 64 deep a stage
      for (int t = ntiles; t < ntiles + STAGES; ++t)  // every K and V stage read: the ring is free
        mbar_wait(&empty[t % STAGES], ((t / STAGES) & 1) ^ 1);
      for (int s = 0; s < ox.H; ++s) {
        const int st = s % wst;
        mbar_wait(&w_empty[st], ((s / wst) & 1) ^ 1);
        mbar_arrive_expect_tx(&w_full[st], W_BYTES);
        tma_load_2d(ring + st * W_BYTES, &tw, &w_full[st], s * 64, h * 64);
      }
      cluster_arrive();  // no CTA leaves while a peer may still write into it
      cluster_wait();
    }
  } else {  // ---- consumer: the 64 query rows
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
    unsigned char* qs = smem;
    const unsigned char* ks = smem + T::K_OFF;
    const unsigned char* vs = smem + T::V_OFF;
    const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8; both g modulo 8

    // s: a tile's scores, then its P in f32; si: I8QK, its int32 scores;
    // p: P as bf16 A fragments; o: the f32 accumulator
    float s[KT / 2], o[32];
    [[maybe_unused]] int si[KT / 2];
    uint32_t p[KT / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, a0, a1;
    float sl0 = sl2, sl1 = sl2;  // rows r0, r0 + 8
    if constexpr (I8QK) {  // rows past N keep sl2: their outputs are not stored
      const int row0 = q0 + r0, row1 = row0 + 8;
      if (row0 < N) sl0 = q_scale[s0 + row0] * sl2;
      if (row1 < N) sl1 = q_scale[s0 + row1] * sl2;
    }

    mbar_wait(q_full, 0);
    // Q's A fragments. bf16: k-step kk = head values 16kk .. 16kk + 15, the
    // 16-byte chunk ch of row r at chunk ch ^ (r & 7) (128-byte swizzle).
    // int8: k-step kk = bytes 32kk .. 32kk + 31, chunk ch of row r at chunk
    // ch ^ ((r >> 1) & 3) (64-byte swizzle), for rows r0, r0 + 8 (g >> 1) & 3.
    uint32_t qf[I8QK ? 2 : 4][4];
    if constexpr (I8QK) {
      const int sw = (g >> 1) & 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int lo = (((2 * kk) ^ sw) << 4) + 4 * c, hi = (((2 * kk + 1) ^ sw) << 4) + 4 * c;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qs + r0 * T::QK_ROW + lo);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * T::QK_ROW + lo);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qs + r0 * T::QK_ROW + hi);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * T::QK_ROW + hi);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int lo = (((2 * kk) ^ g) << 4) + 4 * c, hi = (((2 * kk + 1) ^ g) << 4) + 4 * c;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qs + r0 * ROW_BYTES + lo);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * ROW_BYTES + lo);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qs + r0 * ROW_BYTES + hi);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * ROW_BYTES + hi);
      }
    }
    // the K tile of stage st as a wgmma operand
    auto k_desc = [&](int st) {
      if constexpr (I8QK) return wgmma_desc_sw64(ks + st * T::K_BYTES);
      else return wgmma_desc_sw128(ks + st * T::K_BYTES);
    };
    mbar_wait(&k_full[0], 0);
    if constexpr (I8QK) {
      issue_qk(si, qf, k_desc(0));
      wgmma_wait<0>();
      fence_operands(si);
      dequant_keys(si, s, sk_stage, c);
    } else {
      issue_qk(s, qf, k_desc(0));
      wgmma_wait<0>();
      fence_operands(s);
    }
    softmax_any<BIAS, I8QK>(s, bias_stage, min(KT, N), sl0, sl1,
                            I8QK && BIAS ? bmax_stage[0] : 0.0f, c, m0, m1, l0, l1, a0, a1);
    pack_p(s, p);

    for (int t = 0; t < ntiles; ++t) {
      const int st = t % STAGES;
      const int t1 = t + 1, s1 = t1 % STAGES;
      if (t1 < ntiles) mbar_wait(&k_full[s1], (t1 / STAGES) & 1);
      mbar_wait(&v_full[st], (t / STAGES) & 1);
      if (t1 < ntiles) {  // the next tile's scores beside P V of this one
        if constexpr (I8QK)
          issue_qk(si, qf, k_desc(s1));
        else
          issue_qk(s, qf, k_desc(s1));
      }
      issue_pv(o, p, wgmma_desc_sw128(vs + st * T::V_BYTES));
      wgmma_wait<0>();
      if constexpr (I8QK)
        fence_operands(si);
      else
        fence_operands(s);
      fence_operands(o);
      fence_operands(p);
      mbar_arrive(&empty[st]);  // this stage's K and V are read
      if (t1 < ntiles) {
        if constexpr (I8QK) dequant_keys(si, s, sk_stage + s1 * KT, c);
        softmax_any<BIAS, I8QK>(s, bias_stage + s1 * KT, min(KT, N - t1 * KT), sl0, sl1,
                                I8QK && BIAS ? bmax_stage[s1] : 0.0f, c, m0, m1, l0, l1, a0,
                                a1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        pack_p(s, p);
      }
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    if constexpr (OUT_RES) {
      out_res_epilogue(o, l0, l1, smem, ring, wst, x_full, a_ready, w_full, w_empty, rowmax, to,
                       tc, ox, N, q0, h, b, tid);
      return;
    }
    // O / l as bf16 into a 128-byte-swizzled staging tile (as the store's
    // tensor map expects): the Q tile, or I8QK the last tile's V stage, which
    // the last P V has read and no load refills; then one TMA store of its
    // 64 rows
    unsigned char* os = I8QK ? smem + T::V_OFF + ((ntiles - 1) % STAGES) * T::V_BYTES : qs;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = ((j ^ g) << 4) + 4 * c;
      *reinterpret_cast<uint32_t*>(os + r0 * ROW_BYTES + col) =
          pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
      *reinterpret_cast<uint32_t*>(os + (r0 + 8) * ROW_BYTES + col) =
          pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
    fence_proxy_async();
    named_barrier_sync(1, 128);  // the consumer warpgroup only
    if (tid == 0) {
      tma_store_4d(&to, os, 0, h, q0, b);
      tma_store_wait();
    }
  }
}

// the map of one [B, N, H, 64] bf16 operand, boxes of `rows` tokens of one head
bool head_map(CUtensorMap* map, const void* base, HeadStrides s, int B, int N, int H, int rows) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.n * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

// the map of a contiguous int8 [B, N, H*64] operand as [B, N, H, 64], boxes
// of 64 tokens of one head, 64-byte swizzle (one head row)
bool head_map_i8(CUtensorMap* map, const void* base, int B, int N, int H) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {64, (cuuint64_t)H * 64, (cuuint64_t)N * H * 64};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_64B);
}

template <bool BIAS, bool I8QK, bool OUT_RES = false>
cudaError_t smem_once() {
  static std::atomic<unsigned long long> smem_set{0};  // the allowance, once per process
  return smem_allowance_once(smem_set, (const void*)flash_wgmma_kernel<BIAS, I8QK, OUT_RES>,
                             FlashTile<BIAS, I8QK, OUT_RES>::SMEM);
}

// tq, tk: the q and k maps (bf16, or I8QK int8); v and out bf16
template <bool BIAS, bool I8QK>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const void* v, HeadStrides sv,
                   const float* bias, const float* q_scale, const float* k_scale,
                   bool head_scales, void* out, int B, int N, int H, float scale,
                   cudaStream_t stream) {
  cudaError_t err = smem_once<BIAS, I8QK>();
  if (err != cudaSuccess) return err;
  const HeadStrides so{(long long)N * H * 64, (long long)H * 64, 64};
  CUtensorMap tv, to;
  if (!head_map(&tv, v, sv, B, N, H, KT) || !head_map(&to, out, so, B, N, H, QT))
    return cudaErrorInvalidValue;
  const dim3 grid((N + QT - 1) / QT, H, B);
  flash_wgmma_kernel<BIAS, I8QK, false><<<grid, THREADS, FlashTile<BIAS, I8QK>::SMEM, stream>>>(
      tq, tk, tv, to, to, to, bias, q_scale, k_scale, head_scales ? 1 : 0, N, scale * LOG2E,
      OutRes{});
  return cudaGetLastError();
}

bool strides_ok(const HeadStrides& s) {
  return s.b >= 0 && s.n >= 0 && s.h >= 0 && s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0;
}

bool shape_ok(int B, int N, int H) {
  return B > 0 && N > 0 && H > 0 && B <= 65535 && H <= 65535;
}

template <bool I8QK>
cudaError_t blocks_per_sm(bool biased, int* n) {
  cudaError_t err = biased ? smem_once<true, I8QK>() : smem_once<false, I8QK>();
  if (err != cudaSuccess) return err;
  return biased ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      n, flash_wgmma_kernel<true, I8QK, false>, THREADS,
                      FlashTile<true, I8QK>::SMEM)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      n, flash_wgmma_kernel<false, I8QK, false>, THREADS,
                      FlashTile<false, I8QK>::SMEM);
}

// K11's kernel, its shared memory and, for clusters over 8 CTAs, the
// non-portable cluster sizes allowed once per process
using OutResTile = FlashTile<false, false, true>;
cudaError_t out_res_once() {
  static std::atomic<unsigned long long> cluster_set{0};
  cudaError_t err = smem_once<false, false, true>();
  if (err != cudaSuccess) return err;
  return attribute_once(cluster_set, (const void*)flash_wgmma_kernel<false, false, true>,
                        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// K11's launch: a cluster of the H blocks of a query tile
cudaLaunchConfig_t out_res_config(int B, int N, int H, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + QT - 1) / QT, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = OutResTile::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = H;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

cudaError_t launch_flash_bf16(const void* q, HeadStrides sq, const void* k, HeadStrides sk,
                              const void* v, HeadStrides sv, const float* bias, void* out,
                              int B, int N, int H, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, H) || !strides_ok(sq) || !strides_ok(sk) || !strides_ok(sv))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk;
  if (!head_map(&tq, q, sq, B, N, H, QT) || !head_map(&tk, k, sk, B, N, H, KT))
    return cudaErrorInvalidValue;
  // K1 without a bias takes the BIAS program (a zero row) where the scale is
  // not positive: the unbiased program finds the row maximum before scaling
  const bool biased = bias != nullptr || !(scale > 0.0f);
  return biased ? launch<true, false>(tq, tk, v, sv, bias, nullptr, nullptr, false, out, B, N, H,
                                      scale, stream)
                : launch<false, false>(tq, tk, v, sv, bias, nullptr, nullptr, false, out, B, N, H,
                                       scale, stream);
}

cudaError_t launch_flash_i8qk(const void* q8, const float* q_scale, const void* k8,
                              const float* k_scale, bool head_scales, const void* v,
                              const float* bias, void* out, int B, int N, int H, float scale,
                              cudaStream_t stream) {
  if (!shape_ok(B, N, H)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk;
  if (!head_map_i8(&tq, q8, B, N, H) || !head_map_i8(&tk, k8, B, N, H))
    return cudaErrorInvalidValue;
  const HeadStrides sv{(long long)N * H * 64, (long long)H * 64, 64};
  // as K1: a scale that is not positive takes the BIAS program (sq > 0)
  const bool biased = bias != nullptr || !(scale > 0.0f);
  return biased ? launch<true, true>(tq, tk, v, sv, bias, q_scale, k_scale, head_scales, out,
                                     B, N, H, scale, stream)
                : launch<false, true>(tq, tk, v, sv, bias, q_scale, k_scale, head_scales, out,
                                      B, N, H, scale, stream);
}

cudaError_t flash_blocks_per_sm(bool biased, bool i8qk, int* n) {
  return i8qk ? blocks_per_sm<true>(biased, n) : blocks_per_sm<false>(biased, n);
}

int out_res_cluster_size(int H) { return H >= 1 && H <= OUT_RES_MAX_HEADS ? H : 0; }

cudaError_t launch_flash_out_res(const void* q, const void* k, const void* v, const void* wq,
                                 const float* ws, const float* bias, const float* ls,
                                 const void* res, void* out, void* ctx8, float* sc, int B, int N,
                                 int H, float scale, cudaStream_t stream) {
  if (!shape_ok(B, N, H) || out_res_cluster_size(H) == 0 || !(scale > 0.0f) || ctx8 == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = out_res_once();
  if (err != cudaSuccess) return err;
  const HeadStrides s{(long long)N * H * 64, (long long)H * 64, 64};
  const int HD = H * 64;
  CUtensorMap tq, tk, tv, to, tw, tc;
  const cuuint64_t wdims[2] = {(cuuint64_t)HD, (cuuint64_t)HD};
  const cuuint64_t wstride[1] = {(cuuint64_t)HD};
  const cuuint32_t wbox[2] = {64, 64};
  if (!head_map(&tq, q, s, B, N, H, QT) || !head_map(&tk, k, s, B, N, H, KT) ||
      !head_map(&tv, v, s, B, N, H, KT) || !head_map(&to, out, s, B, N, H, QT) ||
      !head_map_i8(&tc, ctx8, B, N, H) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wq, wdims, wstride, wbox,
                  CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  const OutRes ox{ws, bias, ls, static_cast<const bf16*>(res), sc, H};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = out_res_config(B, N, H, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, flash_wgmma_kernel<false, false, true>, tq, tk, tv, to, tw, tc,
                           (const float*)nullptr, (const float*)nullptr, (const float*)nullptr,
                           0, N, scale * LOG2E, ox);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t out_res_active_clusters(int H, int* n) {
  if (out_res_cluster_size(H) == 0) return cudaErrorInvalidValue;
  cudaError_t err = out_res_once();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = out_res_config(1, QT, H, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, flash_wgmma_kernel<false, false, true>, &cfg);
}

}  // namespace caim
