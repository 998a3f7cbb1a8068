// K6: fused single-head focal attention, written for Hopper.
//
// Replaces: cognitive_aim_tpu/kernels/focal_attention.py,
//   focal_attention_fused -> _focal_fused_fwd (body _focal_kernel).
// For q, k, v [B, N, D] and P = softmax(Q K^T / scale) (f32), it emits
//   attended = P V (q's type; P rounded to V's type first),
//   colmean = mean over rows of P, diag = diag(P), rowmax = max over a row of P,
// the last three in f32 over the unrounded P. P never reaches device memory.
//
// What bounds it on this card: the contraction is the full D (768 on the
// slice) with a single head; at B 8, N 1369 the function is 46 GFLOP of
// bf16 products (0.047 ms at 989 TFLOP/s) against 67 MB of q, k, v and
// attended (0.020 ms): operation-bound. The kernels here do 92 GFLOP (Q K^T in
// the stats pass and once per column chunk in the attend pass) and stream K
// into shared memory once per 64 query rows and pass: 1.1 GB at D 768, which
// an H100 moves into its SMs at ~5 TB/s (multicasting K to two CTAs, which
// halves what L2 reads, measured no faster). What the design does:
//   * Two passes, as before: the exact row softmax needs m and l before P
//     may be normalised and rounded (JAX rounds the normalised P), so a stats
//     pass finds them and the attend pass computes P once they are known (no
//     online rescaling). rowmax(P) = 1/l and diag(P) = exp(s_ii - m) / l come
//     from the row statistics alone.
//   * bf16, both passes: a block owns 64 query rows (one wgmma M) of one
//     batch; a producer warp and two consumer warpgroups (288 threads, one
//     block an SM). The producer loads by TMA (4-D maps over [B, N, D/64, 64]:
//     64 x 64 boxes, 128-byte swizzle, rows past N read as zeros): the Q tile
//     once (resident, 64 x D, 96 KB at D 768), then 8 KB boxes of K (and V)
//     into one ring per warpgroup (3-8 slots each, full and empty mbarriers):
//     with one ring for both, a warpgroup a ring's length ahead of the other
//     could wait on a slot whose previous box has not landed, and a parity
//     wait cannot tell that phase from the one it wants.
//   * S = Q K^T: the two warpgroups take the two 64-key halves of a 128-key
//     step; each runs wgmma m64n64k16 with both operands from shared memory
//     over all of D (4 k-steps a box), one group in flight. S stays in one
//     warpgroup's registers (32 f32 a thread): no partial sums through
//     shared memory.
//   * Stats: an online maximum and sum per row in base 2 (scores times log2 e
//     / scale), the diagonal score kept where a tile holds it, the warpgroups'
//     statistics merged at the end. The keys are split over KEY_SPLITS blocks
//     a q tile (528 blocks at B 8, N 1369: four waves on 132 SMs, where one
//     block a q tile made 1.33), each leaving its m, l and s_ii; the attend
//     pass merges them.
//   * Attend: P = exp2(s - m) / l in f32, rounded to bf16 into shared memory
//     (K-major, swizzled: the A operand of P V; two buffers, so that a
//     warpgroup may start the next step while its peer still reads P); the
//     colsum partials per (batch, q tile) from the f32 P, padded query rows
//     kept out by a select (a multiply by 0 would let a NaN through), summed
//     over each warp's rows by shuffles and over the 4 warps in a fixed order.
//     Then O += P V by wgmma, V's boxes read MN-major (the transpose bit),
//     each warpgroup owning half the block's columns of O: the f32 O of 64 x
//     768 would take 75% of the register file, so D 768 and 1024 are split
//     into two column chunks, a block each (Q K^T computed once per chunk):
//     96 or 128 f32 of O a thread.
//   * The epilogue writes O as bf16 into the Q tile's boxes (free by then)
//     and stores them by TMA, which drops rows past N.
//   * The TPU kernel accumulated colsum across sequential grid steps. Here
//     blocks run concurrently, so a third kernel sums the partials of the q
//     tiles in a fixed order: deterministic, no atomics.
//   * The scale divides (streams.py uses sqrt(D/8) as a divisor): the kernel
//     multiplies by inv_scale = 1/scale, as the TPU kernel does.
//   * f32 (strict policy): exact f32 FMAs on register tiles (tile_common.cuh,
//     RegTile), operands double-buffered by cp.async, TF32 off as the policy
//     demands; bound by the FMA pipes (4 B N^2 D operations at 67 TFLOP/s).
//     An attend block can hold only some columns of O in registers (the f32
//     O of a row tile over all of D would not fit), and an earlier design
//     recomputed the 768-deep scores for every column chunk: 1 + D / 128
//     products where the function needs two. Here the scores pass computes
//     each score once, over all of D, and writes it (in base 2, times
//     log2 e / scale) to a scratch of B N N floats, 60 MB at B 8, N 1369,
//     with each key block's row maximum and sum; the attend pass merges
//     those into m and l, reads the scores back a row tile at a time (the
//     column blocks of one row tile run side by side, so the rows come from
//     L2), forms P = exp2(t - m) / l in shared memory and runs O += P V. A
//     distributed-shared-memory reduction of partial scores over a cluster
//     was the alternative; on this card a bulk copy moves ~16-22 GB/s out of
//     an SM that way, remote stores about half that (K12's development
//     builds), where the scratch crosses L2 at TB/s.
//     Blocks: 128 query rows x 128 keys (scores) and 128 rows x 128 columns
//     (attend), 8 x 8 values a thread, one block an SM at ~210-250 registers
//     a thread; where 128 x 128 scores blocks would leave SMs idle (B 2, N
//     256: 8 blocks) or D is no multiple of 128, 64 x 64 blocks of 4 x 8 a
//     thread. Each score and each product of P V is the same chain
//     of FMAs in the same order on either shape.
// Kernels: stats or scores (m, l and s_ii per key split; f32: the scores and
// m, l per key tile), attend (attended, colsum partials, diag, rowmax),
// colmean (fixed-order sum of the partials).
#include "tile_common.cuh"

namespace caim {

constexpr int COLMEAN_THREADS = 256;

// ------------------------------------------------------------------ bf16 ----
constexpr int FQ = 64;                    // query rows of a block
constexpr int FK = 64;                    // keys of a warpgroup's tile
constexpr int BOX = 64 * 64 * 2;          // a 64 x 64 bf16 box
constexpr int FOCAL_THREADS = 256 + 32;   // two consumer warpgroups, a producer warp
constexpr int MAX_SLOTS = 16;
constexpr int KEY_SPLITS = 3;  // blocks of the stats pass per q tile, each a third of the keys

template <int D>
struct FocalTile {
  static constexpr int DB = D / 64;                  // boxes along D
  static constexpr int CHUNKS = (D + 511) / 512;     // column chunks of attended
  static constexpr int CB = DB / CHUNKS;             // boxes of a chunk
  static constexpr int OB = (CB + 1) / 2;            // of them, a warpgroup's at most
  static constexpr int P_OFF = DB * BOX;             // after Q: P [2 buffers][2 halves]
  static constexpr int RING_OFF = P_OFF + 4 * BOX;
  static constexpr int RED_BYTES = 2 * 2 * 4 * 64 * 4;  // colsum partials [2][2][4][64] f32
  static constexpr int FIXED = RED_BYTES + (1 + 2 * MAX_SLOTS) * 8 + 1024;
  static constexpr int FREE = (int)((MAX_SMEM - RING_OFF - FIXED) / BOX);
  static constexpr int SLOTS = FREE < MAX_SLOTS ? FREE : MAX_SLOTS;
  static constexpr int RS = SLOTS / 2;               // slots of a warpgroup's ring
  static constexpr int RED_OFF = RING_OFF + SLOTS * BOX;
  static constexpr int BAR_OFF = RED_OFF + RED_BYTES;
  static constexpr size_t SMEM = (size_t)BAR_OFF + (1 + 2 * SLOTS) * 8 + 1024;
  static_assert(DB % CHUNKS == 0 && RS >= 2 && SMEM <= MAX_SMEM, "tiles fit");
};

// The first of the CB boxes of a chunk that warpgroup w owns (w = 2: the end)
template <int CB>
__device__ __forceinline__ int o_box(int w) {
  return w * CB / 2;
}

// Box n of a warpgroup's ring: its slot and the parity of the phase that
// fills it. Each warpgroup has a ring of its own: with one ring for both, a
// warpgroup a ring's length ahead of the other's boxes could wait on a slot
// whose previous box has not landed, and a parity wait cannot tell that phase
// from the one it wants.
struct Slot {
  int i;
  uint32_t parity;
};
template <int RS>
__device__ __forceinline__ Slot slot_of(int n) {
  return {n % RS, (uint32_t)((n / RS) & 1)};
}

// S = Q K^T of one warpgroup's 64 keys over all of D: box j of K is box
// n + j of the warpgroup's ring, one wgmma group of 4 k-steps a box, one
// group in flight; each slot is released once its group is done.
template <int DB, int RS>
__device__ __forceinline__ void focal_scores(float (&s)[32], const unsigned char* qs,
                                             const unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, int n) {
  int prev = -1;
  for (int j = 0; j < DB; ++j) {
    const Slot sl = slot_of<RS>(n + j);
    mbar_wait(&full[sl.i], sl.parity);
    const uint64_t dq = wgmma_desc_sw128(qs + j * BOX);
    const uint64_t dk = wgmma_desc_sw128(ring + sl.i * BOX);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_64x64_ss<false>(s, dq + 2 * kk, dk + 2 * kk, (j | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(s);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = sl.i;
  }
  wgmma_wait<0>();
  fence_operands(s);
  mbar_arrive(&empty[prev]);
}

// ATTEND = false: row statistics m, l (base 2) and the diagonal score of the
// key steps of split blockIdx.y into part [KEY_SPLITS][m, l, s_ii][B, N].
// ATTEND = true: merges the splits' statistics; attended for column chunk
// blockIdx.y and, in chunk 0, the colsum partials and the views diag, rowmax.
template <int D, bool ATTEND>
__global__ void __launch_bounds__(FOCAL_THREADS, 1)
focal_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   float* __restrict__ part, float* __restrict__ diag,
                   float* __restrict__ rowmax, float* __restrict__ partial, int N,
                   float scale_log2) {
  using T = FocalTile<D>;
  constexpr int DB = T::DB, CB = T::CB, OB = T::OB, SLOTS = T::SLOTS, RS = T::RS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ring = smem + T::RING_OFF;
  float* red = reinterpret_cast<float*>(smem + T::RED_OFF);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;
  const int qt = blockIdx.x, q0 = qt * FQ, chunk = ATTEND ? blockIdx.y : 0, b = blockIdx.z;
  const int nqt = gridDim.x;
  const int nkt = (N + FK - 1) / FK, nsteps = (nkt + 1) / 2;
  // the key steps of this block: a split's in the stats pass, all of them in the attend pass
  const int i0 = ATTEND ? 0 : blockIdx.y * nsteps / KEY_SPLITS;
  const int i1 = ATTEND ? nsteps : (blockIdx.y + 1) * nsteps / KEY_SPLITS;
  const size_t BN = (size_t)gridDim.z * N;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < SLOTS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);  // the owning warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // ---- producer: one thread issues every load
    if (tid != 256) return;
    mbar_arrive_expect_tx(q_full, DB * BOX);
    for (int j = 0; j < DB; ++j) tma_load_4d(qs + j * BOX, &tq, q_full, 0, j, q0, b);
    int n[2] = {0, 0};  // boxes loaded into each warpgroup's ring
    auto load = [&](int w, const CUtensorMap* map, int key_tile, int box) {
      const Slot sl = slot_of<RS>(n[w]++);
      const int i = w * RS + sl.i;
      mbar_wait(&empty[i], sl.parity ^ 1);
      mbar_arrive_expect_tx(&full[i], BOX);
      tma_load_4d(ring + i * BOX, map, &full[i], 0, box, key_tile * FK, b);
    };
    for (int i = i0; i < i1; ++i) {
      const int hv = min(2, nkt - 2 * i);  // key tiles of this step, one a warpgroup
      for (int j = 0; j < DB; ++j)
        for (int h = 0; h < hv; ++h) load(h, &tk, 2 * i + h, j);
      if constexpr (ATTEND) {
        for (int h = 0; h < hv; ++h)
          for (int cb = 0; cb < CB; ++cb)
            load(cb < o_box<CB>(1) ? 0 : 1, &tv, 2 * i + h, chunk * CB + cb);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w takes key tile 2i + w of step i
  const int w = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8 (both g modulo 8)
  float s[32];
  unsigned char* my_ring = ring + w * RS * BOX;  // this warpgroup's ring and its barriers
  uint64_t* my_full = full + w * RS;
  uint64_t* my_empty = empty + w * RS;
  int n = 0;  // boxes taken from it
  mbar_wait(q_full, 0);

  if constexpr (!ATTEND) {
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, sd[2] = {-INFINITY, -INFINITY};
    for (int i = i0; i < i1; ++i) {
      const int hv = min(2, nkt - 2 * i);
      if (w < hv) {
        const int k0 = (2 * i + w) * FK;
        focal_scores<DB, RS>(s, qs, my_ring, my_full, my_empty, n);
        n += DB;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1, key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
          s[e] = key < N ? s[e] * scale_log2 : -INFINITY;
          if (key == q0 + r0 + 8 * h) sd[h] = s[e];  // the diagonal score
          mx[h] = fmaxf(mx[h], s[e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
        float sum[2] = {0.0f, 0.0f};
        const float mn[2] = {fmaxf(m[0], mx[0]), fmaxf(m[1], mx[1])};  // finite
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[(e >> 1) & 1] += exp2f(s[e] - mn[(e >> 1) & 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
          l[h] = l[h] * exp2f(m[h] - mn[h]) + sum[h];
          m[h] = mn[h];
        }
      }
    }
    // merge the two warpgroups' statistics: red [2 warpgroups][m, l, sd][64]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sd[h] = fmaxf(sd[h], __shfl_xor_sync(0xffffffffu, sd[h], 1));
      sd[h] = fmaxf(sd[h], __shfl_xor_sync(0xffffffffu, sd[h], 2));
      if (c == 0) {
        red[(w * 3 + 0) * 64 + r0 + 8 * h] = m[h];
        red[(w * 3 + 1) * 64 + r0 + 8 * h] = l[h];
        red[(w * 3 + 2) * 64 + r0 + 8 * h] = sd[h];
      }
    }
    named_barrier_sync(1, 256);
    if (tid < FQ && q0 + tid < N) {
      // a warpgroup or a split without keys leaves m = -inf, l = 0, s_ii = -inf
      const float ma = red[tid], la = red[64 + tid], mb = red[192 + tid], lb = red[256 + tid];
      const float mm = fmaxf(ma, mb);
      const float ll = mm == -INFINITY ? 0.0f : la * exp2f(ma - mm) + lb * exp2f(mb - mm);
      const size_t row = (size_t)b * N + q0 + tid;
      float* ps = part + (size_t)blockIdx.y * 3 * BN + row;
      ps[0] = mm;
      ps[BN] = ll;
      ps[2 * BN] = fmaxf(red[128 + tid], red[320 + tid]);
    }
  } else {
    // the splits' statistics merged: m, l of the whole row, and in chunk 0
    // the views rowmax = 1 / l (the largest entry is exp(0) / l) and
    // diag = exp2(s_ii - m) / l
    float mrow[2], inv_l[2];
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + r0 + 8 * h;
      valid[h] = q < N;
      mrow[h] = 0.0f;
      inv_l[h] = 1.0f;
      if (valid[h]) {
        const float* ps = part + (size_t)b * N + q;
        float mm = -INFINITY, sdd = -INFINITY, ll = 0.0f;
        for (int k = 0; k < KEY_SPLITS; ++k) mm = fmaxf(mm, ps[3 * k * BN]);
        for (int k = 0; k < KEY_SPLITS; ++k) {
          const float mk = ps[3 * k * BN];
          if (mk != -INFINITY) ll += ps[(3 * k + 1) * BN] * exp2f(mk - mm);
          sdd = fmaxf(sdd, ps[(3 * k + 2) * BN]);
        }
        mrow[h] = mm;
        inv_l[h] = 1.0f / ll;
        if (chunk == 0 && w == 0 && c == 0) {
          rowmax[(size_t)b * N + q] = inv_l[h];
          diag[(size_t)b * N + q] = exp2f(sdd - mm) / ll;
        }
      }
    }
    float o[OB][32];
#pragma unroll
    for (int ob = 0; ob < OB; ++ob)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[ob][e] = 0.0f;
    const int cb_lo = o_box<CB>(w), cb_n = o_box<CB>(w + 1) - cb_lo;
    unsigned char* pbuf = smem + T::P_OFF;
    for (int i = 0; i < nsteps; ++i) {
      const int hv = min(2, nkt - 2 * i);
      unsigned char* pb = pbuf + (i & 1) * 2 * BOX;  // this step's P buffer, two halves
      if (w < hv) {
        const int k0 = (2 * i + w) * FK;
        focal_scores<DB, RS>(s, qs, my_ring, my_full, my_empty, n);
        n += DB;
        // exact P in f32: bf16 into P (K-major, swizzled), column sums
        unsigned char* pw = pb + w * BOX;
        float cs[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * c + e;
            float p[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              p[h] = key < N ? exp2f(s[4 * j + 2 * h + e] * scale_log2 - mrow[h]) * inv_l[h]
                             : 0.0f;
            s[4 * j + e] = p[0];
            s[4 * j + 2 + e] = p[1];
            cs[2 * j + e] = (valid[0] ? p[0] : 0.0f) + (valid[1] ? p[1] : 0.0f);
          }
          const int col = ((j ^ g) << 4) + 4 * c;
          *reinterpret_cast<uint32_t*>(pw + r0 * 128 + col) = pack_bf16(s[4 * j], s[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(pw + (r0 + 8) * 128 + col) =
              pack_bf16(s[4 * j + 2], s[4 * j + 3]);
        }
        if (chunk == 0) {  // colsum partial of this q tile, in a fixed order
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            cs[t] += __shfl_xor_sync(0xffffffffu, cs[t], 4);
            cs[t] += __shfl_xor_sync(0xffffffffu, cs[t], 8);
            cs[t] += __shfl_xor_sync(0xffffffffu, cs[t], 16);
          }
          float* rw = red + ((w * 2 + (i & 1)) * 4) * 64;  // [4 warps][64 keys]
          if (g == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              rw[warp * 64 + 8 * j + 2 * c] = cs[2 * j];
              rw[warp * 64 + 8 * j + 2 * c + 1] = cs[2 * j + 1];
            }
          }
          named_barrier_sync(2 + w, 128);
          if (wt < FK && k0 + wt < N)
            partial[((size_t)b * nqt + qt) * N + k0 + wt] =
                ((rw[wt] + rw[64 + wt]) + rw[128 + wt]) + rw[192 + wt];
        }
      }
      fence_proxy_async();  // P, written here, is read by wgmma
      named_barrier_sync(1, 256);
      // O += P V over this step's keys, V box (h, cb_lo + ob) the ring's box
      // n + h cb_n + ob: a group a box, one group in flight, each slot
      // released once its group is done
      int prev = -1;
      for (int h = 0; h < hv; ++h) {
        const uint64_t dp = wgmma_desc_sw128(pb + h * BOX);
#pragma unroll
        for (int ob = 0; ob < OB; ++ob) {
          if (ob < cb_n) {
            const Slot sl = slot_of<RS>(n + h * cb_n + ob);
            mbar_wait(&my_full[sl.i], sl.parity);
            const uint64_t dv = wgmma_desc_sw128(my_ring + sl.i * BOX);
            fence_operands(o[ob]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_bf16_64x64_ss<true>(o[ob], dp + 2 * kk, dv + 128 * kk, 1);
            wgmma_commit();
            wgmma_wait<1>();
            if (prev >= 0) mbar_arrive(&my_empty[prev]);
            prev = sl.i;
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int ob = 0; ob < OB; ++ob) fence_operands(o[ob]);
      if (prev >= 0) mbar_arrive(&my_empty[prev]);
      n += cb_n * hv;
    }
    // O as bf16 into the Q tile's boxes (every S product is done: both
    // warpgroups passed the last P barrier), then TMA stores of this
    // warpgroup's boxes
#pragma unroll
    for (int ob = 0; ob < OB; ++ob) {
      if (ob < cb_n) {
        unsigned char* ob_s = qs + (cb_lo + ob) * BOX;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ((j ^ g) << 4) + 4 * c;
          *reinterpret_cast<uint32_t*>(ob_s + r0 * 128 + col) =
              pack_bf16(o[ob][4 * j], o[ob][4 * j + 1]);
          *reinterpret_cast<uint32_t*>(ob_s + (r0 + 8) * 128 + col) =
              pack_bf16(o[ob][4 * j + 2], o[ob][4 * j + 3]);
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(2 + w, 128);
    if (wt == 0) {
      for (int ob = 0; ob < cb_n; ++ob)
        tma_store_4d(&to, qs + (cb_lo + ob) * BOX, 0, chunk * CB + cb_lo + ob, q0, b);
      tma_store_wait();
    }
  }
}

// ------------------------------------------------------------------- f32 ----
constexpr int F32_BK = 32;           // a step of the contraction: 32 of D, or 32 keys
constexpr int F32_LDK = F32_BK + 4;  // padded row of a tile that holds one step
constexpr int F32_STAGES = 3;        // the scores pass's cp.async ring
// the side of the smaller blocks: D is a multiple of it, and the scratch of
// row statistics and colsum partials is sized for it (the larger blocks use
// the first half of it)
constexpr int F32_SMALL = 64;

// The blocks of both passes: BM query rows (128 or 64) and as many keys
// (scores) or columns of attended (attend), BM / 16 rows and 8 keys or
// columns a thread, 2 BM threads; a scores block's keys are one partial of
// the row statistics
template <int BM>
struct F32Tile {
  static constexpr int TM = BM / 16;
  using T = RegTile<BM, BM, TM, 8>;
  static constexpr int THREADS = T::THREADS;
  static constexpr int STAGE = 2 * BM * F32_LDK;  // Q rows, then K rows of a scores step
  static constexpr int PT = BM * F32_LDK, VT = F32_BK * BM;  // an attend step's P and V
  static constexpr size_t SCORES_SMEM = F32_STAGES * STAGE * sizeof(float);
  static constexpr size_t ATTEND_SMEM =
      (2 * PT + 2 * VT + 2 * BM + 4 * 32) * sizeof(float);  // P[2], V[2], m, 1/l, colsum
};

// The row stride of the scores scratch: N rounded up to whole float4s
inline int f32_score_stride(int N) { return (N + 3) / 4 * 4; }

// Scores pass: t = (Q K^T) log2(e) / scale over all of D for the block's BM
// rows and BM keys (steps of 32 of D through a cp.async ring), written to
// scores [B][N][NP]; and each row's maximum m and sum l of exp2(t - m) over
// the block's keys < N, to mpart, lpart [B][key blocks][N].
template <int BM>
__global__ void __launch_bounds__(F32Tile<BM>::THREADS)
focal_f32_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        float* __restrict__ scores, float* __restrict__ mpart,
                        float* __restrict__ lpart, int N, int NP, int D, float sl2) {
  using C = F32Tile<BM>;
  using T = typename C::T;
  constexpr int TM = C::TM, TH = C::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int kt = blockIdx.x, k0 = kt * BM, q0 = blockIdx.y * BM, b = blockIdx.z;
  const float* qb = q + ((size_t)b * N + q0) * D;
  const float* kb = k + ((size_t)b * N + k0) * D;
  const int nd = D / F32_BK;
  auto load = [&](int s) {  // step s of D into slot s % F32_STAGES
    float* st = ring + (s % F32_STAGES) * C::STAGE;
    load_rows_async<BM, F32_BK, F32_LDK, TH>(st, qb + s * F32_BK, D, N - q0);
    load_rows_async<BM, F32_BK, F32_LDK, TH>(st + BM * F32_LDK, kb + s * F32_BK, D, N - k0);
  };
#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < nd) load(s);
    cp_async_commit();
  }
  const int tx = T::tx(), r0 = T::row0();
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < nd; ++s) {
    cp_async_wait<F32_STAGES - 2>();  // step s landed for this thread
    __syncthreads();                  // ... for all, and step s - 1's slot is free
    if (s + F32_STAGES - 1 < nd) load(s + F32_STAGES - 1);
    cp_async_commit();  // (empty near the end, so that one wait fits all)
    const float* st = ring + (s % F32_STAGES) * C::STAGE;
    mma_nt<TM, 8, F32_BK, F32_LDK, F32_LDK, T::Y, T::TX>(acc, st + r0 * F32_LDK,
                                                         st + (BM + tx) * F32_LDK);
  }
  const int nkt = gridDim.x;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + r0 + T::Y * i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + tx + T::TX * j;
      acc[i][j] = key < N ? acc[i][j] * sl2 : -INFINITY;
      mx = fmaxf(mx, acc[i][j]);
      if (row < N && key < N) scores[((size_t)b * N + row) * NP + key] = acc[i][j];
    }
    // the row's BM keys are in the TX lanes that share lane / TX; the
    // maximum is finite, as the block holds a key < N
#pragma unroll
    for (int o = 1; o < T::TX; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += exp2_ftz(acc[i][j] - mx);
#pragma unroll
    for (int o = 1; o < T::TX; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (tx == 0 && row < N) {
      const size_t at = ((size_t)b * nkt + kt) * N + row;
      mpart[at] = mx;
      lpart[at] = sum;
    }
  }
}

// Attend pass: columns [c0, c0 + BM) of attended for the block's BM rows, O
// = P V with P = exp2(t - m) / l over keys in steps of 32: a step's scores
// are fetched into registers one step ahead and written as P into shared
// memory, V's rows double-buffered by cp.async; m and l merged from the nkt
// key blocks' partials. The blocks of column 0 also write the colsum
// partial of their q tile (four warps each sum a quarter of the rows in
// order, the quarters are added in order) and the views rowmax = 1 / l (the
// largest entry is exp2(0) / l) and diag = exp2(t_ii - m) / l. partial:
// [B][qrows][N].
template <int BM>
__global__ void __launch_bounds__(F32Tile<BM>::THREADS)
focal_f32_attend_kernel(const float* __restrict__ scores, const float* __restrict__ mpart,
                        const float* __restrict__ lpart, const float* __restrict__ v,
                        float* __restrict__ att, float* __restrict__ diag,
                        float* __restrict__ rowmax, float* __restrict__ partial, int N, int NP,
                        int D, int nkt, int qrows) {
  using C = F32Tile<BM>;
  using T = typename C::T;
  constexpr int TM = C::TM, TH = C::THREADS, CH = BM * (F32_BK / 4) / TH;  // float4s a step
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // two slots
  float* Vs = Ps + 2 * C::PT;                  // two slots
  float* row_m = Vs + 2 * C::VT;
  float* row_il = row_m + BM;
  float* red = row_il + BM;  // a step's column sums of each quarter of the rows [4][32]
  const int c0 = blockIdx.x * BM, qt = blockIdx.y, q0 = qt * BM, b = blockIdx.z;
  const bool views = blockIdx.x == 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int r = tid; r < BM; r += TH) {
    const int row = q0 + r;
    float mm = 0.0f, il = 1.0f;  // rows past N: unused
    if (row < N) {
      const float* mp = mpart + (size_t)b * nkt * N + row;
      const float* lp = lpart + (size_t)b * nkt * N + row;
      mm = -INFINITY;
      for (int t = 0; t < nkt; ++t) mm = fmaxf(mm, mp[(size_t)t * N]);
      float ll = 0.0f;
      for (int t = 0; t < nkt; ++t) ll += lp[(size_t)t * N] * exp2_ftz(mp[(size_t)t * N] - mm);
      il = 1.0f / ll;
      if (views) {
        rowmax[(size_t)b * N + row] = il;
        diag[(size_t)b * N + row] =
            exp2_ftz(scores[((size_t)b * N + row) * NP + row] - mm) * il;
      }
    }
    row_m[r] = mm;
    row_il[r] = il;
  }
  const float* sb = scores + (size_t)b * N * NP;
  const float* vb = v + (size_t)b * N * D + c0;
  float4 f[CH];
  auto fetch = [&](int kc) {  // the scores of keys [32 kc, 32 kc + 32), zeros past N
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = tid + n * TH, r = i / 8, key = kc * F32_BK + (i % 8) * 4;
      f[n] = q0 + r < N && key < N
                 ? *reinterpret_cast<const float4*>(sb + (size_t)(q0 + r) * NP + key)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stage = [&](int kc, float* P) {  // P of those keys, 0 past N (a select keeps NaN out)
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = tid + n * TH, r = i / 8, c = (i % 8) * 4, key = kc * F32_BK + c;
      const bool ok = q0 + r < N;
      const float m = row_m[r], il = row_il[r];
      float4 p;
      p.x = ok && key < N ? exp2_ftz(f[n].x - m) * il : 0.0f;
      p.y = ok && key + 1 < N ? exp2_ftz(f[n].y - m) * il : 0.0f;
      p.z = ok && key + 2 < N ? exp2_ftz(f[n].z - m) * il : 0.0f;
      p.w = ok && key + 3 < N ? exp2_ftz(f[n].w - m) * il : 0.0f;
      *reinterpret_cast<float4*>(P + r * F32_LDK + c) = p;
    }
  };
  auto load_v = [&](int kc) {
    load_rows_async<F32_BK, BM, BM, TH>(Vs + (kc & 1) * C::VT, vb + (size_t)kc * F32_BK * D, D,
                                       N - kc * F32_BK);
  };
  const int nkc = (N + F32_BK - 1) / F32_BK;
  __syncthreads();  // m and 1/l of every row
  fetch(0);
  load_v(0);
  cp_async_commit();
  stage(0, Ps);
  const int tx = T::tx(), r0 = T::row0();
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kc = 0; kc < nkc; ++kc) {
    if (kc + 1 < nkc) {  // their slots' last readers passed the barrier ending kc - 1
      fetch(kc + 1);
      load_v(kc + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step kc's V and P in place
    const float* P = Ps + (kc & 1) * C::PT;
    if (views && warp < 4) {
      float cs = 0.0f;
      for (int r = warp * (BM / 4); r < (warp + 1) * (BM / 4); ++r) cs += P[r * F32_LDK + lane];
      red[warp * 32 + lane] = cs;
    }
    mma_nn<TM, 8, F32_BK, F32_LDK, BM, T::Y, T::TX>(acc, P + r0 * F32_LDK,
                                                    Vs + (kc & 1) * C::VT + 4 * tx);
    __syncthreads();  // step kc's P, V and column sums are complete
    const int key = kc * F32_BK + tid;
    if (views && tid < 32 && key < N)
      partial[((size_t)b * qrows + qt) * N + key] =
          ((red[tid] + red[32 + tid]) + red[64 + tid]) + red[96 + tid];
    if (kc + 1 < nkc) stage(kc + 1, Ps + ((kc + 1) & 1) * C::PT);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + r0 + T::Y * i;
    if (row < N) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        *reinterpret_cast<float4*>(att + ((size_t)b * N + row) * D + c0 + 4 * tx +
                                   4 * T::TX * g) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

// ---------------------------------------------------------------- colmean ----
// partial [B][qrows][N], of which the first n_qtiles rows of a batch hold
// the q tiles' column sums
__global__ void __launch_bounds__(COLMEAN_THREADS)
focal_colmean_kernel(const float* __restrict__ partial, float* __restrict__ colmean, int N,
                     int n_qtiles, int qrows) {
  const int j = blockIdx.x * COLMEAN_THREADS + threadIdx.x, b = blockIdx.y;
  if (j >= N) return;
  float s = 0.0f;
  for (int t = 0; t < n_qtiles; ++t) s += partial[((size_t)b * qrows + t) * N + j];
  colmean[(size_t)b * N + j] = s / (float)N;
}

// the map of one [B, N, D] bf16 operand as [B, N, D / 64, 64]: 64 x 64 boxes
bool focal_map(CUtensorMap* map, const void* base, int B, int N, int D) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)D / 64, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {128, (cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t box[4] = {64, 1, FQ, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

template <int D>
cudaError_t launch_focal_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* att,
                              float* diag, float* rowmax, float* part, float* partial, int B,
                              int N, float inv_scale, cudaStream_t stream) {
  using T = FocalTile<D>;
  static std::atomic<unsigned long long> stats_set{0}, attend_set{0};  // once per process
  cudaError_t err = smem_allowance_once(stats_set, (const void*)focal_wgmma_kernel<D, false>,
                                        T::SMEM);
  if (err == cudaSuccess)
    err = smem_allowance_once(attend_set, (const void*)focal_wgmma_kernel<D, true>, T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if (!focal_map(&tq, q, B, N, D) || !focal_map(&tk, k, B, N, D) ||
      !focal_map(&tv, v, B, N, D) || !focal_map(&to, att, B, N, D))
    return cudaErrorInvalidValue;
  const int nqt = (N + FQ - 1) / FQ;
  const float sl2 = inv_scale * LOG2E;
  focal_wgmma_kernel<D, false><<<dim3(nqt, KEY_SPLITS, B), FOCAL_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, to, part, diag, rowmax, partial, N, sl2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  focal_wgmma_kernel<D, true><<<dim3(nqt, T::CHUNKS, B), FOCAL_THREADS, T::SMEM, stream>>>(
      tq, tk, tv, to, part, diag, rowmax, partial, N, sl2);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_focal_f32(const float* q, const float* k, const float* v, float* att,
                             float* diag, float* rowmax, float* scratch, float* partial, int B,
                             int N, int D, float inv_scale, cudaStream_t stream) {
  using C = F32Tile<BM>;
  static std::atomic<unsigned long long> scores_set{0}, attend_set{0};  // once per process
  cudaError_t err = smem_allowance_once(scores_set, (const void*)focal_f32_scores_kernel<BM>,
                                        C::SCORES_SMEM);
  if (err == cudaSuccess)
    err = smem_allowance_once(attend_set, (const void*)focal_f32_attend_kernel<BM>,
                              C::ATTEND_SMEM);
  if (err != cudaSuccess) return err;
  const int NP = f32_score_stride(N), nkt = (N + BM - 1) / BM;
  const int nqt = (N + BM - 1) / BM, qrows = (N + F32_SMALL - 1) / F32_SMALL;
  float* scores = scratch;
  float* mpart = scores + (size_t)B * N * NP;
  float* lpart = mpart + (size_t)B * nkt * N;
  focal_f32_scores_kernel<BM><<<dim3(nkt, nqt, B), C::THREADS, C::SCORES_SMEM, stream>>>(
      q, k, scores, mpart, lpart, N, NP, D, inv_scale * LOG2E);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the column blocks of a row tile side by side: its scores are read from L2
  focal_f32_attend_kernel<BM><<<dim3(D / BM, nqt, B), C::THREADS, C::ATTEND_SMEM, stream>>>(
      scores, mpart, lpart, v, att, diag, rowmax, partial, N, NP, D, nkt, qrows);
  return cudaGetLastError();
}

// The side of the f32 program's blocks: 128 where D is a multiple of 128
// and 128 x 128 scores blocks give each SM of the device one, else 64
int f32_block_rows(int B, int N, int D) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const long long blocks = (long long)((N + 127) / 128) * ((N + 127) / 128) * B;
  return D % 128 == 0 && blocks >= sms ? 128 : 64;
}

}  // namespace caim

// Widths the bf16 kernel is instantiated for (its register tiles are sized
// at compile time): ViT-B's 768, ViT-L's 1024, and small widths for tests.
#define CAIM_FOCAL_BF16_WIDTHS(X) X(64) X(128) X(256) X(512) X(768) X(1024)

// Query rows per tile of the kernel taking `dtype` at width D, or 0 where
// no kernel takes that dtype and width: the colsum scratch has
// ceil(N / q_tile) rows per batch (the f32 program's larger tiles use the
// first of them).
extern "C" int caim_focal_q_tile(int dtype, int D) {
  if (dtype == caim::kF32) return D > 0 && D % caim::F32_SMALL == 0 ? caim::F32_SMALL : 0;
  if (dtype != caim::kBF16) return 0;
  switch (D) {
#define CAIM_CASE(W) \
  case W: return caim::FQ;
    CAIM_FOCAL_BF16_WIDTHS(CAIM_CASE)
#undef CAIM_CASE
    default: return 0;
  }
}

// Floats of the scratch a call at B, N needs: the bf16 stats pass leaves m,
// l and the diagonal score of each of its key splits ([3 KEY_SPLITS][B][N]);
// the f32 scores pass its scores ([B][N][N rounded up to 4]) and m, l of each
// 64-key tile ([2][B][ceil(N / 64)][N]).
extern "C" long long caim_focal_scratch_floats(int dtype, int B, int N) {
  using namespace caim;
  if (dtype == kF32)
    return (long long)B * N * f32_score_stride(N) +
           2LL * B * ((N + F32_SMALL - 1) / F32_SMALL) * N;
  return 3LL * KEY_SPLITS * B * N;
}

// q, k, v, att: [B, N, D] contiguous, 16-byte aligned, D a width that
// caim_focal_q_tile accepts. colmean, diag, rowmax: [B, N] f32.
// scratch: caim_focal_scratch_floats(dtype, B, N) f32 (row statistics and,
// in f32, the scores). partial: [B, ceil(N / q_tile), N] f32 scratch, q_tile
// from caim_focal_q_tile. dtype: 0 float32, 1 bfloat16.
// Launches three kernels on `stream`, does not synchronize, returns the
// first launch error (cudaGetLastError) or 0.
extern "C" int caim_focal_attention(const void* q, const void* k, const void* v, void* att,
                                    void* colmean, void* diag, void* rowmax, void* scratch,
                                    void* partial, int B, int N, int D, float inv_scale,
                                    int dtype, void* stream) {
  using namespace caim;
  const int q_tile = caim_focal_q_tile(dtype, D);
  if (B <= 0 || N <= 0 || q_tile == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  float* dg = static_cast<float*>(diag);
  float* rm = static_cast<float*>(rowmax);
  float* pp = static_cast<float*>(partial);
  int rows = q_tile;  // query rows of this call's q tiles
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    bf16* ab = static_cast<bf16*>(att);
    switch (D) {
#define CAIM_CASE(W) \
  case W: err = launch_focal_bf16<W>(qb, kb, vb, ab, dg, rm, sc, pp, B, N, inv_scale, s); break;
      CAIM_FOCAL_BF16_WIDTHS(CAIM_CASE)
#undef CAIM_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == kF32) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* af = static_cast<float*>(att);
    rows = f32_block_rows(B, N, D);
    err = rows == 128
              ? launch_focal_f32<128>(qf, kf, vf, af, dg, rm, sc, pp, B, N, D, inv_scale, s)
              : launch_focal_f32<64>(qf, kf, vf, af, dg, rm, sc, pp, B, N, D, inv_scale, s);
  }
  if (err != cudaSuccess) return (int)err;
  focal_colmean_kernel<<<dim3((N + COLMEAN_THREADS - 1) / COLMEAN_THREADS, B),
                         COLMEAN_THREADS, 0, s>>>(pp, static_cast<float*>(colmean), N,
                                                  (N + rows - 1) / rows,
                                                  (N + q_tile - 1) / q_tile);
  return (int)cudaGetLastError();
}
