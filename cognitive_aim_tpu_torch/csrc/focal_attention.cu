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
//   * f32 (strict policy): 64-row tiles, plain f32 FMAs through shared
//     memory, the output split over blocks of DC columns that each recompute
//     the scores; exact, not tuned.
// Kernels: stats (m, l, s_ii per key split), attend (attended, colsum
// partials, diag, rowmax), colmean (fixed-order sum of the partials).
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
constexpr int STATS_THREADS = 128;
constexpr int ATTEND_THREADS = 256;

constexpr size_t f32_stats_smem() {
  return align128(2 * TILE * LDT * sizeof(float)) + align128(TILE * LDF * sizeof(float)) +
         3 * TILE * sizeof(float);
}

size_t f32_attend_smem(int dc) {
  return align128(3 * TILE * LDT * sizeof(float))  // Q, K, P tiles
         + align128((size_t)TILE * (dc + 8) * sizeof(float))  // V chunk
         + align128(TILE * LDF * sizeof(float))  // S / P in f32
         + align128((size_t)TILE * (dc + 4) * sizeof(float))  // O chunk
         + 2 * TILE * sizeof(float);  // m, l
}

// S = Q_tile K_tile^T over the whole D, in 64-wide slices of D.
__device__ __forceinline__ void f32_scores(float* Ss, float* Qs, float* Ks,
                                           const float* qrow0, const float* krow0, int D,
                                           int qvalid, int kvalid) {
  for (int d0 = 0; d0 < D; d0 += TILE) {
    __syncthreads();  // previous users of Qs/Ks/Ss are done
    load_tile(Qs, LDT, qrow0 + d0, D, TILE, TILE, qvalid);
    load_tile(Ks, LDT, krow0 + d0, D, TILE, TILE, kvalid);
    __syncthreads();
    mm_abt(Ss, Qs, Ks, d0 > 0);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(STATS_THREADS)
focal_f32_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       float* __restrict__ diag, float* __restrict__ rowmax, int N, int D,
                       float inv_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * LDT;
  float* Ss = reinterpret_cast<float*>(smem + align128(2 * TILE * LDT * sizeof(float)));
  float* row_m = Ss + align128(TILE * LDF * sizeof(float)) / sizeof(float);
  float* row_l = row_m + TILE;
  float* row_sd = row_l + TILE;  // s_ii, the diagonal score

  const int q0 = blockIdx.x * TILE, b = blockIdx.y;
  const size_t base = (size_t)b * N * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows_per_warp = TILE / (STATS_THREADS / 32);
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.0f;
    row_sd[threadIdx.x] = 0.0f;
  }

  for (int k0 = 0; k0 < N; k0 += TILE) {
    const int kvalid = min(TILE, N - k0);
    f32_scores(Ss, Qs, Ks, q + base + (size_t)q0 * D, k + base + (size_t)k0 * D, D,
               N - q0, kvalid);
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = warp * rows_per_warp + rr;
      const float s0 = lane < kvalid ? Ss[r * LDF + lane] * inv_scale : -INFINITY;
      const float s1 = lane + 32 < kvalid ? Ss[r * LDF + lane + 32] * inv_scale : -INFINITY;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float psum = warp_sum(expf(s0 - m_new) + expf(s1 - m_new));
      const int dc = q0 + r - k0;  // this row's diagonal column in the tile
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + psum;
        row_m[r] = m_new;
      }
      if (dc >= 0 && dc < kvalid && (dc & 31) == lane) row_sd[r] = dc < 32 ? s0 : s1;
    }
  }
  __syncthreads();
  if (threadIdx.x < TILE && q0 + threadIdx.x < N) {
    const int r = threadIdx.x;
    const size_t i = (size_t)b * N + q0 + r;
    const float l = row_l[r];
    m_out[i] = row_m[r];
    l_out[i] = l;
    diag[i] = expf(row_sd[r] - row_m[r]) / l;
    rowmax[i] = 1.0f / l;  // the largest entry of the row is exp(0) / l
  }
}

__global__ void __launch_bounds__(ATTEND_THREADS)
focal_f32_attend_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, float* __restrict__ att,
                        float* __restrict__ partial, int N, int D, int dc, float inv_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * LDT;
  float* Ps = Ks + TILE * LDT;
  unsigned char* p = smem + align128(3 * TILE * LDT * sizeof(float));
  float* Vs = reinterpret_cast<float*>(p);
  p += align128((size_t)TILE * (dc + 8) * sizeof(float));
  float* Ss = reinterpret_cast<float*>(p);
  p += align128(TILE * LDF * sizeof(float));
  float* Os = reinterpret_cast<float*>(p);
  p += align128((size_t)TILE * (dc + 4) * sizeof(float));
  float* row_m = reinterpret_cast<float*>(p);
  float* row_l = row_m + TILE;
  const int ldv = dc + 8, ldo = dc + 4;

  const int qt = blockIdx.x, q0 = qt * TILE, d_off = blockIdx.y * dc, b = blockIdx.z;
  const size_t base = (size_t)b * N * D;
  const int qvalid = min(TILE, N - q0);
  if (threadIdx.x < TILE) {
    const bool ok = threadIdx.x < qvalid;
    row_m[threadIdx.x] = ok ? m_in[(size_t)b * N + q0 + threadIdx.x] : 0.0f;
    row_l[threadIdx.x] = ok ? l_in[(size_t)b * N + q0 + threadIdx.x] : 1.0f;
  }
  for (int i = threadIdx.x; i < TILE * ldo; i += ATTEND_THREADS) Os[i] = 0.0f;

  for (int k0 = 0; k0 < N; k0 += TILE) {
    const int kvalid = min(TILE, N - k0);
    f32_scores(Ss, Qs, Ks, q + base + (size_t)q0 * D, k + base + (size_t)k0 * D, D,
               qvalid, kvalid);
    for (int i = threadIdx.x; i < TILE * TILE; i += ATTEND_THREADS) {
      const int r = i / TILE, c = i % TILE;
      const float pr = c < kvalid ? expf(Ss[r * LDF + c] * inv_scale - row_m[r]) / row_l[r] : 0.0f;
      Ss[r * LDF + c] = pr;
      Ps[r * LDT + c] = pr;
    }
    load_tile(Vs, ldv, v + base + (size_t)k0 * D + d_off, D, TILE, dc, kvalid);
    __syncthreads();
    if (blockIdx.y == 0 && threadIdx.x < kvalid) {
      const int c = threadIdx.x;
      float cs = 0.0f;
      for (int r = 0; r < TILE; ++r) cs += r < qvalid ? Ss[r * LDF + c] : 0.0f;
      partial[((size_t)b * gridDim.x + qt) * N + k0 + c] = cs;
    }
    mm_ab_acc(Os, ldo, Ps, Vs, ldv, dc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * dc; i += ATTEND_THREADS) {
    const int r = i / dc, c = i % dc;
    if (r < qvalid) att[base + (size_t)(q0 + r) * D + d_off + c] = Os[r * ldo + c];
  }
}

// ---------------------------------------------------------------- colmean ----
__global__ void __launch_bounds__(COLMEAN_THREADS)
focal_colmean_kernel(const float* __restrict__ partial, float* __restrict__ colmean, int N,
                     int n_qtiles) {
  const int j = blockIdx.x * COLMEAN_THREADS + threadIdx.x, b = blockIdx.y;
  if (j >= N) return;
  float s = 0.0f;
  for (int t = 0; t < n_qtiles; ++t) s += partial[((size_t)b * n_qtiles + t) * N + j];
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

cudaError_t launch_focal_f32(const float* q, const float* k, const float* v, float* att,
                             float* diag, float* rowmax, float* m, float* l,
                             float* partial, int B, int N, int D, float inv_scale,
                             cudaStream_t stream) {
  const int dc = D % 128 == 0 ? 128 : 64;
  const int nqt = (N + TILE - 1) / TILE;
  constexpr size_t smem1 = f32_stats_smem();
  const size_t smem2 = f32_attend_smem(dc);
  // the allowances, once per process (the attend kernel's at its largest chunk)
  static std::atomic<unsigned long long> stats_set{0}, attend_set{0};
  cudaError_t err = smem_allowance_once(stats_set, (const void*)focal_f32_stats_kernel, smem1);
  if (err == cudaSuccess)
    err = smem_allowance_once(attend_set, (const void*)focal_f32_attend_kernel,
                              f32_attend_smem(128));
  if (err != cudaSuccess) return err;
  focal_f32_stats_kernel<<<dim3(nqt, B), STATS_THREADS, smem1, stream>>>(
      q, k, m, l, diag, rowmax, N, D, inv_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  focal_f32_attend_kernel<<<dim3(nqt, D / dc, B), ATTEND_THREADS, smem2, stream>>>(
      q, k, v, m, l, att, partial, N, D, dc, inv_scale);
  return cudaGetLastError();
}

}  // namespace caim

// Widths the bf16 kernel is instantiated for (its register tiles are sized
// at compile time): ViT-B's 768, ViT-L's 1024, and small widths for tests.
#define CAIM_FOCAL_BF16_WIDTHS(X) X(64) X(128) X(256) X(512) X(768) X(1024)

// Query rows per tile of the kernel taking `dtype` at width D, or 0 where
// no kernel takes that dtype and width: the colsum scratch has
// ceil(N / q_tile) rows per batch.
extern "C" int caim_focal_q_tile(int dtype, int D) {
  if (dtype == caim::kF32) return D > 0 && D % caim::TILE == 0 ? caim::TILE : 0;
  if (dtype != caim::kBF16) return 0;
  switch (D) {
#define CAIM_CASE(W) \
  case W: return caim::FQ;
    CAIM_FOCAL_BF16_WIDTHS(CAIM_CASE)
#undef CAIM_CASE
    default: return 0;
  }
}

// Rows of the ml scratch: the bf16 stats pass leaves m, l and the diagonal
// score of each of its key splits (the f32 kernels use the first two).
extern "C" int caim_focal_stats_rows() { return 3 * caim::KEY_SPLITS; }

// q, k, v, att: [B, N, D] contiguous, 16-byte aligned, D a width that
// caim_focal_q_tile accepts. colmean, diag, rowmax: [B, N] f32.
// ml: [caim_focal_stats_rows(), B, N] f32 scratch (the row statistics).
// partial: [B, ceil(N / q_tile), N] f32
// scratch, q_tile from caim_focal_q_tile. dtype: 0 float32, 1 bfloat16.
// Launches three kernels on `stream`, does not synchronize, returns the
// first launch error (cudaGetLastError) or 0.
extern "C" int caim_focal_attention(const void* q, const void* k, const void* v, void* att,
                                    void* colmean, void* diag, void* rowmax, void* ml,
                                    void* partial, int B, int N, int D, float inv_scale,
                                    int dtype, void* stream) {
  using namespace caim;
  const int q_tile = caim_focal_q_tile(dtype, D);
  if (B <= 0 || N <= 0 || q_tile == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(ml);
  float* l = m + (size_t)B * N;
  float* dg = static_cast<float*>(diag);
  float* rm = static_cast<float*>(rowmax);
  float* pp = static_cast<float*>(partial);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kBF16) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    bf16* ab = static_cast<bf16*>(att);
    switch (D) {
#define CAIM_CASE(W) \
  case W: err = launch_focal_bf16<W>(qb, kb, vb, ab, dg, rm, m, pp, B, N, inv_scale, s); break;
      CAIM_FOCAL_BF16_WIDTHS(CAIM_CASE)
#undef CAIM_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == kF32) {
    err = launch_focal_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(att), dg, rm,
                           m, l, pp, B, N, D, inv_scale, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int nqt = (N + q_tile - 1) / q_tile;
  focal_colmean_kernel<<<dim3((N + COLMEAN_THREADS - 1) / COLMEAN_THREADS, B),
                         COLMEAN_THREADS, 0, s>>>(pp, static_cast<float*>(colmean), N, nqt);
  return (int)cudaGetLastError();
}
