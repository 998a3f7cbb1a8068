// What the mma.sync attention kernels (flash_attention_int8dots.cu: K9;
// flash_attention_out_res.cu: K11) share after their first product (K1, K7,
// K8, K10 and K10b run their own program, flash_wgmma.cu, with the same
// arithmetic on wgmma): the
// online softmax over one 64-key tile, the bf16 P V product, and the final
// normalised store. A warp owns 16 query rows; thread (g, c) of it holds rows
// g and g + 8 of the warp's block in the m16n8 accumulator layout
// (tile_common.cuh): s[nt][0..1] are row g, keys 8 nt + 2c, + 1 of the tile,
// s[nt][2..3] the same keys of row g + 8; o[dt][..] likewise over the 64
// output columns.
#pragma once

#include "tile_common.cuh"

namespace caim {

// One key tile of the online softmax and O += P V. s holds the tile's scores
// in base 2 (already scaled; -inf on keys past N; at least one key of the
// first tile is finite). m, l: running row maximum and sum; o: the f32
// accumulator; Vt: the tile's V rows in shared memory, row stride LDV. P is
// rounded to bf16 un-normalised; the f32 sum l normalises at the end. LDV: the
// row stride of Vt in elements (K11 stages two heads side by side).
template <int LDV = LDT>
__device__ __forceinline__ void flash_softmax_pv(const float (&s)[8][4], float (&o)[8][4],
                                                 float& m0, float& m1, float& l0, float& l1,
                                                 const bf16* __restrict__ Vt, int lane) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the 4 lanes of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a key is valid
  const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);   // 0 on the first tile
  m0 = mn0;
  m1 = mn1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    o[dt][0] *= a0;
    o[dt][1] *= a0;
    o[dt][2] *= a1;
    o[dt][3] *= a1;
  }

  uint32_t pf[4][4];  // P as A fragments: tiles 2kk and 2kk+1 form k-step kk
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float p0 = exp2f(s[nt][0] - mn0), p1 = exp2f(s[nt][1] - mn0);
    const float p2 = exp2f(s[nt][2] - mn1), p3 = exp2f(s[nt][3] - mn1);
    l0 += p0 + p1;  // the f32 sum normalises, as in the TPU kernel
    l1 += p2 + p3;
    pf[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
    pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
  }

  // O += P V: B fragments of two 8-column tiles per ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* vr = &Vt[(16 * kk + (lane & 15)) * LDV + 8 * (lane >> 4)];
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vr + 16 * dp);
      mma_16816(o[2 * dp], pf[kk], bv[0], bv[1]);
      mma_16816(o[2 * dp + 1], pf[kk], bv[2], bv[3]);
    }
  }
}

// O / l of this thread's rows row0 and row0 + 8 (those below N), as bf16, to
// the 64 columns at out (the head's first column of row 0; row stride HD).
__device__ __forceinline__ void flash_store(bf16* __restrict__ out, int HD, int row0, int N,
                                            int c, const float (&o)[8][4], float l0,
                                            float l1) {
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = 8 * dt + 2 * c;
    if (row0 < N)
      *reinterpret_cast<uint32_t*>(&out[(size_t)row0 * HD + col]) =
          pack_bf16(o[dt][0] / l0, o[dt][1] / l0);
    if (row1 < N)
      *reinterpret_cast<uint32_t*>(&out[(size_t)row1 * HD + col]) =
          pack_bf16(o[dt][2] / l1, o[dt][3] / l1);
  }
}

}  // namespace caim
