"""K1 (K7, K8, K10, K10b and their quantisers where a route takes them):
the least time of the forward's attention over its kernels' device time."""

from benchmark.roofline.share import roofline_pct

# the functions that kernels/flash_attention.py launches
KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel", "flash_bnhd_f32_kernel",
           "quant_rows_pair_kernel", "quant_heads_pair_kernel")


def read(rec):
    return roofline_pct(rec, "flash_attention", KERNELS)
