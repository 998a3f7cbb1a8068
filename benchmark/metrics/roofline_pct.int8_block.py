"""K2, K3, K4 (K4a + K4b) and K5 (K12 in place of K3 and K4 where it runs):
the least time of the forward's int8 projections over their kernels'
device time."""

from benchmark.roofline.share import roofline_pct

# the functions that kernels/int8_block.py launches for the model's blocks
KERNELS = ("quant_rows_kernel", "quant_rows_wide_kernel", "int8_gemm_tma_kernel",
           "fc1_gelu_quant_kernel", "attnout_mlp_kernel")


def read(rec):
    return roofline_pct(rec, "int8_block", KERNELS)
