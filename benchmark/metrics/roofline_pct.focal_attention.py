"""K6: the least time of the focal iterations' attention over its kernels'
device time."""

from benchmark.roofline.share import roofline_pct

# the functions that kernels/focal_attention.py launches
KERNELS = ("focal_wgmma_kernel", "focal_colmean_kernel", "focal_f32_scores_kernel",
           "focal_f32_attend_kernel")


def read(rec):
    return roofline_pct(rec, "focal_attention", KERNELS)
