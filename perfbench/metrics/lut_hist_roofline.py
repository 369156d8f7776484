"""``lut_hist``'s share of its roofline in the traced span, in %: the
counted least time of its calls (``counts/lut_hist.py``) over the traced
time of its kernels."""

from perfbench.harness.roofline import kernel_share


def read(rec):
    return kernel_share(rec, "lut_hist")
