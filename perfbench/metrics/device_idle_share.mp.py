"""The device's idle share of the traced span, in %: 1 - (union of kernel,
copy and fill intervals on all streams) / (traced span)."""

from perfbench.harness.roofline import device_idle_share


def read(rec):
    return device_idle_share(rec)
