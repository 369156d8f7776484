"""Device ms per batch of the 19-channel stack: the traced time of every
kernel that is not ``lut_hist``'s or ``forest_labels``', over the batches
traced (one ``lut_hist`` launch each)."""

from perfbench.harness.roofline import kernel_time_per_unit_ms


def read(rec):
    return kernel_time_per_unit_ms(rec, ("lut_hist", "forest_labels"),
                                   "lut_hist")
