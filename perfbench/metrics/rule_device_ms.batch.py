"""Device ms per batch of the rule program after its preamble (front,
thresholds, morphology, min-area removal): the traced time of every kernel
that is not ``lut_hist``'s, over the batches traced."""

from perfbench.harness.roofline import kernel_time_per_unit_ms


def read(rec):
    return kernel_time_per_unit_ms(rec, ("lut_hist",), "lut_hist")
