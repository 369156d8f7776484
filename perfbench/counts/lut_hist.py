"""Bytes and operations of one ``ops.kernels.lut_hist`` call
(``csrc/lut_hist.cu``), from its shapes. Frozen copy of the count in
``rs_image_segmentation_tpu_torch/tools/kernel_times.py::measure`` at
commit 3b8722c442acffa7c4dd38665a58daa3434fcab6: each input byte read
once, each output byte written once.

A call: ``{"planes": P, "pixels": N, "out_bytes": 1 or 4, "hist": bool}``
(P planes of N uint8 pixels, a (P, 256) uint8 table each; with ``hist``
the (P, 256) int32 histogram is written too)."""

KERNELS = ("lut_hist_kernel", "lut_hist_cluster_kernel")
ENTRY = KERNELS          # each call launches one of them


def count(call: dict):
    p, n = call["planes"], call["pixels"]
    nbytes = p * (n * (1 + call["out_bytes"]) + 256
                  + (256 * 4 if call["hist"] else 0))
    return nbytes, p * n
