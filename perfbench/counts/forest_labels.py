"""Bytes and operations of one ``ops.kernels.forest_labels`` call
(``csrc/forest_labels.cu``), from its shapes. Frozen copy of the count in
``chip_smoke.py`` (``forest_bytes``, ``forest_ops``) at commit
3b8722c442acffa7c4dd38665a58daa3434fcab6: the (F, N) f32 features read
once and the int32 labels written once; the operations are the node
comparisons these pixels need (one per level reached in each tree,
counted by the reference's walk) and the class sums of the fired leaves.

A call: ``{"pixels": N, "features": F, "trees": T, "classes": C,
"comparisons": K}``."""

KERNELS = ("forest_labels_kernel",)
ENTRY = KERNELS


def count(call: dict):
    n = call["pixels"]
    nbytes = n * call["features"] * 4 + n * 4
    ops = call["comparisons"] + n * (call["trees"] * call["classes"]
                                     + call["classes"])
    return nbytes, ops
