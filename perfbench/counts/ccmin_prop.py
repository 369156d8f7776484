"""Bytes and operations of one ``ops.kernels.ccmin_prop`` call
(``csrc/ccmin_prop.cu``: ``cc_tile``, ``cc_borders``, ``cc_roots``,
``cc_gather``), from its shapes. Frozen copy of the count in
``chip_smoke.py`` (``cc_bytes``) at commit
3b8722c442acffa7c4dd38665a58daa3434fcab6: the uint8 masks and int32 seeds
read once, the int32 minima written once; one operation a pixel.

A call: ``{"masks": M, "pixels": N}`` (M masks of N pixels)."""

KERNELS = ("cc_tile", "cc_borders", "cc_roots", "cc_gather")
ENTRY = ("cc_tile",)     # once a call


def count(call: dict):
    px = call["masks"] * call["pixels"]
    return px * (1 + 4 + 4), px
