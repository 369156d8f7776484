"""Serving layer: persistent inference engine + HTTP front-end.

Counterpart of ``rs_image_segmentation_tpu.serving``: a long-lived process
that keeps the kernels built and the forest on the card, and batches
concurrent requests into full programs. ``engine.InferenceEngine`` is that
process core; ``server``/``client`` expose it over HTTP with zero
third-party dependencies.
"""

from .engine import EngineConfig, InferenceEngine

__all__ = ["EngineConfig", "InferenceEngine"]
