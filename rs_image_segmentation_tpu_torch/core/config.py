"""Configuration dataclasses.

Every default mirrors a hardcoded constant in the reference (cited per field
group) so the stock pipeline reproduces the reference's behavior; all of them
are overridable, replacing the reference's scattered magic numbers with one
config surface (reference has no config system — SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """DN -> radiance gains/biases (reference preprocessing.py:65-66)."""

    gains: Tuple[float, ...] = (0.671339, 1.322205, 1.043976, 0.876024, 0.120354, 0.055376, 0.065551)
    biases: Tuple[float, ...] = (-2.19, -4.16, -2.21, -2.39, -0.49, 1.18, -0.22)


@dataclasses.dataclass(frozen=True)
class NormalizeConfig:
    """Percentile clip-normalize (reference indices.py:25-48)."""

    lower_percentile: float = 2.0
    upper_percentile: float = 98.0
    epsilon: float = 1e-10


@dataclasses.dataclass(frozen=True)
class GLCMConfig:
    """Gray-level co-occurrence texture (reference indices.py:248-249)."""

    levels: int = 32
    window_size: int = 21
    step_size: int = 21
    distances: Tuple[int, ...] = (1,)
    # skimage angle convention: offset = (round(d*sin(a)), round(d*cos(a)))
    angles: Tuple[float, ...] = (0.0, 0.7853981633974483, 1.5707963267948966, 2.356194490192345)


@dataclasses.dataclass(frozen=True)
class LBPConfig:
    """Uniform local binary patterns (reference indices.py:320-344)."""

    radius: int = 3
    n_points: int = 24


@dataclasses.dataclass(frozen=True)
class MultiScaleConfig:
    """Windowed mean/var/std/entropy (reference indices.py:519-562)."""

    scales: Tuple[int, ...] = (1, 3, 5, 7)
    entropy_max_scale: int = 5
    entropy_levels: int = 256


@dataclasses.dataclass(frozen=True)
class MorphologyConfig:
    """Erode/dilate/open/close/gradient kernels (reference indices.py:401-442)."""

    kernel_sizes: Tuple[int, ...] = (3, 5, 7)


@dataclasses.dataclass(frozen=True)
class SpatialContextConfig:
    """Box-filter context concat (reference indices.py:760-776)."""

    window_size: int = 7


@dataclasses.dataclass(frozen=True)
class RuleBasedConfig:
    """Stage-3 rule-based thresholds (reference 3_classification.py:338-375,
    extract.py:397-505). ``*_min_area_frac`` are multiplied by H*W."""

    ndvi_threshold: float = 0.25
    ndwi_threshold: float = 0.05
    mndwi_threshold: float = 0.1
    use_mndwi_if_available: bool = True
    ndbi_threshold: float = 0.0
    ndvi_threshold_for_builtup: float = 0.2
    veg_min_area_frac: float = 0.0005
    water_min_area_frac: float = 0.0002
    builtup_min_area_frac: float = 0.001
    bareland_min_area_frac: float = 0.0005
    bareland_ndvi_low: float = -0.1
    bareland_ndvi_high: float = 0.2
    bareland_ndbi_low: float = -0.2
    bareland_ndbi_high: float = 0.2


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """KMeans clustering (reference extract.py:576-577, 3_classification.py:390)."""

    n_clusters: int = 7
    max_iter: int = 300
    tol: float = 1e-4
    seed: int = 42
    n_init: int = 1  # sklearn n_init='auto' with k-means++ => 1


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Random forest (reference supervised_classifiers.py:90, extract.py:650)."""

    n_estimators: int = 100
    max_depth: Optional[int] = None
    seed: int = 42
    test_size: float = 0.3  # reference extract.py:635 validation split


@dataclasses.dataclass(frozen=True)
class ClassTables:
    """Class id -> name/color tables (reference 3_classification.py:320-330,
    4_evaluate.py:33-48)."""

    names: Tuple[Tuple[int, str], ...] = (
        (0, "Unclassified"), (1, "Vegetation"), (2, "Water"), (3, "Built-up"), (4, "Bareland"),
        (5, "KMeans cluster 5"), (6, "KMeans cluster 6"), (7, "KMeans cluster 7"),
        (8, "KMeans cluster 8"), (9, "KMeans cluster 9"), (10, "KMeans cluster 10"),
    )
    colors: Tuple[Tuple[int, Tuple[int, int, int]], ...] = (
        (0, (0, 0, 0)), (1, (0, 128, 0)), (2, (0, 0, 255)), (3, (255, 0, 0)),
        (4, (255, 255, 0)), (5, (128, 0, 128)), (6, (0, 255, 255)), (7, (255, 165, 0)),
        (8, (128, 128, 128)), (9, (0, 128, 128)), (10, (128, 128, 0)),
    )

    def names_dict(self) -> Dict[int, str]:
        return dict(self.names)

    def colors_dict(self) -> Dict[int, List[int]]:
        return {k: list(v) for k, v in self.colors}


# Evaluation-stage class mapping (reference 4_evaluate.py:33-48).
EVAL_CLASS_NAMES: Dict[int, str] = {
    0: "Background", 1: "Vegetation", 2: "Water", 3: "Built-up", 4: "Bareland",
}
EVAL_CLASS_COLORS: Dict[int, Tuple[float, float, float]] = {
    0: (0.0, 0.0, 0.0), 1: (0.0, 0.8, 0.0), 2: (0.0, 0.0, 1.0),
    3: (1.0, 0.0, 0.0), 4: (1.0, 1.0, 0.0),
}


@dataclasses.dataclass(frozen=True)
class FeatureStageConfig:
    """Aggregate stage-2 configuration."""

    normalize: NormalizeConfig = NormalizeConfig()
    glcm: GLCMConfig = GLCMConfig()
    lbp: LBPConfig = LBPConfig()
    multiscale: MultiScaleConfig = MultiScaleConfig()
    morphology: MorphologyConfig = MorphologyConfig()
    context: SpatialContextConfig = SpatialContextConfig()
    texture_band_index: int = 3  # NIR; the reference ignores its own
    # texture_band_index param and hardcodes NIR (2_feature_extraction.py:84)
    include_gabor: bool = False  # reference defines but never calls gabor (indices.py:346)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    calibration: CalibrationConfig = CalibrationConfig()
    features: FeatureStageConfig = FeatureStageConfig()
    rule_based: RuleBasedConfig = RuleBasedConfig()
    kmeans: KMeansConfig = KMeansConfig()
    forest: ForestConfig = ForestConfig()
    classes: ClassTables = ClassTables()
