"""Geo-referencing metadata of a raster, and the raster container.

Counterpart of ``rs_image_segmentation_tpu.core.types``: ``GeoMeta`` as a
plain frozen dataclass, and ``Raster`` as a plain dataclass with the same
fields and accessors (without the JAX package's pytree protocol). The
reference carries ``(geotransform, projection)`` from GDAL and rasterio's
``transform``/``crs``; ``GeoMeta`` takes both spellings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from ..backend import host_numpy


@dataclasses.dataclass(frozen=True)
class GeoMeta:
    """Geo-referencing metadata for a raster.

    ``transform`` uses the Affine coefficient order ``(a, b, c, d, e, f)``
    mapping pixel (col, row) -> world (x, y):
        x = a * col + b * row + c
        y = d * col + e * row + f
    GDAL's geotransform ``(c, a, b, f, d, e)`` converts via
    :meth:`from_gdal` / :meth:`to_gdal`.
    """

    transform: Optional[Tuple[float, float, float, float, float, float]] = None
    crs: Optional[str] = None  # WKT or "EPSG:xxxx"
    nodata: Optional[float] = None

    @classmethod
    def from_gdal(cls, geotransform, projection=None, nodata=None) -> "GeoMeta":
        if geotransform is None:
            return cls(None, projection or None, nodata)
        c, a, b, f, d, e = geotransform
        return cls((a, b, c, d, e, f), projection or None, nodata)

    def to_gdal(self):
        if self.transform is None:
            return None
        a, b, c, d, e, f = self.transform
        return (c, a, b, f, d, e)

    @property
    def pixel_size(self) -> Optional[Tuple[float, float]]:
        if self.transform is None:
            return None
        a, _, _, _, e, _ = self.transform
        return (a, e)

    def is_identity(self) -> bool:
        return self.transform is None or self.transform == (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


@dataclasses.dataclass
class Raster:
    """A band-stacked raster: ``data`` is ``(C, H, W)`` (or ``(H, W)``),
    a numpy array or a tensor, with its geo metadata and band names."""

    data: Any
    meta: GeoMeta = dataclasses.field(default_factory=GeoMeta)
    band_names: Optional[Tuple[str, ...]] = None

    @property
    def shape(self):
        return self.data.shape

    @property
    def count(self) -> int:
        return 1 if self.data.ndim == 2 else int(self.data.shape[0])

    @property
    def height(self) -> int:
        return int(self.data.shape[-2])

    @property
    def width(self) -> int:
        return int(self.data.shape[-1])

    def band(self, i: int):
        """0-based band accessor."""
        return self.data if self.data.ndim == 2 else self.data[i]

    def with_data(self, data) -> "Raster":
        return Raster(data, self.meta, self.band_names)

    def numpy(self) -> np.ndarray:
        """``data`` as a host numpy array."""
        return np.asarray(host_numpy(self.data))
