"""Geo-referencing metadata of a raster.

Counterpart of ``GeoMeta`` in ``rs_image_segmentation_tpu.core.types``, as
a plain frozen dataclass (the JAX package's ``Raster`` pytree has no
counterpart here). The reference carries ``(geotransform, projection)``
from GDAL and rasterio's ``transform``/``crs``; ``GeoMeta`` takes both
spellings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
