"""Settings of the benchmark's own tests (``python -m pytest
perfbench/tests``). Tests marked ``card`` need a CUDA card; each decides
so inside itself and skips elsewhere. Run them on the chip with ``python
-m pytest perfbench/tests -m card``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def small(monkeypatch):
    """Shrink every configuration to 96 x 96 tiles (the 6000 x 6000 scene
    to a 3 x 3 mosaic of them, 84-row tiles) for runs on the CPU. A pixel
    is then 1.1e-4 of a tile, so the mismatch limit becomes 1e-3 (nine
    pixels of a tile); every fault the tests plant reads far above it."""
    from perfbench.harness import manifest
    orig = manifest.config
    orig_traffic = manifest.traffic

    def traffic(name):
        t = orig_traffic(name)
        t["limits"]["worst_mismatch_share"] = 1e-3
        return t

    def config(bench, name, root=manifest.ROOT):
        c = orig(bench, name, root)
        c["tile"] = {"height": 96, "width": 96}
        if "tile_rows" in c:
            c["scene"].update(height=288, width=288)
            c["tile_rows"] = 84
        else:
            c["scene"].update(height=96, width=96)
        return c

    monkeypatch.setattr(manifest, "config", config)
    monkeypatch.setattr(manifest, "traffic", traffic)
    return config
