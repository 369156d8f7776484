"""Plotting helpers, incl. CJK font configuration.

Counterpart of ``rs_image_segmentation_tpu.utils.plotting``: probe a list
of candidate font paths and families so CJK labels render when a suitable
font exists, and no-op cleanly otherwise. matplotlib is imported only when
called.
"""

from __future__ import annotations

import os
from typing import Optional

_CANDIDATE_PATHS = (
    "/System/Library/Fonts/STHeiti Medium.ttc",
    "/usr/share/fonts/truetype/wqy/wqy-zenhei.ttc",
    "/usr/share/fonts/opentype/noto/NotoSansCJK-Regular.ttc",
)
_CANDIDATE_FAMILIES = ("Noto Sans CJK SC", "WenQuanYi Zen Hei", "SimHei",
                       "STHeiti", "Microsoft YaHei")


def set_chinese_font(font_path: Optional[str] = None) -> bool:
    """Configure matplotlib for CJK text. Returns True when a font was set."""
    import matplotlib
    from matplotlib import font_manager

    paths = ([font_path] if font_path else []) + list(_CANDIDATE_PATHS)
    for p in paths:
        if p and os.path.exists(p):
            try:
                font_manager.fontManager.addfont(p)
                name = font_manager.FontProperties(fname=p).get_name()
                matplotlib.rcParams["font.family"] = [name]
                matplotlib.rcParams["axes.unicode_minus"] = False
                return True
            except Exception:
                continue
    available = {f.name for f in font_manager.fontManager.ttflist}
    for fam in _CANDIDATE_FAMILIES:
        if fam in available:
            matplotlib.rcParams["font.family"] = [fam]
            matplotlib.rcParams["axes.unicode_minus"] = False
            return True
    return False
