"""The check that nothing in the process is JAX or the JAX package.

Module names are compared by their top-level name whole: the port's
package, ``rs_image_segmentation_tpu_torch``, begins with the JAX
package's name and is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rs_image_segmentation_tpu"})


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded module names (``sys.modules`` unless given) whose
    top-level name is forbidden, sorted."""
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
