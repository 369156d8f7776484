"""The comparison that decides ``correct``: every answer kept from the
window against the plain reference (``perfbench/reference``) on the same
raw input, computed again from the benchmark's inputs and forest fields
once the program's state is freed.

Numbers compared (each printed beside its limit):

* ``worst_mismatch_share``: over the answers compared, the largest share
  of an answer's pixels whose class differs from the reference's; its
  limit is the traffic mix's ``limits.worst_mismatch_share``;
* ``missing_answers``: answers due in the window that never came or came
  as an error (limit 0).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from perfbench.reference import landcover


def reference_answer(ctx, scene: np.ndarray, fields, depth,
                     store_dtype=None) -> Tuple[np.ndarray, int]:
    """``(labels, forest comparisons)`` of the reference on ``scene``."""
    method = ctx.traffic["method"]
    if method == "random_forest":
        return landcover.forest_labels(scene, ctx.cfg, fields, depth, ctx.dev,
                                       store_dtype)
    if method == "rule_based":
        return landcover.rule_labels(scene, ctx.cfg, ctx.dev,
                                     store_dtype), 0
    raise SystemExit(f"no reference for method {method!r}")


def compare(ctx, answers: Iterable[Tuple[object, np.ndarray]],
            inputs: Dict[object, np.ndarray], missing: int, fields,
            depth) -> dict:
    """``{"correct", "numbers": {name: {"value", "limit"}},
    "compared", "comparisons_per_pixel"}``."""
    refs: Dict[object, np.ndarray] = {}
    comparisons = []
    worst, compared = 0.0, 0
    for key, out in answers:
        if key not in refs:
            refs[key], k = reference_answer(ctx, inputs[key], fields, depth)
            comparisons.append(k / refs[key].size)
        ref = refs[key]
        share = (1.0 if out.shape != ref.shape else
                 float(np.count_nonzero(out.astype(np.int64) != ref))
                 / ref.size)
        worst = max(worst, share)
        compared += 1
    limit = float(ctx.traffic["limits"]["worst_mismatch_share"])
    numbers = {"worst_mismatch_share": {"value": worst, "limit": limit},
               "missing_answers": {"value": missing, "limit": 0}}
    ok = compared > 0 and all(v["value"] <= v["limit"]
                              for v in numbers.values())
    return {"correct": ok, "numbers": numbers, "compared": compared,
            "comparisons_per_pixel": (float(np.mean(comparisons))
                                      if comparisons else 0.0)}
