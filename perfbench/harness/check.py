"""The comparison that decides ``correct``: every answer kept from the
window against the configuration's plain reference (the module at its
``reference`` path, ``manifest.reference``) on the same raw input,
computed again from the benchmark's inputs and forest fields once the
program's state is freed.

A reference module exports ``METHODS``, which maps a traffic ``method`` to
a callable ``(scene, cfg, fields, depth, device, store_dtype=None) ->
(labels, ops)``: ``labels`` the (H, W) int64 numpy classes of the raw
scene, ``ops`` the operations every implementation must do for it, as the
reference counts them. A method that fits nothing ignores ``fields`` and
``depth``; ``store_dtype`` rounds the reference's intermediate planes
through a lower precision (the control, ``perfbench/control.py``).

Numbers compared (each printed beside its limit):

* ``worst_mismatch_share``: over the answers compared, the largest share
  of an answer's pixels whose class differs from the reference's; its
  limit is the traffic mix's ``limits.worst_mismatch_share``;
* ``missing_answers``: answers due in the window that never came or came
  as an error (limit 0).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np

from perfbench.harness import manifest


def reference_method(ctx) -> Callable:
    """The configuration's reference for the traffic's ``method``."""
    ref = manifest.reference(ctx.cfg)
    method = ctx.traffic["method"]
    if method not in ref.METHODS:
        raise SystemExit(
            f"{ctx.cfg['reference']} has no reference for method "
            f"{method!r}; its METHODS: {', '.join(sorted(ref.METHODS))}")
    return ref.METHODS[method]


def reference_answer(ctx, scene: np.ndarray, fields, depth,
                     store_dtype=None) -> Tuple[np.ndarray, int]:
    """``(labels, ops)`` of the reference on ``scene``."""
    return reference_method(ctx)(scene, ctx.cfg, fields, depth, ctx.dev,
                                 store_dtype)


def compare(ctx, answers: Iterable[Tuple[object, np.ndarray]],
            inputs: Dict[object, np.ndarray], missing: int, fields,
            depth) -> dict:
    """``{"correct", "numbers": {name: {"value", "limit"}},
    "compared", "ops_per_pixel"}``."""
    reference = reference_method(ctx)
    refs: Dict[object, np.ndarray] = {}
    ops = []
    worst, compared = 0.0, 0
    for key, out in answers:
        if key not in refs:
            refs[key], k = reference(inputs[key], ctx.cfg, fields, depth,
                                     ctx.dev)
            ops.append(k / refs[key].size)
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
            "ops_per_pixel": float(np.mean(ops)) if ops else 0.0}
