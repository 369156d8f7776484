"""Model serialization: forest tensors, KMeans state, run manifests.

Counterpart of ``rs_image_segmentation_tpu.models.serialize``, in the same
npz format, so each package loads the other's files. Inference never
needs sklearn: a forest is stored in its padded ``FlatForest`` form.
Loaded tensors sit on the CPU; a caller moves them to its device.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from .forest import FlatForest, flat_forest_from_numpy
from .kmeans import KMeansState


def save_flat_forest(path: str, forest: FlatForest, max_depth: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, **{k: v.cpu().numpy() for k, v in forest._asdict().items()},
        max_depth=np.asarray(max_depth))


def load_flat_forest(path: str) -> Tuple[FlatForest, int]:
    """``(forest on the CPU, max_depth)`` from a file of either package."""
    with np.load(path) as z:
        forest = flat_forest_from_numpy(
            {k: z[k] for k in FlatForest._fields})
        return forest, int(z["max_depth"])


def save_kmeans(path: str, state: KMeansState) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: v.cpu().numpy()
                                 for k, v in state._asdict().items()})


def load_kmeans(path: str) -> KMeansState:
    with np.load(path) as z:
        return KMeansState(torch.as_tensor(z["centroids"], dtype=torch.float32),
                           torch.as_tensor(z["inertia"], dtype=torch.float32),
                           torch.as_tensor(z["n_iter"], dtype=torch.int64))


def save_run_manifest(path: str, **fields) -> None:
    """Stage-progress manifest for resumable pipelines: which artifacts are
    complete, their hashes and shapes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(fields, f, indent=2, default=str)


def load_run_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
