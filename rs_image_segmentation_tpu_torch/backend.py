"""Device resolution, host and device copies, and f32 numerics for the
port's entry points.

Entry points run on CUDA unless the caller names another device; a call
with no device on a host without CUDA raises instead of drifting to the
CPU. Resolving a CUDA device also turns TF32 off for matmuls and cuDNN
convolutions: the feature stack is held to f32 parity with the JAX
package, and cuDNN convolutions default to TF32.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA device. Raises when no device is given and CUDA is absent.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def as_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` (a tensor, an array or a sequence) as a contiguous tensor on
    ``device``, cast to ``dtype`` when one is given (a sparse tensor stays
    sparse: it has no strides to make contiguous)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    t = t.to(device=device, dtype=dtype)
    return t if t.is_sparse else t.contiguous()


def host_numpy(tree):
    """``tree`` with every tensor leaf as a host numpy array, through
    nested dicts, lists and tuples; other leaves (arrays, Python numbers,
    strings) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: host_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_numpy(v) for v in tree)
    return tree
