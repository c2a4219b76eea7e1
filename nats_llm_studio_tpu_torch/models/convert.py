"""Carry parameters and KV state across from the JAX package.

The port keeps the JAX package's parameter layout (a dict of ``[L, in,
out]`` stacks applied as ``x @ w``), so a pytree of numpy arrays — e.g.
``jax.tree.map(np.asarray, init_params(cfg, key))`` — converts leaf by leaf
with no reshuffle. Its int8 KV cache keeps the reference's layout too
(codes [..., S, D], scales [..., S]), so a ``KVQ`` pool or row cache
crosses as its two arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import torch_dtype
from ..ops.kvcache import KVQ


def params_from_numpy(tree: Any, device, dtype: str | torch.dtype = "float32") -> Any:
    """Same nesting as ``tree``; every array leaf becomes a tensor on
    ``device`` in ``dtype``."""
    dt = torch_dtype(dtype) if isinstance(dtype, str) else dtype
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dt) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32)  # a writable host copy
    return torch.from_numpy(arr).to(device=device, dtype=dt)


def kvq_from_numpy(codes, scales, device) -> KVQ:
    """A ``KVQ`` on ``device`` from the int8 codes and f32 scales of a JAX
    ``KVQ`` (``np.asarray(kvq.q)``, ``np.asarray(kvq.s)``), each kept in
    its own dtype: ``params_from_numpy`` casts every leaf to float and must
    not be used for KV state."""
    q = np.asarray(codes)
    s = np.asarray(scales)
    if q.dtype != np.int8 or s.dtype != np.float32 or s.shape != q.shape[:-1]:
        raise ValueError(f"expected int8 codes [..., S, D] and float32 scales [..., S], got "
                         f"{q.dtype}{list(q.shape)} and {s.dtype}{list(s.shape)}")
    return KVQ(q=torch.from_numpy(q.copy()).to(device),
               s=torch.from_numpy(s.copy()).to(device))
