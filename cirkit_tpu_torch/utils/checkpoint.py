"""Carry parameter stores into the port.

A compiled circuit's parameters are a flat mapping from slot name to an
``(F, ...)`` array, with the same slot names in the JAX package and in the
port, so a store moves between them by name:
``store_from_numpy({k: np.asarray(v) for k, v in jax_ctx.parameters.items()},
device=..., slots=...)``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def store_from_numpy(
    arrays: Mapping[str, np.ndarray],
    *,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
    slots: Mapping | None = None,
) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` copied from a mapping of slot name to array.

    ``dtype`` casts every array (default: keep each array's dtype). With
    ``slots`` (slot name -> compiled tensor slot, e.g. ``cc.slots``), the
    names must be exactly the slots' names and every array must have its
    slot's ``(F, *shape)``; anything else raises.
    """
    if slots is not None:
        missing = sorted(set(slots) - set(arrays))
        unknown = sorted(set(arrays) - set(slots))
        if missing or unknown:
            raise KeyError(f"Store names do not match the slots: missing {missing}, "
                           f"unknown {unknown}")
        for name, node in slots.items():
            expected = (node.num_folds, *node.shape)
            if tuple(np.shape(arrays[name])) != expected:
                raise ValueError(
                    f"Slot {name} has shape {expected}, the array {np.shape(arrays[name])}"
                )
    return {
        name: torch.tensor(np.asarray(a), device=device, dtype=dtype)
        for name, a in arrays.items()
    }
