"""Precision-agnostic symbolic data types.

Rebuild of ``cirkit/symbolic/dtypes.py:6-44``. The backend decides the
concrete precision (f32 by default, f64 when ``jax_enable_x64`` is set).
"""

from __future__ import annotations

from enum import IntEnum, auto

import numpy as np


class DataType(IntEnum):
    """The available symbolic data types (precision-agnostic)."""

    INTEGER = auto()
    REAL = auto()
    COMPLEX = auto()


def dtype_value(x: int | float | complex | np.number | np.ndarray) -> DataType:
    """Infer the symbolic data type of a Python number or numpy array."""
    if isinstance(x, bool):
        raise ValueError("Booleans have no symbolic data type")
    if isinstance(x, int):
        return DataType.INTEGER
    if isinstance(x, float):
        return DataType.REAL
    if isinstance(x, complex):
        return DataType.COMPLEX
    if isinstance(x, (np.ndarray, np.number)):
        kind = np.asarray(x).dtype.kind
        if kind in "iu":
            return DataType.INTEGER
        if kind == "f":
            return DataType.REAL
        if kind == "c":
            return DataType.COMPLEX
    raise ValueError(f"Cannot infer the data type of an object of type {type(x)}")
