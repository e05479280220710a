"""Unit-tagged value wrappers.

Counterpart of ``yolodl_tpu/units.py``, the port's own copy (numpy only).
Equivalent capability to the reference's ``unit-wrapper`` crate
(``unit_wrapper!`` macro, unit-wrapper/src/lib.rs:1-163) and the
``Pixel<T>`` / ``Ratio<T>`` tags in tch-goodies (``src/unit.rs:3-4``):
newtypes that document which coordinate frame a quantity lives in and pass
arithmetic through while refusing to silently mix frames.

Most of the port keeps plain tensors with documented units (ratio = 0-1 of
image size; pixel = absolute); these wrappers are the public-API seam for
code that wants a pixel/ratio mixup caught at run time, e.g. dataset
adapters.
"""

from __future__ import annotations

from typing import Any, Generic, TypeVar

import numpy as np

T = TypeVar("T")


class _UnitWrapper(Generic[T]):
    __slots__ = ("value",)
    UNIT = "?"

    def __init__(self, value: T):
        self.value = value

    def _coerce(self, other: Any):
        if isinstance(other, _UnitWrapper):
            if type(other) is not type(self):
                raise TypeError(
                    f"cannot mix {type(self).__name__} with {type(other).__name__}"
                )
            return other.value
        return other

    def __add__(self, other):
        return type(self)(self.value + self._coerce(other))

    def __sub__(self, other):
        return type(self)(self.value - self._coerce(other))

    def __mul__(self, other):
        return type(self)(self.value * self._coerce(other))

    def __truediv__(self, other):
        return type(self)(self.value / self._coerce(other))

    def __neg__(self):
        return type(self)(-self.value)

    # reflected forms: 2 * Pixel(3) must work like Pixel(3) * 2 — the
    # pass-arithmetic-through contract is symmetric
    def __radd__(self, other):
        return type(self)(self._coerce(other) + self.value)

    def __rsub__(self, other):
        return type(self)(self._coerce(other) - self.value)

    def __rmul__(self, other):
        return type(self)(self._coerce(other) * self.value)

    def __rtruediv__(self, other):
        return type(self)(self._coerce(other) / self.value)

    def __eq__(self, other):
        return type(other) is type(self) and bool(np.all(self.value == other.value))

    def __hash__(self):
        # defining __eq__ alone would set __hash__ = None, making
        # Pixel/Ratio unusable in sets/dict keys (scalar wrappers only;
        # array-valued wrappers hash by shape/bytes)
        v = self.value
        if np.isscalar(v) or getattr(v, "ndim", 1) == 0:
            return hash((type(self).__name__, float(v)))
        arr = np.asarray(v)
        return hash((type(self).__name__, arr.shape, arr.tobytes()))

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def map(self, fn):
        return type(self)(fn(self.value))


class Pixel(_UnitWrapper[T]):
    """Absolute pixel coordinates."""

    UNIT = "px"

    def to_ratio(self, size: float) -> "Ratio":
        return Ratio(self.value / size)


class Ratio(_UnitWrapper[T]):
    """0-1 image-fraction coordinates."""

    UNIT = "ratio"

    def to_pixel(self, size: float) -> Pixel:
        return Pixel(self.value * size)
