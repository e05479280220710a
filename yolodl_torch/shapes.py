"""Symbolic tensor shapes for model-graph shape inference.

Equivalent capability to the reference's ``tensor-shape`` crate
(``tensor-shape/src/{dim,shape}.rs``): a ``Dim`` is either a known size or the
unknown marker ``"_"``; a ``Shape`` is a tuple of dims with broadcast/equality
helpers.  Serialization uses ``"_"`` for unknown, matching the JSON5 model
format (e.g. ``"shape": ["_", 3, "_", "_"]``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple, Union

DimLike = Union[int, str, None, "Dim"]


@dataclasses.dataclass(frozen=True)
class Dim:
    """One tensor dimension: a known non-negative size, or unknown (None)."""

    size: Optional[int] = None

    @staticmethod
    def of(value: DimLike) -> "Dim":
        if isinstance(value, Dim):
            return value
        if value is None:
            return Dim(None)
        if isinstance(value, str):
            if value == "_":
                return Dim(None)
            size = int(value)
            if size < 0:  # same rule as the int branch below
                raise ValueError(f"dim size must be non-negative: {value!r}")
            return Dim(size)
        if isinstance(value, bool):  # guard against bools sneaking in as ints
            raise TypeError(f"invalid dim value: {value!r}")
        if isinstance(value, int):
            if value < 0:
                raise ValueError(f"dim size must be non-negative: {value}")
            return Dim(value)
        raise TypeError(f"invalid dim value: {value!r}")

    @property
    def is_known(self) -> bool:
        return self.size is not None

    def equals(self, other: "Dim") -> bool:
        """Compatibility: unknown matches anything (reference Dim semantics)."""
        if self.size is None or other.size is None:
            return True
        return self.size == other.size

    def unify(self, other: "Dim") -> "Dim":
        """Merge two compatible dims, preferring the known one."""
        if not self.equals(other):
            raise ValueError(f"cannot unify dims {self} and {other}")
        return self if self.size is not None else other

    def __mul__(self, other: DimLike) -> "Dim":
        o = Dim.of(other)
        if self.size is None or o.size is None:
            return Dim(None)
        return Dim(self.size * o.size)

    def __add__(self, other: DimLike) -> "Dim":
        o = Dim.of(other)
        if self.size is None or o.size is None:
            return Dim(None)
        return Dim(self.size + o.size)

    def map(self, fn) -> "Dim":
        """Apply ``fn`` to the size when known (e.g. conv output-size rule)."""
        if self.size is None:
            return Dim(None)
        return Dim(int(fn(self.size)))

    def to_json(self) -> Union[int, str]:
        return self.size if self.size is not None else "_"

    def __repr__(self) -> str:
        return "_" if self.size is None else str(self.size)


class Shape(Tuple[Dim, ...]):
    """A tuple of :class:`Dim` with helpers for shape inference."""

    def __new__(cls, dims: Iterable[DimLike] = ()) -> "Shape":
        return super().__new__(cls, tuple(Dim.of(d) for d in dims))

    @staticmethod
    def of(value: Union["Shape", Sequence[DimLike]]) -> "Shape":
        if isinstance(value, Shape):
            return value
        return Shape(value)

    @property
    def rank(self) -> int:
        return len(self)

    @property
    def is_fully_known(self) -> bool:
        return all(d.is_known for d in self)

    def equals(self, other: Union["Shape", Sequence[DimLike]]) -> bool:
        other = Shape.of(other)
        if len(self) != len(other):
            return False
        return all(a.equals(b) for a, b in zip(self, other))

    def unify(self, other: Union["Shape", Sequence[DimLike]]) -> "Shape":
        other = Shape.of(other)
        if len(self) != len(other):
            raise ValueError(f"cannot unify shapes {self} and {other}: rank mismatch")
        return Shape(a.unify(b) for a, b in zip(self, other))

    def concrete(self) -> Tuple[int, ...]:
        """Return a fully-known python tuple, or raise."""
        if not self.is_fully_known:
            raise ValueError(f"shape {self} is not fully known")
        return tuple(d.size for d in self)  # type: ignore[misc]

    def with_dim(self, axis: int, dim: DimLike) -> "Shape":
        dims = list(self)
        dims[axis] = Dim.of(dim)
        return Shape(dims)

    def to_json(self) -> list:
        return [d.to_json() for d in self]

    def __repr__(self) -> str:
        return "[" + ", ".join(repr(d) for d in self) + "]"
