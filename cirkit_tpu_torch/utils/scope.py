"""Variable scopes.

TPU-native rebuild of the reference's scope container
(``cirkit/utils/scope.py:4-192``): an immutable, hashable set of variable ids
with set algebra. We additionally guarantee iteration in ascending id order
(the reference implicitly relies on this for differentiation ordering, see
``cirkit/symbolic/functional.py:541``).
"""

from __future__ import annotations

from collections.abc import Hashable, Iterable, Iterator


class Scope(Hashable):
    """An immutable ordered set of non-negative variable ids."""

    __slots__ = ("_ids", "_set")

    def __init__(self, scope: Iterable[int] | None = None) -> None:
        ids: tuple[int, ...] = () if scope is None else tuple(sorted(set(scope)))
        if ids and ids[0] < 0:
            raise ValueError("Variable ids must be non-negative")
        self._ids = ids
        self._set = frozenset(ids)

    # -- container protocol -------------------------------------------------
    def __contains__(self, var: object) -> bool:
        return var in self._set

    def __iter__(self) -> Iterator[int]:
        return iter(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __hash__(self) -> int:
        return hash(self._set)

    def __repr__(self) -> str:
        return f"Scope({set(self._ids) if self._ids else 'set()'})"

    # -- comparisons (subset partial order; == is set equality) -------------
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Scope):
            return NotImplemented
        return self._set == other._set

    def __lt__(self, other: "Scope") -> bool:
        return self._set < other._set

    def __le__(self, other: "Scope") -> bool:
        return self._set <= other._set

    def __gt__(self, other: "Scope") -> bool:
        return self._set > other._set

    def __ge__(self, other: "Scope") -> bool:
        return self._set >= other._set

    # -- set algebra ---------------------------------------------------------
    def __and__(self, other: "Scope") -> "Scope":
        return Scope(self._set & other._set)

    def __or__(self, other: "Scope") -> "Scope":
        return Scope(self._set | other._set)

    def __sub__(self, other: "Scope") -> "Scope":
        return Scope(self._set - other._set)

    def difference(self, other: "Scope") -> "Scope":
        """The scope of variables in self but not in other."""
        return self - other

    # pylint: disable-next=no-self-argument
    def union(*scopes: "Scope") -> "Scope":
        """N-ary union; usable as ``Scope.union(a, b, c)`` or ``a.union(b)``."""
        out: frozenset[int] = frozenset()
        for s in scopes:
            out |= s._set
        return Scope(out)
