"""The operator-rule registry.

Rebuild of ``cirkit/symbolic/registry.py:12-118``: a ContextVar-scoped
registry of layer-operator rules keyed by (operator, layer-type signature),
with signatures extracted from the rule function's type annotations so users
can register rules for new layer types without touching the core.
"""

from __future__ import annotations

import typing
from collections import defaultdict
from collections.abc import Iterable
from contextlib import AbstractContextManager
from contextvars import ContextVar, Token
from types import TracebackType

from cirkit_tpu_torch.symbolic.circuit import CircuitBlock
from cirkit_tpu_torch.symbolic.layers import Layer, LayerOperator
from cirkit_tpu_torch.symbolic.operators import (
    DEFAULT_OPERATOR_RULES,
    LayerOperatorFunc,
    LayerOperatorSpecs,
)


class OperatorNotFound(Exception):
    """Raised when no rules exist for a layer operator."""

    def __init__(self, op: LayerOperator):
        super().__init__(f"Symbolic operator named '{op.name}' not found")
        self.operator = op


class OperatorSignatureNotFound(Exception):
    """Raised when an operator has no rule for a layer-type signature."""

    def __init__(self, op: LayerOperator, *signature: type[Layer]):
        sig = ", ".join(cls.__name__ for cls in signature)
        super().__init__(f"Symbolic operator '{op.name}' for signature ({sig}) not found")
        self.operator = op
        self.signature = tuple(signature)


class OperatorRegistry(AbstractContextManager):
    """Registry of layer-operator rules, usable as a context manager."""

    def __init__(self) -> None:
        self._rules: dict[LayerOperator, LayerOperatorSpecs] = defaultdict(dict)
        self._token: Token[OperatorRegistry] | None = None

    @classmethod
    def from_default_rules(cls) -> "OperatorRegistry":
        registry = cls()
        for op, funcs in DEFAULT_OPERATOR_RULES.items():
            for f in funcs:
                registry.add_rule(op, f)
        return registry

    @property
    def operators(self) -> Iterable[LayerOperator]:
        return self._rules.keys()

    def __enter__(self) -> "OperatorRegistry":
        self._token = OPERATOR_REGISTRY.set(self)
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        assert self._token is not None
        OPERATOR_REGISTRY.reset(self._token)
        self._token = None

    def has_rule(self, op: LayerOperator, *signature: type[Layer]) -> bool:
        """Whether a rule exists for the signature (subclass-aware)."""
        specs = self._rules.get(op)
        if not specs:
            return False
        if signature in specs:
            return True
        return any(
            len(signature) == len(s)
            and all(issubclass(a, b) for a, b in zip(signature, s))
            for s in specs
        )

    def retrieve_rule(self, op: LayerOperator, *signature: type[Layer]) -> LayerOperatorFunc:
        """Look up the rule for an exact layer-type signature."""
        if op not in self._rules:
            raise OperatorNotFound(op)
        specs = self._rules[op]
        if signature in specs:
            return specs[signature]
        raise OperatorSignatureNotFound(op, *signature)

    def add_rule(self, op: LayerOperator, func: LayerOperatorFunc) -> None:
        """Register a rule; the signature is read off the type annotations."""
        try:
            # Resolve string annotations (PEP 563) into actual types
            annotations = dict(typing.get_type_hints(func))
        except Exception:
            annotations = dict(getattr(func, "__annotations__", {}))
        ret = annotations.pop("return", None)
        if ret is None or not (isinstance(ret, type) and issubclass(ret, CircuitBlock)):
            raise ValueError(
                f"An operator rule must be annotated to return a CircuitBlock: {func}"
            )
        layer_args = [
            (i, t)
            for i, t in enumerate(annotations.values())
            if isinstance(t, type) and issubclass(t, Layer)
        ]
        locs = tuple(i for i, _ in layer_args)
        if locs != tuple(range(len(locs))):
            raise ValueError(
                "The layer operands must be the first arguments of the operator rule"
            )
        signature = tuple(t for _, t in layer_args)
        self._rules[op][signature] = func


OPERATOR_REGISTRY: ContextVar[OperatorRegistry] = ContextVar(
    "OPERATOR_REGISTRY", default=OperatorRegistry.from_default_rules()
)
"""The ambient operator registry, swapped by entering a registry context."""
