"""Backend-agnostic compiler scaffolding.

Rebuild of ``cirkit/backend/compiler.py:20-212`` and
``cirkit/backend/registry.py``: an abstract compiler holding three
type-keyed rule registries (layers, parameter nodes, initializers), compiler
flags, and a memoized symbolic<->compiled circuit map.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable
from typing import Any, Generic, TypeVar

from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.initializers import Initializer
from cirkit_tpu_torch.symbolic.layers import Layer
from cirkit_tpu_torch.symbolic.parameters import ParameterNode
from cirkit_tpu_torch.utils.algorithms import BiMap

SUPPORTED_BACKENDS = ["jax"]

T = TypeVar("T", bound=type)


class CompilerRegistry(Generic[T]):
    """A registry of compilation rules keyed on symbolic node type, with the
    key type read off the rule function's second argument annotation."""

    def __init__(self, base_type: type, rules: dict[type, Callable] | None = None):
        self._base_type = base_type
        self._rules: dict[type, Callable] = dict(rules) if rules else {}

    def add_rule(self, func: Callable) -> None:
        import sys

        raw = dict(getattr(func, "__annotations__", {}))
        raw.pop("return", None)
        module_globals = getattr(sys.modules.get(func.__module__), "__dict__", {})
        arg_types: list[type] = []
        for t in raw.values():
            if isinstance(t, str):
                # PEP 563 string annotations: resolve each one best-effort
                # (forward references like "JaxCompiler" may be unresolvable
                # at registration time; they are not the key type anyway).
                try:
                    t = eval(t, module_globals)  # noqa: S307
                except Exception:
                    continue
            if isinstance(t, type) and issubclass(t, self._base_type):
                arg_types.append(t)
        if not arg_types:
            raise ValueError(
                f"Compilation rule {func} must annotate an argument with a "
                f"{self._base_type.__name__} subclass"
            )
        self._rules[arg_types[0]] = func

    def retrieve_rule(self, cls: type) -> Callable:
        if cls in self._rules:
            return self._rules[cls]
        # Fall back to the most-derived registered superclass.
        for base in cls.__mro__[1:]:
            if base in self._rules:
                return self._rules[base]
        raise NotImplementedError(f"No compilation rule for type {cls.__name__}")

    def __contains__(self, cls: type) -> bool:
        try:
            self.retrieve_rule(cls)
            return True
        except NotImplementedError:
            return False


class CompilerLayerRegistry(CompilerRegistry):
    def __init__(self, rules=None):
        super().__init__(Layer, rules)


class CompilerParameterRegistry(CompilerRegistry):
    def __init__(self, rules=None):
        super().__init__(ParameterNode, rules)


class CompilerInitializerRegistry(CompilerRegistry):
    def __init__(self, rules=None):
        super().__init__(Initializer, rules)


class AbstractCompiler(ABC):
    """Base compiler: rule registries + flags + compiled-circuit memoization."""

    def __init__(
        self,
        layer_registry: CompilerLayerRegistry,
        parameter_registry: CompilerParameterRegistry,
        initializer_registry: CompilerInitializerRegistry,
        **flags: Any,
    ):
        self._layer_registry = layer_registry
        self._parameter_registry = parameter_registry
        self._initializer_registry = initializer_registry
        self._flags = flags
        self._compiled_circuits: BiMap[Circuit, Any] = BiMap()

    def is_compiled(self, sc: Circuit) -> bool:
        return self._compiled_circuits.has_left(sc)

    def has_symbolic(self, cc: Any) -> bool:
        return self._compiled_circuits.has_right(cc)

    def get_compiled_circuit(self, sc: Circuit) -> Any:
        return self._compiled_circuits.get_left(sc)

    def get_symbolic_circuit(self, cc: Any) -> Circuit:
        return self._compiled_circuits.get_right(cc)

    def register_compiled_circuit(self, sc: Circuit, cc: Any) -> None:
        self._compiled_circuits.add(sc, cc)

    def add_layer_rule(self, func: Callable) -> None:
        self._layer_registry.add_rule(func)

    def add_parameter_rule(self, func: Callable) -> None:
        self._parameter_registry.add_rule(func)

    def add_initializer_rule(self, func: Callable) -> None:
        self._initializer_registry.add_rule(func)

    def retrieve_layer_rule(self, cls: type) -> Callable:
        return self._layer_registry.retrieve_rule(cls)

    def retrieve_parameter_rule(self, cls: type) -> Callable:
        return self._parameter_registry.retrieve_rule(cls)

    def retrieve_initializer_rule(self, cls: type) -> Callable:
        return self._initializer_registry.retrieve_rule(cls)

    def compile(self, sc: Circuit) -> Any:
        """Compile a symbolic circuit (memoized)."""
        if self.is_compiled(sc):
            return self.get_compiled_circuit(sc)
        return self.compile_pipeline(sc)

    @abstractmethod
    def compile_pipeline(self, sc: Circuit) -> Any: ...
