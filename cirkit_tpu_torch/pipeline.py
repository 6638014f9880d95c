"""The pipeline API: compilation contexts and compiled-circuit operators.

The counterpart of ``cirkit_tpu/pipeline.py:34-248``. A context binds a
backend compiler to a device, a seeded ``torch.Generator`` and an operator
registry; ``ctx.parameters`` is the ``nn.ParameterDict`` holding every
compiled circuit's parameters by slot name, so a derived circuit evaluates
against the same store as its operands. The compiled-circuit operators
(integrate, multiply, conjugate, differentiate, concatenate, mixture) apply
the symbolic operator and compile the result; it reads its operands'
parameters through pointer slots into the same store.

The module-level functions take ``ctx=`` or use the ambient context: the
innermost ``with PipelineContext(...)`` block, else a default context
(lse-sum, folded, optimized, on the CUDA card) created at first use, so
importing this module opens no CUDA context.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from contextvars import ContextVar, Token
from types import TracebackType

import numpy as np
import torch
from torch import nn

import cirkit_tpu_torch.symbolic.functional as SF
from cirkit_tpu_torch.backend.base import SUPPORTED_BACKENDS
from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
from cirkit_tpu_torch.backend.torch.parameters import TorchTensorSlot
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import LayerOperator
from cirkit_tpu_torch.symbolic.operators import LayerOperatorFunc
from cirkit_tpu_torch.symbolic.registry import OperatorRegistry
from cirkit_tpu_torch.utils.checkpoint import store_from_numpy
from cirkit_tpu_torch.utils.scope import Scope


def retrieve_compiler(backend: str, **backend_kwargs) -> TorchCompiler:
    """Instantiate a backend compiler by name: the PyTorch compiler under
    the reference's one backend name, ``"jax"`` (``SUPPORTED_BACKENDS`` of
    the copied ``backend/base.py``), so code written against the JAX
    package runs unchanged."""
    if backend not in SUPPORTED_BACKENDS:
        raise NotImplementedError(f"Backend '{backend}' is not implemented")
    return TorchCompiler(**backend_kwargs)


class PipelineContext:
    """Compilation context: backend flags, the device, the operator
    registry, and the shared parameter store, initialized on the device
    from a seeded generator. Entering it (``with ctx:``) makes it the
    ambient context of the module-level functions.

    ``backend`` takes the reference's name, ``"jax"`` (:func:`retrieve_compiler`).
    The device is the CUDA card unless ``device`` says otherwise; without a
    card, construction raises unless ``device="cpu"`` is passed."""

    def __init__(
        self,
        backend: str = "jax",
        *,
        semiring: str = "sum-product",
        fold: bool = False,
        optimize: bool = False,
        device: torch.device | str = "cuda",
        seed: int = 42,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PipelineContext: no CUDA device is available; pass device=\"cpu\" to run "
                "on the CPU"
            )
        self._compiler = retrieve_compiler(
            backend, semiring=semiring, fold=fold, optimize=optimize, device=self.device
        )
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._parameters = nn.ParameterDict()
        self._op_registry = OperatorRegistry.from_default_rules()
        self._token: Token[PipelineContext | None] | None = None

    @classmethod
    def from_default_backend(cls) -> "PipelineContext":
        """The default configuration: log-space, folded, optimized, on the
        CUDA card."""
        return cls(backend="jax", semiring="lse-sum", fold=True, optimize=True)

    # -- context management ----------------------------------------------------
    def __enter__(self) -> "PipelineContext":
        self._op_registry.__enter__()
        self._token = _PIPELINE_CONTEXT.set(self)
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        self._op_registry.__exit__(exc_type, exc_value, traceback)
        assert self._token is not None
        _PIPELINE_CONTEXT.reset(self._token)
        self._token = None

    def __getitem__(self, sc: Circuit) -> TorchCircuit:
        return self._compiler.get_compiled_circuit(sc)

    # -- extensibility hooks -----------------------------------------------------
    def add_operator_rule(self, op: LayerOperator, func: LayerOperatorFunc) -> None:
        self._op_registry.add_rule(op, func)

    def add_layer_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_layer_rule(func)

    def add_parameter_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_parameter_rule(func)

    def add_initializer_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_initializer_rule(func)

    def add_layer_optimization_rule(self, pattern, func: Callable, *,
                                    shatter: bool = False) -> None:
        """Register a layer-graph fusion (or, with ``shatter``, shatter)
        rewrite with the backend compiler."""
        self._compiler.add_layer_optimization_rule(pattern, func, shatter=shatter)

    def add_parameter_optimization_rule(self, pattern, func: Callable) -> None:
        """Register a parameter-graph rewrite with the backend compiler."""
        self._compiler.add_parameter_optimization_rule(pattern, func)

    # -- compilation + parameter store -------------------------------------------
    def _circuits(self) -> list[TorchCircuit]:
        return list(self._compiler._compiled_circuits._fwd.values())

    def _slots(self) -> dict[str, TorchTensorSlot]:
        return {s: node for cc in self._circuits() for s, node in cc.slots.items()}

    def compile(self, sc: Circuit) -> TorchCircuit:
        """Compile a symbolic circuit and initialize its new parameters into
        the context's shared store. Operand circuits compiled implicitly by
        the pipeline ordering are materialized too."""
        cc = self._compiler.compile(sc)
        for compiled in self._circuits():
            self._materialize(compiled)
        return cc

    def _materialize(self, cc: TorchCircuit) -> None:
        missing = [s for s in cc.slots if s not in self._parameters]
        if missing:
            fresh = cc.initialize(self._generator, self.device, missing)
            for s, value in fresh.items():
                self._parameters[s] = nn.Parameter(value, requires_grad=cc.slots[s].learnable)
        # Bind the shared store so circuits are callable as ``cc(x)``.
        cc.default_store = self._parameters

    @property
    def parameters(self) -> nn.ParameterDict:
        """The shared parameter store: slot name -> (F, ...) parameter."""
        return self._parameters

    def update_parameters(self, store: Mapping[str, torch.Tensor]) -> None:
        """Write tensors into the store by slot name (learnability follows
        the compiled slots)."""
        slots = self._slots()
        for s, value in store.items():
            learnable = slots[s].learnable if s in slots else False
            self._parameters[s] = nn.Parameter(value.detach(), requires_grad=learnable)

    def load_parameters(
        self, arrays: Mapping[str, np.ndarray], *, dtype: torch.dtype | None = None
    ) -> None:
        """Replace the whole store with arrays named by slot (e.g. a JAX
        store as numpy), checked against the compiled circuits' slots."""
        self.update_parameters(
            store_from_numpy(arrays, device=self.device, dtype=dtype, slots=self._slots())
        )

    def reset_parameters(self, seed: int | None = None) -> None:
        """Reinitialize every compiled circuit's parameters."""
        if seed is not None:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        for s in list(self._parameters.keys()):
            del self._parameters[s]
        for cc in self._circuits():
            self._materialize(cc)

    def is_compiled(self, sc: Circuit) -> bool:
        return self._compiler.is_compiled(sc)

    def has_symbolic(self, cc: TorchCircuit) -> bool:
        return self._compiler.has_symbolic(cc)

    def get_compiled_circuit(self, sc: Circuit) -> TorchCircuit:
        return self._compiler.get_compiled_circuit(sc)

    def get_symbolic_circuit(self, cc: TorchCircuit) -> Circuit:
        """The symbolic circuit ``cc`` was compiled from."""
        return self._compiler.get_symbolic_circuit(cc)

    # -- compiled-circuit operators ---------------------------------------------
    def _symbolic_operand(self, cc: TorchCircuit, which: str = "The given") -> Circuit:
        if not self._compiler.has_symbolic(cc):
            raise ValueError(f"{which} compiled circuit is not known in this pipeline")
        return self._compiler.get_symbolic_circuit(cc)

    def concatenate(self, *cc: TorchCircuit) -> TorchCircuit:
        scs = [self._symbolic_operand(c, f"The {i}-th") for i, c in enumerate(cc)]
        return self.compile(SF.concatenate(scs, registry=self._op_registry))

    def integrate(self, cc: TorchCircuit, scope: Scope | None = None) -> TorchCircuit:
        sc = self._symbolic_operand(cc)
        return self.compile(SF.integrate(sc, scope=scope, registry=self._op_registry))

    def mixture(self, *cc: TorchCircuit, weights=None, weight_factory=None,
                em_ready: bool = False) -> TorchCircuit:
        scs = [self._symbolic_operand(c, f"The {i}-th") for i, c in enumerate(cc)]
        return self.compile(
            SF.mixture(
                scs,
                weights=weights,
                weight_factory=weight_factory,
                em_ready=em_ready,
                registry=self._op_registry,
            )
        )

    def multiply(self, cc1: TorchCircuit, cc2: TorchCircuit) -> TorchCircuit:
        sc1 = self._symbolic_operand(cc1, "The first")
        sc2 = self._symbolic_operand(cc2, "The second")
        return self.compile(SF.multiply(sc1, sc2, registry=self._op_registry))

    def differentiate(self, cc: TorchCircuit, *, order: int = 1) -> TorchCircuit:
        """The circuit of the ``order``-th partial derivatives (of circuits
        whose input layers are polynomials)."""
        if order <= 0:
            raise ValueError("The order of differentiation must be positive")
        sc = self._symbolic_operand(cc)
        return self.compile(SF.differentiate(sc, order=order, registry=self._op_registry))

    def conjugate(self, cc: TorchCircuit) -> TorchCircuit:
        sc = self._symbolic_operand(cc)
        return self.compile(SF.conjugate(sc, registry=self._op_registry))


# -- module-level functional API with an ambient context ---------------------------

_PIPELINE_CONTEXT: ContextVar[PipelineContext | None] = ContextVar(
    "_PIPELINE_CONTEXT", default=None
)
"""The context of the innermost ``with PipelineContext(...)`` block."""
_DEFAULT_CONTEXT: PipelineContext | None = None


def _ambient(ctx: PipelineContext | None) -> PipelineContext:
    """``ctx``, else the entered context, else the default one (lse-sum,
    folded, optimized, on the CUDA card), created at the first call."""
    global _DEFAULT_CONTEXT
    if ctx is not None:
        return ctx
    ctx = _PIPELINE_CONTEXT.get()
    if ctx is not None:
        return ctx
    if _DEFAULT_CONTEXT is None:
        _DEFAULT_CONTEXT = PipelineContext.from_default_backend()
    return _DEFAULT_CONTEXT


# pylint: disable-next=redefined-builtin
def compile(sc: Circuit, ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).compile(sc)


def concatenate(*cc: TorchCircuit, ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).concatenate(*cc)


def integrate(cc: TorchCircuit, scope: Scope | None = None,
              ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).integrate(cc, scope=scope)


def multiply(cc1: TorchCircuit, cc2: TorchCircuit,
             ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).multiply(cc1, cc2)


def mixture(*cc: TorchCircuit, weights=None, weight_factory=None, em_ready: bool = False,
            ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).mixture(
        *cc, weights=weights, weight_factory=weight_factory, em_ready=em_ready
    )


def differentiate(cc: TorchCircuit, ctx: PipelineContext | None = None, *,
                  order: int = 1) -> TorchCircuit:
    return _ambient(ctx).differentiate(cc, order=order)


def conjugate(cc: TorchCircuit, ctx: PipelineContext | None = None) -> TorchCircuit:
    return _ambient(ctx).conjugate(cc)
