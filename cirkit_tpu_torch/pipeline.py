"""The pipeline API: a compilation context that owns the parameter store.

The counterpart of ``cirkit_tpu/pipeline.py:34-153``. A context binds a
backend compiler to a device and a seeded ``torch.Generator``;
``ctx.parameters`` is the ``nn.ParameterDict`` holding every compiled
circuit's parameters by slot name, so a derived circuit evaluates against
the same store as its operands. The circuit operators (integrate,
multiply and the rest) are not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
from cirkit_tpu_torch.backend.torch.parameters import TorchTensorSlot
from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.utils.checkpoint import store_from_numpy


class PipelineContext:
    """Compilation context: backend flags, the device, and the shared
    parameter store, initialized on the device from a seeded generator.

    The device is the CUDA card unless ``device`` says otherwise; without a
    card, construction raises unless ``device="cpu"`` is passed."""

    def __init__(
        self,
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
        self._compiler = TorchCompiler(
            semiring=semiring, fold=fold, optimize=optimize, device=self.device
        )
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._parameters = nn.ParameterDict()

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
