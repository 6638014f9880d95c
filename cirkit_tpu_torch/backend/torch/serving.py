"""Serving-store utilities: bf16-resident weights for inference, and a
portable exported forward.

The counterpart of ``cirkit_tpu/backend/jax/serving.py``. The flagship
forward streams its sum-style weights once per batch tile (the Tucker cores
of the MNIST QuadGraph K=64 circuit are 0.82 GB in float32), so storing
those weights in bfloat16 halves the dominant device-memory stream. The
kernels of the Tucker and dense sum layers, the blocked ones of wide dense
sums among them, read a bf16 weight or logits operand as it is and widen it
on chip (``ops/lse_einsum.py``), normalizing softmax rows in float32, and so
do the signed kernels of squared circuits (``ops/slse_einsum.py``) and MAP's
and sampling's routing kernels (``ops/routing.py``); the complex kernels,
which have no bf16 instance (nor does the JAX package), get a bf16 real
weight widened in their op wrappers.

This is an inference-oriented transform: keep training in float32 and cast
a copy for serving. Gradients through a bf16 store work (the weight's
gradient is accumulated in float32 and cast at the boundary) but are
rounded.
"""

from __future__ import annotations

import io
from collections.abc import Sequence

import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
from cirkit_tpu_torch.backend.torch.optimized import (
    TorchCPTLayer,
    TorchTensorDotLayer,
    TorchTuckerLayer,
)
from cirkit_tpu_torch.backend.torch.parameters import (
    Store,
    TorchMixingWeightParameter,
    TorchTensorSlot,
)

_QUERIES = ("evaluate", "integrate")


def weight_slots(circuit: TorchCircuit) -> set[str]:
    """The store slots streamed as sum-style contraction weights: softmax
    logits slots (the kernels' fused parameterization) and plain weight
    slots, for dense/mixing/fused Tucker/CPT/TensorDot layers."""
    slots: set[str] = set()
    for layer in circuit.layers:
        if not isinstance(
            layer, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer, TorchTensorDotLayer)
        ):
            continue
        if getattr(layer, "_logits_slot", None) is not None:
            slots.add(layer._logits_slot)
            continue
        # only slots the kernels stream *directly* (bare weights or a 0/1
        # MixingWeight placement): casting a slot feeding e.g. an Exp
        # reparameterization would amplify the rounding through the map
        nodes = list(layer.weight.topological_ordering())
        if len(nodes) == 1 and isinstance(nodes[0], TorchTensorSlot):
            slots.add(nodes[0].slot)
        elif (
            len(nodes) == 2
            and isinstance(nodes[0], TorchTensorSlot)
            and isinstance(nodes[1], TorchMixingWeightParameter)
        ):
            slots.add(nodes[0].slot)
    return slots


def bf16_weight_store(circuit: TorchCircuit, store: Store) -> dict[str, torch.Tensor]:
    """A copy of ``store`` with the circuit's contraction-weight slots cast
    to bfloat16 (round to nearest even). Forward accuracy matches the
    ``CIRKIT_TPU_FAST=1`` round-to-nearest-bf16 grade while halving the
    weight traffic; all other slots keep their dtype."""
    slots = weight_slots(circuit)
    return {
        k: (v.detach().to(torch.bfloat16) if k in slots else v) for k, v in store.items()
    }


class _Program(nn.Module):
    """The traced function of an export: the circuit's forward or its
    masked (integrate) forward, the store an argument."""

    def __init__(self, circuit: TorchCircuit, query: str):
        super().__init__()
        self.circuit = circuit
        self.query = query

    def forward(self, store, x, mask=None):
        if self.query == "integrate":
            from cirkit_tpu_torch.backend.torch.queries import masked_evaluate

            return masked_evaluate(self.circuit, store, x, mask)
        return self.circuit.evaluate(store, x)


def _tracing_device(x: torch.Tensor, platforms: str | Sequence[str] | None) -> torch.device:
    """The device the artifact is traced on: that of ``x`` (and the store and
    circuit), which ``platforms`` may only name."""
    if platforms is None:
        return x.device
    names = (platforms,) if isinstance(platforms, str) else tuple(platforms)
    if len(names) != 1 or names[0] not in ("cpu", "cuda"):
        raise ValueError(
            f"platforms={platforms!r}: the port traces an artifact on one device, 'cpu' or "
            "'cuda' (it is not lowered for several platforms as a StableHLO artifact is)"
        )
    if names[0] != x.device.type:
        raise ValueError(
            f"platforms={platforms!r}: x, the store and the circuit are on {x.device}; an "
            "artifact is traced where they are"
        )
    return x.device


def export_circuit(
    circuit: TorchCircuit,
    x: torch.Tensor,
    *,
    store: Store,
    query: str = "evaluate",
    platforms: str | Sequence[str] | None = None,
) -> bytes:
    """Serialize the circuit's forward as a ``torch.export`` artifact
    (``torch.export.save``, as bytes), replayable on new parameter stores of
    the same shapes: the store is an argument, not a constant, so artifacts
    stay small and checkpoint swaps need no re-export.

    ``query="evaluate"`` exports ``(store, x) -> (B, O, K)`` log-densities;
    ``query="integrate"`` exports ``(store, x, mask) -> (B, O, K)``
    per-sample marginals (:func:`~.queries.masked_evaluate`, the mask a (B,
    D) boolean tensor). ``x`` fixes the batch shape and dtype, and the speed
    mode (``CIRKIT_TPU_FAST``) is the one set while tracing.

    ``platforms`` may only name the tracing device, ``"cpu"`` or ``"cuda"``
    (that of ``x``, the store and the circuit). An artifact traced on CUDA
    embeds the ``cirkit_tpu_torch::`` kernel ops, as a TPU-traced JAX artifact
    embeds Mosaic kernels: loading it needs ``cirkit_tpu_torch.ops`` imported
    (and the card). One traced on the CPU holds only PyTorch's own ops and
    loads in any process with ``torch``."""
    if query not in _QUERIES:
        raise ValueError(f"Unknown query to export: {query!r}")
    device = _tracing_device(x, platforms)
    restricted = {k: v.detach() for k, v in circuit.restrict_store(store).items()}
    args: tuple = (restricted, x)
    if query == "integrate":
        args += (torch.zeros(x.shape[:2], dtype=torch.bool, device=device),)
    # the store bound by a pipeline context is a submodule of the circuit:
    # unbound while tracing, or the artifact would carry it as parameters
    bound, circuit.default_store = circuit.default_store, None
    try:
        with torch.no_grad():
            exported = torch.export.export(_Program(circuit, query), args)
    finally:
        circuit.default_store = bound
    return _saved(exported)


def _saved(exported: torch.export.ExportedProgram) -> bytes:
    """``torch.export.save`` to bytes, without the example inputs it would
    otherwise carry (here the whole store)."""
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def load_exported(data: bytes):
    """Rehydrate an :func:`export_circuit` artifact into a callable with the
    exported signature (``(store, x)`` or ``(store, x, mask)``). A CPU-traced
    artifact loads in any process with ``torch``; a CUDA-traced one needs
    ``cirkit_tpu_torch.ops`` imported first (its kernel ops)."""
    return torch.export.load(io.BytesIO(data)).module()
