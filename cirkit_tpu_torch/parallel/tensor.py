"""Tensor-parallel circuit evaluation: model parallelism over the unit axis.

The counterpart of ``cirkit_tpu/parallel/tensor.py``. Every layer's
*output-unit* axis is sharded over a ``model`` mesh axis (sum, CPT and
Tucker weights split by output unit, input layers by unit) while the
contractions' *input*-unit axes stay full through an all-gather of the
(small) activations: "shard the big tensor, gather the small one".

Arrays are local tensors: a rank's store holds its unit shard of each
sharded slot (:func:`shard_store_tp`), so the log-einsum-exp kernels run
unchanged on local shapes (the K=64 Tucker flagship's entries at O = 32 on
two ranks). The gather is one ``torch.autograd.Function``
(:class:`_GatherUnits`): forward an all-gather along the last axis, backward
a reduce-scatter of the upstream gradient onto the local units. Every model
rank evaluates a full replica of the loss, so that reduce-scatter sums
``num_shards`` equal contributions: sharded slots divide their gradients by
``num_shards``, replicated slots average theirs over ``model``, and
everything averages over ``data`` (:func:`tp_train_step`).

Sharding is per slot and conservative: a slot is sharded only when its unit
axis divides the model-axis size and its consuming parameter graph provably
keeps the unit axis (entrywise reparameterizations and the last-axis
softmax); everything else (mixing weights, Kronecker-structured graphs,
tensor-dot weights) stays replicated. The decisions are host logic, equal
to the JAX package's.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.layers import (
    TorchBinomialLayer,
    TorchCategoricalLayer,
    TorchConstantInputLayer,
    TorchEmbeddingLayer,
    TorchGaussianLayer,
    TorchHadamardLayer,
    TorchInputLayer,
    TorchKroneckerLayer,
    TorchSumLayer,
    tmap,
)
from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
from cirkit_tpu_torch.backend.torch.parameters import (
    TorchParameter,
    TorchSoftmaxParameter,
    TorchTensorSlot,
    _EntrywiseOp,
)
from cirkit_tpu_torch.parallel.mesh import (
    all_reduce,
    axis_rank,
    axis_size,
    check_mesh,
    gather_units,
    has_axis,
    local_rows,
    require_axis,
    scatter_units,
)

Store = dict[str, torch.Tensor]


def _unit_shardable_slot(param: TorchParameter, num_shards: int) -> str | None:
    """The slot name if ``param`` is a unit-axis-preserving graph over a
    single tensor slot whose axis 1 divides over ``num_shards``, else None."""
    slot = None
    for node in param.topological_ordering():
        if isinstance(node, TorchTensorSlot):
            if slot is not None:
                return None
            slot = node
        elif isinstance(node, _EntrywiseOp):
            continue
        elif isinstance(node, TorchSoftmaxParameter):
            # softmax over the trailing (input) axis keeps units independent
            if node.axis != len(node.shape) - 1:
                return None
        else:
            return None
    if slot is None or len(slot.shape) < 1:
        return None
    if slot.shape[0] % num_shards != 0 or slot.shape[0] // num_shards < 1:
        return None
    return slot.slot


def tp_slot_specs(circuit: TorchCircuit, num_shards: int) -> dict[str, int]:
    """Map slot name -> array axis to shard (always 1: the per-fold unit
    axis) for every slot this circuit can shard over ``num_shards`` model
    ranks. Unlisted slots stay replicated."""
    specs: dict[str, int] = {}
    for layer in circuit.layers:
        params: list[TorchParameter] = []
        if isinstance(layer, (TorchSumLayer, TorchCPTLayer)) or (
            isinstance(layer, TorchTuckerLayer) and layer.arity == 2
        ):
            if layer.num_output_units % num_shards == 0:
                params.append(layer.weight)
        elif isinstance(layer, (TorchCategoricalLayer, TorchBinomialLayer)):
            params.append(layer.probs if layer.logits is None else layer.logits)
        elif isinstance(layer, TorchGaussianLayer):
            params.extend([layer.mean, layer.stddev])
            if layer.log_partition is not None:
                params.append(layer.log_partition)
        elif isinstance(layer, TorchEmbeddingLayer):
            params.append(layer.weight)
        if isinstance(layer, TorchInputLayer) and layer.num_output_units % num_shards:
            continue
        if isinstance(layer, TorchGaussianLayer) and not all(
            _unit_shardable_slot(p, num_shards) for p in params
        ):
            continue  # mean and stddev shard together
        for p in params:
            slot = _unit_shardable_slot(p, num_shards)
            if slot is not None:
                specs[slot] = 1
    return specs


def _layer_sharded(layer, slot_specs: dict[str, int]) -> bool:
    """Whether the layer's own parameters are unit-sharded."""
    if isinstance(layer, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer)):
        slots = layer.weight.tensor_slots()
        return len(slots) == 1 and slots[0].slot in slot_specs
    if isinstance(layer, TorchInputLayer) and not isinstance(layer, TorchConstantInputLayer):
        for p in layer.params.values():
            slots = p.tensor_slots()
            if not (len(slots) == 1 and slots[0].slot in slot_specs):
                return False
        return bool(layer.params)
    return False


def _plan_flags(circuit: TorchCircuit, slot_specs: dict[str, int]) -> list[bool]:
    """Per plan entry: is the entry's output unit-sharded?"""
    flags: list[bool] = []
    for entry in circuit._entries:
        layer = entry.layer
        if isinstance(layer, TorchHadamardLayer):
            # elementwise over units: sharded iff every input is sharded
            flags.append(bool(entry.in_ids) and all(flags[i] for i in entry.in_ids))
        elif isinstance(layer, TorchKroneckerLayer):
            flags.append(False)  # K^2 outputs mix unit shards
        else:
            flags.append(_layer_sharded(layer, slot_specs))
    return flags


def tp_routing_descriptor(circuit: TorchCircuit, mesh: Any, *,
                          model_axis: str = "model") -> tuple[TPRouting, dict[str, int | None]]:
    """The ``queries.TPRouting`` of the circuit on ``mesh`` (the static
    descriptor that lets the MAP and conditional-sampling routing run on the
    ranks' unit shards) and the per-slot shard specs of
    :func:`shard_store_tp`'s placement (1, the unit axis, or None,
    replicated) of every used slot."""
    from cirkit_tpu_torch.backend.torch.queries import TPRouting

    check_mesh(mesh)
    require_axis(mesh, model_axis)
    num_shards = axis_size(mesh, model_axis)
    slot_specs = tp_slot_specs(circuit, num_shards)
    flags = tuple(_layer_sharded(entry.layer, slot_specs) for entry in circuit._entries)
    specs = {name: slot_specs.get(name) for name in circuit.used_slots if name in circuit.slots}
    return TPRouting(mesh, model_axis, num_shards, axis_rank(mesh, model_axis), flags), specs


def _local_shard(t: torch.Tensor, mesh: Any, model_axis: str) -> torch.Tensor:
    """This rank's unit shard (axis 1) of a full slot tensor."""
    return local_rows(t.transpose(0, 1), mesh, model_axis).transpose(0, 1)


def shard_store_tp(circuit: TorchCircuit, store: Store, mesh: Any, *,
                   model_axis: str = "model") -> tuple[Store, dict[str, int | None]]:
    """This rank's store with unit-sharded weights (copies of its shards of
    the slots of :func:`tp_slot_specs`, the other slots as they are), and
    the per-slot specs (1: the unit axis is sharded; None: replicated)."""
    check_mesh(mesh)
    require_axis(mesh, model_axis)
    slot_specs = tp_slot_specs(circuit, axis_size(mesh, model_axis))
    out: Store = {}
    specs: dict[str, int | None] = {}
    for name, value in store.items():
        specs[name] = slot_specs.get(name)
        out[name] = (_local_shard(value, mesh, model_axis).contiguous().clone()
                     if name in slot_specs else value)
    return out, specs


def localize_store(circuit: TorchCircuit, store: Store, mesh: Any,
                   model_axis: str = "model") -> Store:
    """``store`` with every sharded slot at this rank's width: a slot that
    holds the full unit axis is cut to this rank's shard, a local shard (a
    store from :func:`shard_store_tp`) is kept."""
    n = axis_size(mesh, model_axis)
    slot_specs = tp_slot_specs(circuit, n)
    return {
        k: _local_shard(v, mesh, model_axis).contiguous()
        if k in slot_specs and n > 1 and v.shape[1] == circuit.slots[k].shape[0] else v
        for k, v in store.items()
    }


class _GatherUnits(torch.autograd.Function):
    """All-gather of the last (unit) axis over the model axis; its backward
    reduce-scatters the upstream gradient onto this rank's units."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        return gather_units(a, mesh, axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return scatter_units(g, ctx.mesh, ctx.axis), None, None


def _tp_forward_local(circuit: TorchCircuit, flags: list[bool], mesh: Any, model_axis: str,
                      store: Store, x: torch.Tensor) -> torch.Tensor:
    """The per-rank forward: the plan on local weight shards, the
    activations of a sharded producer gathered over the model axis where a
    contraction needs the full input-unit axis (a Hadamard entry whose
    inputs are all sharded keeps them sharded). Returns the full (B, O, K)
    output of this rank's rows."""
    def gather(y):
        return tmap(lambda a: _GatherUnits.apply(a, mesh, model_axis), y)

    outs: list = []
    full: dict[int, Any] = {}  # a sharded producer's gathered output, by entry

    def whole(j: int):
        if not flags[j]:
            return outs[j]
        if j not in full:
            full[j] = gather(outs[j])
        return full[j]

    for i, entry in enumerate(circuit._entries):
        layer = entry.layer
        if isinstance(layer, TorchInputLayer):
            outs.append(layer(store, circuit.entry_input(entry, x, outs)))
            continue
        keep_sharded = isinstance(layer, TorchHadamardLayer) and flags[i]
        view = {j: outs[j] if keep_sharded else whole(j) for j in entry.in_ids}
        outs.append(layer(store, circuit.entry_input(entry, x, view)))
    final = {j: whole(j) for j in circuit._out_ids}
    return tmap(lambda o: o.transpose(0, 1), circuit.output_stack(final))


def tp_forward(circuit: TorchCircuit, mesh: Any, *, model_axis: str = "model",
               data_axis: str | None = "data") -> Callable[[Store, torch.Tensor], torch.Tensor]:
    """A tensor(+data)-parallel forward ``f(store, x)``: ``store`` is this
    rank's (:func:`shard_store_tp`), ``x`` this rank's rows of the batch
    (split over ``data_axis`` when the mesh has it), and the result the full
    (B, O, K) output of those rows."""
    check_mesh(mesh)
    require_axis(mesh, model_axis)
    flags = _plan_flags(circuit, tp_slot_specs(circuit, axis_size(mesh, model_axis)))

    def fn(store: Store, x: torch.Tensor) -> torch.Tensor:
        return _tp_forward_local(circuit, flags, mesh, model_axis, store, x)

    return fn


def tp_train_step(
    circuit: TorchCircuit,
    optimizer: torch.optim.Optimizer,
    mesh: Any,
    *,
    model_axis: str = "model",
    data_axis: str = "data",
    loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> Callable:
    """A TP x DP training step ``(trainable, frozen, batch) -> loss``: the
    port's step shape. ``trainable`` and ``frozen`` are this rank's stores
    (:func:`shard_store_tp`), ``trainable`` the local tensors ``optimizer``
    holds, ``batch`` this rank's rows over ``data_axis``. The gradients of
    sharded slots are divided by the shard count (the gathers' backward sums
    as many equal contributions), those of replicated slots averaged over
    ``model_axis``, then everything is averaged over ``data_axis``; the
    optimizer steps the local shards, and the loss returned is the mean over
    ``data_axis``."""
    if loss_fn is None:
        loss_fn = lambda ll: -ll.mean()  # noqa: E731
    check_mesh(mesh)
    require_axis(mesh, model_axis)
    num_shards = axis_size(mesh, model_axis)
    data_size = axis_size(mesh, data_axis)
    slot_specs = tp_slot_specs(circuit, num_shards)
    flags = _plan_flags(circuit, slot_specs)

    def step(trainable: Store, frozen: Store, batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        ll = _tp_forward_local(circuit, flags, mesh, model_axis, {**trainable, **frozen}, batch)
        loss = loss_fn(ll)
        loss.backward()
        with torch.no_grad():
            for k, t in trainable.items():
                if t.grad is None:
                    continue
                if k in slot_specs:
                    t.grad.div_(num_shards)
                else:
                    all_reduce(t.grad, mesh, model_axis).div_(num_shards)
                if has_axis(mesh, data_axis):
                    all_reduce(t.grad, mesh, data_axis).div_(data_size)
        optimizer.step()
        return all_reduce(loss.detach().clone(), mesh, data_axis).div_(data_size)

    return step
