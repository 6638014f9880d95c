"""Maximum-likelihood training of a compiled circuit on one device.

The counterpart of ``cirkit_tpu/parallel/training.py`` (``Preempted`` and
the SIGTERM guard, ``data_parallel_step``, ``evaluate_ll``,
``split_trainable`` and ``fit``). The step runs eagerly: autograd through
the plan, with the log-einsum-exp backward kernels on CUDA tensors, then a
``torch.optim.Optimizer`` step that updates the trainable tensors in place.

Distribution over several devices (``mesh``, ``zero1``, ``axis``) waits for
ROADMAP module queue item 12, and missing-data training (``missing``,
``marginalize_missing``) for the port of ``masked_evaluate`` in item 6:
those arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.utils.checkpoint import (
    data_fingerprint,
    load_training_state,
    save_training_state,
)

Store = Mapping[str, torch.Tensor]
OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]

_DISTRIBUTED = "training over a device mesh (mesh, zero1, axis) waits for ROADMAP item 12"
_MISSING = "missing-data training waits for masked_evaluate (ROADMAP item 6)"


def _single_device(mesh: Any, axis: str, zero1: bool = False) -> None:
    if mesh is not None or zero1 or axis != "data":
        raise NotImplementedError(_DISTRIBUTED)


class Preempted(RuntimeError):
    """Raised by a checkpointing trainer after it caught SIGTERM/SIGINT and
    wrote a final checkpoint: the run can be resumed with ``resume=True``."""


class _PreemptionGuard:
    """While active (and in the main thread), SIGTERM/SIGINT set a flag the
    training loop polls instead of killing the process mid-step. Previous
    handlers are restored on exit; a second signal (while flagged) falls
    through to the previous handler so a stuck run can still be killed."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.flag: Any = None
        self._previous: list = []

    def __enter__(self) -> "_PreemptionGuard":
        if not self.enabled:
            return self
        import signal

        def handler(signum, frame):
            if self.flag is not None:  # second signal: don't swallow it
                prev = dict(self._previous).get(signum)
                if callable(prev):
                    prev(signum, frame)
                    return
                raise KeyboardInterrupt
            self.flag = signum

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous.append((sig, signal.signal(sig, handler)))
            except ValueError:  # not the main thread: run unguarded
                pass
        return self

    def __exit__(self, *exc) -> None:
        import signal

        for sig, prev in self._previous:
            signal.signal(sig, prev)


def data_parallel_step(
    circuit: TorchCircuit,
    optimizer: torch.optim.Optimizer,
    *,
    mesh: Any = None,
    axis: str = "data",
    loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    weighted: bool = False,
    zero1: bool = False,
    marginalize_missing: bool = False,
) -> Callable:
    """Build a training step on one device.

    The step takes ``(trainable, frozen, batch)``, and a per-sample weight
    vector ``(B,)`` after the batch when ``weighted=True``. ``trainable`` are
    the tensors ``optimizer`` holds: the step evaluates the circuit on
    ``{**trainable, **frozen}``, back-propagates the loss, runs the
    optimizer (which updates ``trainable`` in place) and returns the loss as
    a 0-d tensor on the device. ``frozen`` tensors must not require grad, so
    their gradients are never computed.

    The default loss is the mean negative log-likelihood of the circuit's
    (B, O, K) output; with ``weighted=True`` it is the weighted NLL
    ``-sum(w ll) / sum(w)``, which is how :func:`fit` trains a zero-padded
    final partial batch. ``loss_fn`` maps the output to a scalar instead.
    """
    _single_device(mesh, axis, zero1)
    if marginalize_missing:
        raise NotImplementedError(_MISSING)
    if weighted and loss_fn is not None:
        raise ValueError("weighted=True supports only the default NLL loss")

    def step(trainable: Store, frozen: Store, batch: torch.Tensor,
             weights: torch.Tensor | None = None) -> torch.Tensor:
        if (weights is not None) != weighted:
            raise TypeError("pass per-sample weights exactly when the step is weighted")
        optimizer.zero_grad(set_to_none=True)
        ll = circuit.evaluate({**trainable, **frozen}, batch)
        if loss_fn is not None:
            loss = loss_fn(ll)
        elif weights is None:
            loss = -ll.mean()
        else:
            per_sample = ll.reshape(ll.shape[0], -1).mean(dim=1)
            # tiny epsilon (not 1.0): fractional weight sums < 1 must still
            # give sum(w*ll)/sum(w); an all-padding batch stays 0
            loss = -(per_sample * weights).sum() / weights.sum().clamp_min(1e-12)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _bound_store(circuit: TorchCircuit, store: Store | None) -> Store:
    if store is None:
        store = circuit.default_store
        if store is None:
            raise ValueError("No parameter store bound; pass store=...")
    return store


def _device(store: Store) -> torch.device:
    return next(iter(store.values())).device


def evaluate_ll(
    circuit: TorchCircuit,
    data: np.ndarray | torch.Tensor,
    *,
    store: Store | None = None,
    batch_size: int = 512,
    mesh: Any = None,
    axis: str = "data",
) -> float:
    """Mean log-likelihood of a dataset, evaluated in batches of
    ``batch_size`` (the last one partial) without gradients."""
    _single_device(mesh, axis)
    store = circuit.restrict_store(_bound_store(circuit, store))
    device = _device(store)
    data = torch.as_tensor(np.asarray(data))
    total = 0.0
    with torch.no_grad():
        for i in range(0, len(data), batch_size):
            ll = circuit.evaluate(store, data[i : i + batch_size].to(device))
            total += float(ll.reshape(ll.shape[0], -1).mean(dim=1).sum())
    return total / len(data)


def split_trainable(
    circuit: TorchCircuit,
    store: Store,
    freeze: str | Iterable[str] | None = None,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Split a store into (trainable, frozen) according to the circuit spec.

    ``freeze`` keeps extra slots fixed: an iterable of slot names, or the
    string ``"shared"`` for every learnable slot the circuit only POINTS
    at (parameter sharing with operand circuits)."""
    learnable = set(circuit.learnable_slots)
    if freeze is not None:
        if isinstance(freeze, str):
            if freeze != "shared":
                raise ValueError(f"freeze must be 'shared' or slot names, got {freeze!r}")
            learnable -= circuit.shared_learnable_slots
        else:
            learnable -= set(freeze)
    used = set(circuit.used_slots)
    trainable = {k: v for k, v in store.items() if k in learnable and k in used}
    frozen = {k: v for k, v in store.items() if k in used and k not in learnable}
    return trainable, frozen


def _optimizer_state(opt: torch.optim.Optimizer, names: list[str]) -> dict[str, dict]:
    """The optimizer's per-parameter state keyed by slot name."""
    return {names[i]: state for i, state in opt.state_dict()["state"].items()}


def _load_optimizer_state(
    opt: torch.optim.Optimizer, names: list[str], saved: Mapping[str, Mapping]
) -> None:
    state_dict = opt.state_dict()
    state_dict["state"] = {
        i: {k: torch.as_tensor(v) for k, v in saved[name].items()}
        for i, name in enumerate(names)
        if name in saved
    }
    opt.load_state_dict(state_dict)


def fit(
    circuit: TorchCircuit,
    data: np.ndarray | torch.Tensor,
    *,
    store: Store | None = None,
    num_epochs: int = 1,
    batch_size: int = 256,
    optimizer: OptimizerFactory | None = None,
    mesh: Any = None,
    axis: str = "data",
    seed: int = 0,
    shuffle: bool = True,
    callback: Callable[[int, int, float], Any] | None = None,
    missing: str | float | int | None = None,
    sample_weight: np.ndarray | None = None,
    freeze: str | Iterable[str] | None = None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
) -> tuple[dict[str, torch.Tensor], list[float]]:
    """Maximum-likelihood training of a compiled circuit.

    Trains copies of the store's trainable slots (default store: the one
    the pipeline context bound, ``circuit.default_store``) on the store's
    device, returns the updated full store and the per-step losses, and
    binds the new store as ``circuit.default_store``. ``freeze`` keeps extra
    learnable slots fixed: slot names, or ``"shared"`` for every slot the
    circuit only points at through an operand circuit.

    ``optimizer`` is a factory from the list of trainable tensors to a
    ``torch.optim.Optimizer``; the default is ``torch.optim.Adam(ps,
    lr=1e-2)``, whose update is ``optax.adam``'s (eps outside the square root
    of the bias-corrected second moment). ``parallel.adam_lowmem(lr)`` is the
    bf16-state variant.

    A trailing partial batch is zero-padded to the batch size and trained
    with per-sample weights (so is a dataset smaller than one batch), so
    every sample contributes exactly once per epoch. ``sample_weight``
    (length ``len(data)``, nonnegative) optimizes the weighted likelihood
    ``sum_i w_i log p(x_i)``: each step's loss is ``sum w ll / sum w`` over
    its batch. One batch is prefetched to the device while a step runs.

    Shuffling draws one permutation per epoch with ``torch.randperm`` from
    a ``torch.Generator`` seeded with ``seed``; the permutations differ from
    the JAX package's, which draws them from ``key``.

    ``checkpoint_every=N`` writes an atomic training checkpoint (trainable
    tensors, optimizer state, step counter, losses) to ``checkpoint_path``
    every N steps; ``resume=True`` restores it if present and continues
    where the interrupted run stopped. The batch schedule replays from
    ``seed``, so a resumed run reproduces the uninterrupted one (pass the
    same data, batch_size, seed and optimizer). SIGTERM or SIGINT during a
    checkpointing run writes a checkpoint and raises :class:`Preempted`.
    """
    _single_device(mesh, axis)
    if missing is not None:
        raise NotImplementedError(_MISSING)
    if (checkpoint_every is not None or resume) and checkpoint_path is None:
        raise ValueError("checkpoint_every/resume require checkpoint_path")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731
    store = _bound_store(circuit, store)
    data = np.asarray(data)
    if sample_weight is not None:
        sample_weight = np.asarray(sample_weight, np.float32).ravel()
        if sample_weight.shape[0] != len(data):
            raise ValueError(
                f"sample_weight has {sample_weight.shape[0]} entries for {len(data)} samples"
            )
        if np.any(sample_weight < 0) or not np.all(np.isfinite(sample_weight)):
            raise ValueError("sample_weight entries must be finite and >= 0")
    if checkpoint_path is not None:
        schedule = np.asarray([len(data), batch_size, int(shuffle)], np.int64)
        data_fp = data_fingerprint(data)
        if sample_weight is not None:
            # resume must replay the same weighted objective
            data_fp = data_fp ^ data_fingerprint(sample_weight)

    trainable, frozen = split_trainable(circuit, store, freeze)
    device = _device(store)
    names = sorted(trainable)
    trainable = {k: trainable[k].detach().clone().requires_grad_(True) for k in names}
    frozen = {k: v.detach() for k, v in frozen.items()}
    opt = optimizer([trainable[k] for k in names])

    start_step = 0
    losses: list[float] = []
    if resume:
        restored = load_training_state(checkpoint_path)
        if restored is not None:
            saved_schedule = np.asarray(restored["schedule"])
            if not np.array_equal(saved_schedule, schedule) or int(
                restored["data_fp"]
            ) != int(data_fp):
                raise ValueError(
                    "Checkpoint was written for a different run: exact resume "
                    "replays the original batch schedule, so data, batch_size "
                    f"and shuffle must match (saved len/batch/shuffle="
                    f"{saved_schedule.tolist()}, this run={schedule.tolist()})"
                )
            start_step = int(restored["step"])
            losses = [float(v) for v in np.asarray(restored["losses"]).ravel()]
            with torch.no_grad():
                for k in names:
                    trainable[k].copy_(torch.as_tensor(restored["trainable"][k]))
            _load_optimizer_state(opt, names, restored.get("opt_state", {}))

    # A dataset smaller than one batch is itself a "partial batch": pad and
    # weight it like a trailing one instead of silently training zero steps.
    remainder = len(data) % batch_size
    weighted = remainder != 0 or sample_weight is not None
    step = data_parallel_step(circuit, opt, weighted=weighted)
    ones = np.ones(batch_size, dtype=np.float32)
    num_batches = -(-len(data) // batch_size) if weighted else len(data) // batch_size
    if start_step > num_epochs * num_batches:
        raise ValueError(
            f"Checkpoint at step {start_step} is beyond this run's "
            f"{num_epochs * num_batches} total steps: resume with the same "
            "(or more) epochs and the same data/batch_size"
        )
    gen = torch.Generator().manual_seed(seed)

    def host_batches(skip: int = 0):
        """Yield (epoch, host batch, host weights or None). The first ``skip``
        batches (a resume's completed steps) are not materialized; the
        permutations still replay."""
        seen = 0
        for epoch in range(num_epochs):
            if shuffle:
                perm = torch.randperm(len(data), generator=gen).numpy()
            else:
                perm = np.arange(len(data))
            for b in range(num_batches):
                seen += 1
                if seen <= skip:
                    continue
                idx = perm[b * batch_size : (b + 1) * batch_size]
                weights = ones if sample_weight is None else sample_weight[idx]
                if len(idx) < batch_size:
                    # zero-pad the final partial batch; pad rows carry weight 0
                    pad = batch_size - len(idx)
                    weights = np.concatenate([weights[: len(idx)], np.zeros(pad, np.float32)])
                    idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                yield epoch, data[idx], (weights if weighted else None)

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":  # pinned, so the copy overlaps the step
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def prefetch(item):
        if item is None:
            return None
        epoch, batch, weights = item
        return epoch, to_device(batch), None if weights is None else to_device(weights)

    device_losses: list[torch.Tensor] = []
    step_idx = start_step

    def save_ck():
        losses.extend(float(l) for l in device_losses)
        device_losses.clear()
        save_training_state(
            checkpoint_path,
            {
                "trainable": trainable,
                "opt_state": _optimizer_state(opt, names),
                "step": np.int64(step_idx),
                "losses": np.asarray(losses, np.float64),
                "schedule": schedule,
                "data_fp": data_fp,
            },
        )

    it = host_batches(skip=start_step)
    pending = prefetch(next(it, None))
    with _PreemptionGuard(checkpoint_every is not None) as guard:
        while pending is not None:
            epoch, batch, weights = pending
            pending = prefetch(next(it, None))
            loss = step(trainable, frozen, batch, weights)
            if callback is not None:
                loss = float(loss)
                losses.append(loss)
                callback(epoch, step_idx, loss)
            else:
                device_losses.append(loss)
            step_idx += 1
            if guard.flag is not None:
                save_ck()
                raise Preempted(
                    f"fit() caught signal {guard.flag} at step {step_idx}; checkpoint "
                    f"written to {checkpoint_path}: rerun with resume=True to continue"
                )
            if (
                checkpoint_every is not None
                and step_idx % checkpoint_every == 0
                and pending is not None  # the final state lands in the return
            ):
                save_ck()
    losses.extend(float(l) for l in device_losses)

    new_store = dict(store)
    new_store.update({k: v.detach() for k, v in trainable.items()})
    learnable = circuit.learnable_slots
    circuit.default_store = nn.ParameterDict(
        {k: nn.Parameter(v.detach(), requires_grad=k in learnable) for k, v in new_store.items()}
    )
    return new_store, losses
