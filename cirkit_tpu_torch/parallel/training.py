"""Maximum-likelihood training of a compiled circuit, on one device or
data-parallel over a ``torch.distributed`` device mesh.

The counterpart of ``cirkit_tpu/parallel/training.py`` (``default_mesh``,
``replicate_store``, ``shard_batch``, the ZeRO-1 placements, ``Preempted``
and the SIGTERM guard, ``data_parallel_step``, ``evaluate_ll``,
``split_trainable`` and ``fit``). The step runs eagerly: autograd through
the plan, with the log-einsum-exp backward kernels on CUDA tensors, then a
``torch.optim.Optimizer`` step that updates the trainable tensors in place.

With a ``mesh`` every rank holds the parameters replicated and its own rows
of each batch (:func:`shard_batch`); the gradients are averaged over the
mesh ``axis`` before the optimizer runs, so the ranks stay identical, and
the loss returned is the global one. ``zero1=True`` shards the optimizer
state instead: a slot whose leading (fold) axis divides the axis size is
updated by each rank on its own fold slice (the gradients reduce-scattered
onto the slices, the fresh slices all-gathered into the replicated slots);
every other slot's state stays replicated. The collectives run on
``mesh.get_group(axis)``: NCCL on a CUDA mesh from :func:`default_mesh`,
gloo on the CPU meshes of the tests.

Missing-data training (``missing``, ``marginalize_missing``) marginalizes
the missing entries through ``queries.masked_evaluate``, per rank.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Iterable, Mapping
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.queries import masked_evaluate
from cirkit_tpu_torch.parallel.mesh import (
    all_reduce,
    all_reduce_flat,
    axis_rank,
    axis_size,
    check_mesh,
    local_rows,
    mesh_device,
    tree_map,
)
from cirkit_tpu_torch.utils.checkpoint import (
    data_fingerprint,
    load_training_state,
    place_replicated,
    save_training_state,
)

Store = Mapping[str, torch.Tensor]
OptimizerFactory = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


def default_mesh(num_devices: int | None = None, axis: str = "data") -> Any:
    """A 1-D CUDA device mesh over the process group's ranks, one card each
    (the rank's ``LOCAL_RANK``), named ``axis``.

    Under ``torchrun --nproc-per-node=N`` the process group is the launcher's;
    with none up, one process gets a one-rank NCCL group of its own, and a
    mesh of more than one device raises. ``num_devices`` must be the world
    size when given. There is no CPU fallback: a CPU mesh is the caller's
    ``init_device_mesh("cpu", ...)`` over a gloo group."""
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_mesh builds a CUDA mesh and finds no CUDA device; build a CPU mesh "
            'explicitly with init_device_mesh("cpu", ...) over a gloo process group'
        )
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise RuntimeError(
                f"No process group is up for a mesh of {num_devices} devices: launch with "
                f"torchrun --nproc-per-node={num_devices}, or call "
                "torch.distributed.init_process_group first"
            )
        dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"A mesh of {num_devices} devices needs a world of that size, "
                         f"found {world} ranks")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count()
    torch.cuda.set_device(local)
    return init_device_mesh("cuda", (world,), mesh_dim_names=(axis,))


def replicate_store(store: Store, mesh: Any) -> dict[str, torch.Tensor]:
    """Copies of the store's tensors on the mesh's device, each holding the
    values of the mesh's first rank (broadcast over every axis). Always
    copies, so a training step's in-place update never writes the caller's
    store."""
    check_mesh(mesh)
    dev = mesh_device(mesh)
    out = {k: v.detach().to(dev, copy=True) for k, v in store.items()}
    for axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
        for t in out.values():
            dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return out


def shard_batch(x: Any, mesh: Any, axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch (the leading axis split in equal
    contiguous blocks over the mesh ``axis``, in rank order), as a tensor on
    the mesh's device."""
    check_mesh(mesh)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return local_rows(x, mesh, axis).to(mesh_device(mesh))


def zero1_state_shardings(opt_state: Any, mesh: Any, *, axis: str = "data") -> Any:
    """The ZeRO-1 placement of an optimizer-state tree (slot name -> state
    name -> tensor): 0 (shard the leading, fold axis over the mesh ``axis``)
    for every tensor leaf whose leading axis divides the axis size, None
    (replicated) for the others and for scalars."""
    check_mesh(mesh)
    n = axis_size(mesh, axis)
    return tree_map(
        lambda leaf: 0 if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] % n == 0 else None,
        opt_state,
    )


def shard_opt_state_zero1(opt_state: Any, mesh: Any, *, axis: str = "data") -> Any:
    """This rank's part of a full optimizer-state tree under the ZeRO-1
    placement of :func:`zero1_state_shardings` (copies of the fold slices;
    the replicated leaves as they are)."""
    specs = zero1_state_shardings(opt_state, mesh, axis=axis)
    return tree_map(
        lambda leaf, spec: leaf if spec is None else local_rows(leaf, mesh, axis).clone(),
        opt_state, specs,
    )


class Zero1:
    """The ZeRO-1 half of a step over one set of trainable tensors: this
    rank's fold slices of the slots whose leading axis divides the axis size
    (tensors of their own, which the optimizer keys its state by), the
    replicated tensors of the others, and the optimizer over both in the
    trainable tensors' order (so ``adam_lowmem`` keeps the leaf numbering of
    the unsharded parameter list). A slice carries ``zero1_rows = (rows of
    the full slot, first row)``, by which ``adam_lowmem`` draws the full
    slot's rounding bits and keeps its rows."""

    def __init__(self, factory: OptimizerFactory, trainable: Mapping[str, torch.Tensor],
                 mesh: Any, axis: str):
        self.mesh, self.axis = mesh, axis
        self.names = list(trainable)
        self.trainable = dict(trainable)
        n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        self.sharded = {k for k, t in trainable.items() if t.dim() >= 1 and t.shape[0] % n == 0}
        self.params: list[torch.Tensor] = []
        for k in self.names:
            t = trainable[k]
            if k in self.sharded:
                p = local_rows(t.detach(), mesh, axis).clone()
                p.zero1_rows = (t.shape[0], r * p.shape[0])
            else:
                p = t
            self.params.append(p)
        self.optimizer = factory(self.params)

    @torch.no_grad()
    def step(self) -> None:
        """Average the trainable tensors' gradients over the axis onto the
        slices (reduce-scatter) and the replicated slots (all-reduce), step
        the optimizer, and all-gather the fresh slices into the slots."""
        n = axis_size(self.mesh, self.axis)
        group = self.mesh.get_group(self.axis)
        replicated = []
        for k, p in zip(self.names, self.params):
            g = self.trainable[k].grad
            if k in self.sharded:
                out = torch.empty_like(p)
                dist.reduce_scatter_tensor(out, g.contiguous(), group=group)
                p.grad = out.div_(n)
            elif g is not None:
                replicated.append(g)
        all_reduce_flat(replicated, self.mesh, self.axis)
        for g in replicated:
            g.div_(n)
        self.optimizer.step()
        for k, p in zip(self.names, self.params):
            if k in self.sharded:
                dist.all_gather_into_tensor(self.trainable[k], p, group=group)

    def sharded_state(self) -> dict[str, dict]:
        """The optimizer state by slot name, the slices' state wrapped as
        ``DTensor``s sharded on dim 0 over the axis (replicated over the
        other axes), for :func:`~cirkit_tpu_torch.utils.checkpoint.save_checkpoint`."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        placements = [Shard(0) if a == self.axis else Replicate()
                      for a in self.mesh.mesh_dim_names]
        state = _optimizer_state(self.optimizer, self.names)
        return {
            k: {key: DTensor.from_local(v, self.mesh, placements, run_check=False)
                if k in self.sharded and v.dim() >= 1 else v
                for key, v in st.items()}
            for k, st in state.items()
        }


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
    optimizer: torch.optim.Optimizer | OptimizerFactory,
    *,
    mesh: Any = None,
    axis: str = "data",
    loss_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    weighted: bool = False,
    zero1: bool = False,
    marginalize_missing: bool = False,
    cache_token: str | None = None,
) -> Callable:
    """Build a training step, on one device or data-parallel over ``mesh``.

    The step takes ``(trainable, frozen, batch)``, then a per-sample weight
    vector ``(B,)`` when ``weighted=True``, then a (B, D) boolean mask of
    MISSING entries when ``marginalize_missing=True``. ``trainable`` are
    the tensors ``optimizer`` holds: the step evaluates the circuit on
    ``{**trainable, **frozen}``, back-propagates the loss, runs the
    optimizer (which updates ``trainable`` in place) and returns the loss as
    a 0-d tensor on the device. ``frozen`` tensors must not require grad, so
    their gradients are never computed.

    The default loss is the mean negative log-likelihood of the circuit's
    (B, O, K) output; with ``weighted=True`` it is the weighted NLL
    ``-sum(w ll) / sum(w)``, which is how :func:`fit` trains a zero-padded
    final partial batch. With ``marginalize_missing=True`` the loss is the
    marginal NLL: the masked variables are summed out at their input layers
    (``masked_evaluate``), so an incomplete row trains on exactly its
    observed margin. ``loss_fn`` maps the output to a scalar instead.

    With a ``mesh`` the batch, the weights and the mask are this rank's rows
    (:func:`shard_batch`) and the parameters are replicated
    (:func:`replicate_store`). The step averages the gradients over the mesh
    ``axis`` before the optimizer runs and returns the global loss: the mean
    of the ranks' losses, or, weighted, ``-sum(w ll) / sum(w)`` over every
    rank's rows (the weights' sum is reduced first, so padding that sits on
    some ranks only weighs as on one device). A ``loss_fn`` is applied to
    each rank's rows and averaged, which is the global loss for a mean over
    rows.

    ``zero1=True`` (requires a mesh) takes ``optimizer`` as a factory from a
    list of tensors to a ``torch.optim.Optimizer`` and shards its state over
    ``axis`` (ZeRO-1, :class:`Zero1`): at the first call it is built over
    this rank's fold slices of the trainable tensors. The step's ``zero1``
    attribute holds that state from then on.

    ``cache_token`` is accepted and ignored: in the JAX package it opts a
    single-device step into the warm-compile cache, whose job (a second
    process that pays no compile) the kernel library's build directory, keyed
    on a hash of the sources, already does here; a step runs eagerly.
    """
    del cache_token
    if weighted and loss_fn is not None:
        raise ValueError("weighted=True supports only the default NLL loss")
    if marginalize_missing and loss_fn is not None:
        raise ValueError("marginalize_missing=True supports only the default NLL loss")
    if mesh is None and zero1:
        raise ValueError("zero1=True requires a device mesh")
    if mesh is not None:
        check_mesh(mesh)
    if zero1 and isinstance(optimizer, torch.optim.Optimizer):
        raise TypeError("zero1=True builds the optimizer over this rank's slices: pass a "
                        "factory from a list of tensors to a torch.optim.Optimizer")
    n = 1 if mesh is None else axis_size(mesh, axis)

    def step(trainable: Store, frozen: Store, batch: torch.Tensor, *args) -> torch.Tensor:
        if len(args) != int(weighted) + int(marginalize_missing):
            raise TypeError("pass per-sample weights exactly when the step is weighted, "
                            "then the missing mask exactly when it marginalizes")
        weights = args[0] if weighted else None
        missing = args[-1] if marginalize_missing else None
        if zero1:
            if step.zero1 is None:
                step.zero1 = Zero1(optimizer, trainable, mesh, axis)
            for t in trainable.values():  # the optimizer holds the slices
                t.grad = None
        else:
            optimizer.zero_grad(set_to_none=True)
        store = {**trainable, **frozen}
        if missing is None:
            ll = circuit.evaluate(store, batch)
        else:
            ll = masked_evaluate(circuit, store, batch, missing)
        if loss_fn is not None:
            loss = loss_fn(ll)
        elif weights is None:
            loss = -ll.mean()
        else:
            per_sample = ll.reshape(ll.shape[0], -1).mean(dim=1)
            total = weights.sum()
            if mesh is not None:
                total = all_reduce(total.detach().clone(), mesh, axis)
            # tiny epsilon (not 1.0): fractional weight sums < 1 must still
            # give sum(w*ll)/sum(w); an all-padding batch stays 0. On a mesh
            # this rank's share of the global loss: the shares sum to it
            loss = -(per_sample * weights).sum() / total.clamp_min(1e-12) * n
        loss.backward()
        if zero1:
            step.zero1.step()
        else:
            if mesh is not None:
                grads = [t.grad for t in trainable.values() if t.grad is not None]
                all_reduce_flat(grads, mesh, axis)
                for g in grads:
                    g.div_(n)
            optimizer.step()
        loss = loss.detach()
        if mesh is not None:
            loss = all_reduce(loss.clone(), mesh, axis).div_(n)
        return loss

    step.zero1 = None
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
    ``batch_size`` without gradients. On one device the last batch is
    partial; with a ``mesh`` every batch is zero-padded to ``batch_size``
    with zero weights, each rank evaluates its rows of it with the store of
    the mesh's first rank, and the weighted sums are reduced over ``axis``."""
    store = circuit.restrict_store(_bound_store(circuit, store))
    data = np.asarray(data)
    if mesh is None:
        device = _device(store)
        data = torch.as_tensor(data)
        total = 0.0
        with torch.no_grad():
            for i in range(0, len(data), batch_size):
                ll = circuit.evaluate(store, data[i : i + batch_size].to(device))
                total += float(ll.reshape(ll.shape[0], -1).mean(dim=1).sum())
        return total / len(data)
    check_mesh(mesh)
    if batch_size % mesh.size() != 0:
        raise ValueError("The batch size must divide evenly across the mesh devices")
    store = replicate_store(store, mesh)
    dtype = next(iter(store.values())).dtype
    total = torch.zeros((), dtype=torch.float64, device=mesh_device(mesh))
    with torch.no_grad():
        for i in range(0, len(data), batch_size):
            batch = data[i : i + batch_size]
            weights = np.ones(batch_size, np.float32)
            if len(batch) < batch_size:
                weights[len(batch) :] = 0.0
                pad = np.zeros((batch_size - len(batch), *batch.shape[1:]), batch.dtype)
                batch = np.concatenate([batch, pad])
            ll = circuit.evaluate(store, shard_batch(batch, mesh, axis))
            w = shard_batch(weights, mesh, axis).to(dtype)
            total += (ll.reshape(ll.shape[0], -1).mean(dim=1) * w).sum().double()
    return float(all_reduce(total, mesh, axis)) / len(data)


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

    ``missing`` trains on incomplete data by missing-data MLE: ``"nan"``
    (float data, NaN entries are missing) or a sentinel value (e.g. ``-1``
    for categorical data). Missing entries are marginalized out of each
    sample's likelihood at its input layers, with no imputation; the losses
    are then mean marginal NLLs.

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

    With a ``mesh`` (a ``torch.distributed`` DeviceMesh: :func:`default_mesh`
    under ``torchrun``) every rank calls ``fit`` with the same arguments: the
    store is replicated from the mesh's first rank, every rank replays the
    same batch schedule from ``seed`` and trains on its rows of each batch
    (``batch_size`` must divide over the mesh's devices), and the gradients
    are averaged over ``axis``, so every rank ends with the same store and
    the losses are the global ones (:func:`data_parallel_step`). Only the
    mesh's first rank writes the checkpoint, then the ranks meet at a
    barrier; on resume every rank reads it (:func:`place_replicated`).
    """
    if (checkpoint_every is not None or resume) and checkpoint_path is None:
        raise ValueError("checkpoint_every/resume require checkpoint_path")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731
    store = _bound_store(circuit, store)
    data = np.asarray(data)
    if mesh is not None:
        check_mesh(mesh)
        if batch_size % mesh.size() != 0:
            raise ValueError("The batch size must divide evenly across the mesh devices")
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
    names = sorted(trainable)
    if mesh is None:  # copies: the step updates them in place
        trainable = {k: trainable[k].detach().clone().requires_grad_(True) for k in names}
        frozen = {k: v.detach() for k, v in frozen.items()}
        device = _device(store)
    else:
        trainable = {k: v.requires_grad_(True)
                     for k, v in replicate_store({k: trainable[k] for k in names}, mesh).items()}
        frozen = replicate_store(frozen, mesh)
        device = mesh_device(mesh)
    writer = mesh is None or dist.get_rank() == 0
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
            placed = place_replicated(restored["trainable"], mesh)
            with torch.no_grad():
                for k in names:
                    trainable[k].copy_(placed[k])
            _load_optimizer_state(opt, names, restored.get("opt_state", {}))

    # A dataset smaller than one batch is itself a "partial batch": pad and
    # weight it like a trailing one instead of silently training zero steps.
    remainder = len(data) % batch_size
    weighted = remainder != 0 or sample_weight is not None
    if isinstance(missing, float) and np.isnan(missing):
        missing = "nan"  # the float spelling of NaN
    if isinstance(missing, str) and missing == "nan":
        if not np.issubdtype(data.dtype, np.floating):
            raise ValueError('missing="nan" requires floating-point data')
        miss_all = np.isnan(data)
        data = np.nan_to_num(data, nan=0.0)
    elif missing is not None:
        miss_all = data == missing
        data = np.where(miss_all, np.zeros((), data.dtype), data)
    else:
        miss_all = None
    step = data_parallel_step(circuit, opt, mesh=mesh, axis=axis, weighted=weighted,
                              marginalize_missing=miss_all is not None)
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
        """Yield (epoch, host batch, host weights or None, host missing mask
        or None). The first ``skip`` batches (a resume's completed steps) are
        not materialized; the permutations still replay."""
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
                miss = None if miss_all is None else miss_all[idx]
                yield epoch, data[idx], (weights if weighted else None), miss

    def to_device(a: np.ndarray) -> torch.Tensor:
        if mesh is not None:
            a = local_rows(a, mesh, axis)  # this rank's rows of the global batch
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":  # pinned, so the copy overlaps the step
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def prefetch(item):
        if item is None:
            return None
        extra = [to_device(a) for a in item[2:] if a is not None]
        return item[0], to_device(item[1]), extra

    device_losses: list[torch.Tensor] = []
    step_idx = start_step

    def save_ck():
        losses.extend(float(l) for l in device_losses)
        device_losses.clear()
        state = _optimizer_state(opt, names)
        if writer:
            save_training_state(
                checkpoint_path,
                {
                    "trainable": trainable,
                    "opt_state": state,
                    "step": np.int64(step_idx),
                    "losses": np.asarray(losses, np.float64),
                    "schedule": schedule,
                    "data_fp": data_fp,
                },
            )
        if mesh is not None:
            dist.barrier()

    it = host_batches(skip=start_step)
    pending = prefetch(next(it, None))
    with _PreemptionGuard(checkpoint_every is not None) as guard:
        while pending is not None:
            epoch, batch, extra = pending
            pending = prefetch(next(it, None))
            loss = step(trainable, frozen, batch, *extra)
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
