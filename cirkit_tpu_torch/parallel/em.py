"""Expectation-maximization training for monotonic circuits.

The counterpart of ``cirkit_tpu/parallel/em.py``. EM is the classic PC
parameter estimator (Peharz et al., "Einsum networks", 2020): each sum unit
is a latent mixture, the E-step computes **expected flows** (the expected
number of times each mixture edge is used under the posterior) and the
M-step sets the weights proportional to them.

The E-step is one forward and one backward: for a normalized circuit with
*plain* (unreparameterized) weight tensors, the expected flow of edge
``(o, i)`` over a batch is ``w[o, i] * d/dw[o, i] sum_b log p(x_b)``. On
CUDA tensors the forward and the backward run the log-einsum-exp kernels of
``ops/lse_einsum.py`` with linear weights. The M-step renormalizes the
flows along each unit's mixture axis, so weights stay nonnegative and
normalized: full-batch EM increases the likelihood monotonically.

Requirements, checked when the programs are built:

- sum-style weights (dense, mixing, fused Tucker, CPT) must be **plain
  slots**, or a slot feeding a MixingWeight block-diagonal placement, or a
  MatMul chain of such slots (a collapsed sum chain). Build templates with
  ``Parameterization(activation="none", initialization="dirichlet")`` or
  ``em_ready=True``.
- categorical input layers update when parameterized by plain ``probs``.
- Gaussian input layers update when mean AND stddev are plain slots: the
  unit responsibilities are the gradient of the log-likelihood with respect
  to a zero offset added to each unit's log-output, and the weighted
  sufficient statistics follow in closed form from the mean and stddev
  gradients, with no extra pass.
- Binomial input layers update when parameterized by a plain ``probs`` or
  ``logits`` slot, through the same offset responsibilities.
- other input parameters (embeddings, polynomial coefficients, ...) stay
  fixed: combine EM for the rest with :func:`fit`.

The programs run eagerly, with no compilation cache. With a ``mesh`` (a
``torch.distributed`` DeviceMesh) the parameters are replicated, every rank
takes its rows of each batch, and the flow accumulators and the
log-likelihood sums are reduced (summed) over the mesh ``axis`` in each
flow step, so every rank runs the same M-step.
"""

from __future__ import annotations

import warnings
from collections.abc import Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit, _iter_param_nodes
from cirkit_tpu_torch.backend.torch.layers import (
    TorchBinomialLayer,
    TorchCategoricalLayer,
    TorchGaussianLayer,
    TorchSumLayer,
)
from cirkit_tpu_torch.backend.torch.optimized import (
    TorchCPTLayer,
    TorchTensorDotLayer,
    TorchTuckerLayer,
)
from cirkit_tpu_torch.backend.torch.parameters import (
    TorchMatMulParameter,
    TorchMixingWeightParameter,
    TorchParameter,
    TorchPointerSlot,
    TorchTensorSlot,
)
from cirkit_tpu_torch.backend.torch.queries import offset_module_fn
from cirkit_tpu_torch.parallel.mesh import all_reduce_flat, check_mesh, local_rows
from cirkit_tpu_torch.parallel.training import (
    Preempted,
    _bound_store,
    _device,
    _PreemptionGuard,
    replicate_store,
)
from cirkit_tpu_torch.utils.checkpoint import (
    data_fingerprint,
    load_training_state,
    place_replicated,
    save_training_state,
)

Store = Mapping[str, torch.Tensor]

# Store reads inside a weight graph: a slot's own tensor, or a pointer to a
# slot allocated elsewhere (parameter sharing). Flows computed as ``theta *
# dLL/dtheta`` on the underlying store entry are exact through any pointer
# gather (a 0/1-linear map whose per-use partials autograd adds up), so EM
# on a derived circuit trains the shared parameters.
_SLOT_READS = (TorchTensorSlot, TorchPointerSlot)


def _flow_slot(param: TorchParameter) -> str | None:
    """The store slot behind a weight, if the parameter graph keeps the flow
    identity ``flows = theta * dLL/dtheta``: a bare slot read, or a slot
    feeding a MixingWeight 0/1 placement."""
    nodes = list(param.topological_ordering())
    if len(nodes) == 1 and isinstance(nodes[0], _SLOT_READS):
        return nodes[0].slot
    if (
        len(nodes) == 2
        and isinstance(nodes[0], _SLOT_READS)
        and isinstance(nodes[1], TorchMixingWeightParameter)
    ):
        return nodes[0].slot
    return None


# weight-graph ops that keep the circuit output multilinear in every slot's
# rows: each output monomial holds one entry per slot, so the flow identity
# holds for each slot on its own
_FLOW_LINEAR_OPS = (TorchMixingWeightParameter, TorchMatMulParameter)


def _flow_slots(param: TorchParameter) -> list[str]:
    """Every store slot of a sum-style weight graph for which the flow
    identity holds: a graph of slots, each read once, MixingWeight
    placements and MatMul nodes (the compiled form of a collapsed sum
    chain, ``W = W1 @ MW(W2)``, linear in each factor's rows), so the
    per-slot renormalized M-step is EM on the uncollapsed latent chain."""
    nodes = list(param.topological_ordering())
    slots = [n for n in nodes if isinstance(n, _SLOT_READS)]
    ops = [n for n in nodes if not isinstance(n, _SLOT_READS)]
    if not slots or len({n.slot for n in slots}) != len(slots):
        return []
    if all(isinstance(n, _FLOW_LINEAR_OPS) for n in ops):
        return [n.slot for n in slots]
    return []


def _slot_read_counts(circuit: TorchCircuit) -> dict[str, int]:
    """How many weight-graph reads each store slot has across the circuit
    (tensor slots and pointers), the leaves evidence layers wrap included."""
    counts: dict[str, int] = {}
    for layer in circuit.layers:
        for n in _iter_param_nodes(layer):
            if isinstance(n, _SLOT_READS):
                counts[n.slot] = counts.get(n.slot, 0) + 1
    return counts


def _leaf_slot(
    param: TorchParameter, read_counts: dict[str, int], store: Store | None = None
) -> str | None:
    """The slot behind a Gaussian or Binomial leaf parameter when the
    closed-form per-layer M-step can address it: a bare read whose layer
    folds align 1:1 with the slot folds (a tensor slot, or a pointer with a
    full identity fold map; with a ``store``, a prefix-identity subset read
    is rejected too) and which no other layer reads. The per-layer offset
    counts pair elementwise with the slot-fold gradients, so a permuted,
    partial or shared read would misalign or double-count them."""
    nodes = list(param.topological_ordering())
    if len(nodes) != 1:
        return None
    n = nodes[0]
    if isinstance(n, TorchPointerSlot):
        idx = n.fold_idx
        if idx is not None:
            if not np.array_equal(idx, np.arange(len(idx))):
                return None
            if store is not None and store[n.slot].shape[0] != len(idx):
                return None
    elif not isinstance(n, TorchTensorSlot):
        return None
    if read_counts.get(n.slot, 0) > 1:
        return None
    return n.slot


def em_slots(circuit: TorchCircuit) -> dict[str, str]:
    """The EM-updatable slots of a compiled circuit: ``slot -> kind``
    (``"sum"`` or ``"categorical"``). Raises if a sum-style layer's weight is
    reparameterized. Non-learnable slots (``ConstantParameter``) stay
    fixed, as ``fit()``'s ``learnable_slots`` contract has it."""
    learnable = circuit.learnable_slots
    slots: dict[str, str] = {}
    shared_fixed = 0
    for layer in circuit.layers:
        if isinstance(layer, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer,
                              TorchTensorDotLayer)):
            layer_slots = [
                n.slot
                for p in layer.params.values()
                for n in p.topological_ordering()
                if isinstance(n, _SLOT_READS)
            ]
            if not any(s in learnable for s in layer_slots):
                continue  # entirely frozen (ConstantParameter): fixed by intent
            found = _flow_slots(layer.weight)
            if not found:
                if not any(isinstance(n, TorchTensorSlot) for n in layer.weight.nodes):
                    # every read points into an operand circuit and the graph is
                    # reparameterized (e.g. softmax weights trained by fit()):
                    # the flow identity does not hold, so the shared layer stays
                    # fixed
                    shared_fixed += 1
                    continue
                raise ValueError(
                    f"EM requires plain weight tensors, but a {type(layer).__name__} "
                    "weight is reparameterized; build the circuit with "
                    'Parameterization(activation="none", initialization="dirichlet")'
                )
            for slot in found:
                if slot in learnable:
                    slots[slot] = "sum"
        elif isinstance(layer, TorchCategoricalLayer) and layer.probs is not None:
            slot = _flow_slot(layer.probs)
            if slot is not None and slot in learnable:
                slots[slot] = "categorical"
    if shared_fixed:
        warnings.warn(
            f"fit_em: {shared_fixed} sum-style layer(s) share REPARAMETERIZED "
            "weights with an operand circuit (pointer reads, e.g. softmax "
            "weights trained by fit()) — they stay fixed under EM; only "
            "plain (em_ready) parameters train",
            stacklevel=3,
        )
    if not slots and not gaussian_em_layers(circuit) and not binomial_em_layers(circuit):
        raise ValueError("The circuit has no EM-updatable parameters")
    return slots


def gaussian_em_layers(
    circuit: TorchCircuit, store: Store | None = None
) -> list[tuple[int, TorchGaussianLayer, str, str]]:
    """Gaussian input layers whose mean AND stddev are plain learnable
    slots, as ``(layer_index, layer, mean_slot, stddev_slot)``; others stay
    fixed. A ``store`` also rejects partial (prefix-identity) pointer
    reads."""
    learnable = circuit.learnable_slots
    counts = _slot_read_counts(circuit)
    out = []
    for i, layer in enumerate(circuit.layers):
        if not isinstance(layer, TorchGaussianLayer) or layer.log_partition is not None:
            continue
        mean_slot = _leaf_slot(layer.mean, counts, store)
        std_slot = _leaf_slot(layer.stddev, counts, store)
        if mean_slot in learnable and std_slot in learnable:
            out.append((i, layer, mean_slot, std_slot))
    return out


def binomial_em_layers(
    circuit: TorchCircuit, store: Store | None = None
) -> list[tuple[int, TorchBinomialLayer, str, str]]:
    """Binomial input layers with a plain learnable ``probs`` or ``logits``
    slot, as ``(layer_index, layer, slot, kind)`` with kind ``"probs"`` or
    ``"logits"``. A ``store`` also rejects partial pointer reads."""
    learnable = circuit.learnable_slots
    counts = _slot_read_counts(circuit)
    out = []
    for i, layer in enumerate(circuit.layers):
        if not isinstance(layer, TorchBinomialLayer):
            continue
        kind = "probs" if layer.probs is not None else "logits"
        slot = _leaf_slot(layer.params[kind], counts, store)
        if slot in learnable:
            out.append((i, layer, slot, kind))
    return out


def em_programs(
    circuit: TorchCircuit,
    store: Store,
    *,
    pseudocount: float = 1e-6,
    strict: bool = False,
    mesh=None,
    axis: str = "data",
    missing: bool = False,
):
    """The E-step and M-step behind :func:`fit_em`, for custom training
    loops and benchmarks.

    Returns ``(flow_step, em_update, state)``, where ``state`` holds the
    partitioned parameters (``em_params``, ``gauss_params``: the Gaussian
    and Binomial leaf slots), the ``frozen`` rest, the restricted ``store``
    and a ``zero_acc()`` factory of fresh flow accumulators. Drive it as::

        acc, acc_ll = state["zero_acc"](), torch.zeros((), dtype=..., device=...)
        acc, acc_ll = flow_step(em_params, gauss_params, acc, acc_ll, batch, weights)
        em_params, gauss_params = em_update(em_params, gauss_params, acc, step_size)

    ``weights`` is a per-sample (B,) weight vector (0 masks a padding row).
    ``flow_step`` adds into the accumulators ``acc`` in place and returns
    them with the new ``acc_ll``; ``em_update`` returns new tensors.

    With ``missing=True``, ``flow_step`` takes a trailing (B, D) boolean mask
    of missing entries and computes the flows of the marginal likelihood:
    exact EM for missing-at-random data. A missing entry's input layer
    contributes its integral, so the Gaussian and Binomial statistics impute
    the current moments with responsibility weight r, while a normalized
    categorical leaf contributes a constant: its update uses the observed
    entries only, and rows with no evidence keep their distribution.

    With a ``mesh`` the parameters are replicated from the mesh's first rank,
    ``batch``, ``weights`` and the mask are this rank's rows, and
    ``flow_step`` sums the flows and the log-likelihood over the mesh
    ``axis`` before it adds them, so the accumulators are the global ones on
    every rank.
    """
    store = dict(circuit.restrict_store(store))
    if mesh is not None:
        check_mesh(mesh)
        store = replicate_store(store, mesh)
    slots = em_slots(circuit)
    gauss = gaussian_em_layers(circuit, store)
    binom = binomial_em_layers(circuit, store)
    leaf_types = (TorchCategoricalLayer, TorchGaussianLayer, TorchBinomialLayer)
    learnable = circuit.learnable_slots

    def _leaf_learnable(layer) -> bool:
        """False when every slot behind the leaf is frozen: the leaf staying
        fixed is then by construction."""
        return any(
            n.slot in learnable
            for p in layer.params.values()
            for n in p.topological_ordering()
            if isinstance(n, _SLOT_READS)
        )

    has_leaves = any(isinstance(l, leaf_types) and _leaf_learnable(l) for l in circuit.layers)
    leaves_updatable = bool(gauss) or bool(binom) or "categorical" in slots.values()
    if has_leaves and not leaves_updatable:
        msg = (
            "fit_em: the circuit has input leaves but none are EM-updatable "
            "(their parameters are reparameterized, e.g. the default "
            "ScaledSigmoid Gaussian stddev) — only sum weights will train. "
            "Build the template with em_ready=True (or plain leaf parameter "
            "slots) to train the leaves; strict=True turns this into an error."
        )
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, stacklevel=3)
    leaf_slots = {s for _, _, ms, ss in gauss for s in (ms, ss)}
    leaf_slots |= {s for _, _, s, _ in binom}
    em_params = {k: store[k].detach() for k in slots}
    gauss_params = {k: store[k].detach() for k in leaf_slots}
    frozen = {k: v.detach() for k, v in store.items() if k not in slots and k not in leaf_slots}
    ref = next(iter(store.values()))

    # zero offsets added to each EM leaf layer's log-output: their gradient
    # is the layer's expected unit count S0 (the E-step responsibilities)
    off_layers = [(i, layer) for i, layer, _, _ in gauss] + [(i, layer) for i, layer, _, _ in binom]
    off_name = {id(layer): f"__off{i}" for i, layer in off_layers}
    off_shapes = {
        f"__off{i}": (layer.num_folds, 1, layer.num_output_units) for i, layer in off_layers
    }

    def _zeros(shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=ref.dtype, device=ref.device)

    def _flow_step(em_p, g_p, acc, acc_ll, batch, weights, miss=None):
        batch = torch.as_tensor(batch, device=ref.device)
        weights = torch.as_tensor(weights, device=ref.device)
        p = {k: v.detach().requires_grad_() for k, v in em_p.items()}
        gp = {k: v.detach().requires_grad_() for k, v in g_p.items()}
        off = {k: _zeros(s).requires_grad_() for k, s in off_shapes.items()}
        if miss is not None:
            miss = torch.as_tensor(miss, device=ref.device)
        module_fn = None
        if off or miss is not None:
            module_fn = offset_module_fn({i: off[name] for i, name in off_name.items()}, miss)
        ll = circuit.evaluate({**p, **gp, **frozen}, batch, module_fn=module_fn)
        total = (ll.reshape(ll.shape[0], -1).sum(dim=1) * weights).sum()
        inputs = [*p.values(), *gp.values(), *off.values()]
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
        total = total.detach()
        if mesh is not None:
            # an input the graph does not reach is unused on every rank alike
            total = total.reshape(1)
            all_reduce_flat([g for g in grads if g is not None] + [total], mesh, axis)
            total = total[0]
        flows, acc_g, acc_o = acc
        with torch.no_grad():
            # an input the graph does not reach has gradient 0, as in JAX
            for k, g in zip([*p, *gp, *off], grads):
                if g is None:
                    continue
                if k in p:
                    flows[k].addcmul_(p[k], g)
                elif k in gp:
                    acc_g[k].add_(g)
                else:
                    acc_o[k].add_(g)
        return acc, acc_ll + total

    if missing:
        flow_step = _flow_step
    else:
        def flow_step(em_p, g_p, acc, acc_ll, batch, weights):
            return _flow_step(em_p, g_p, acc, acc_ll, batch, weights)

    @torch.no_grad()
    def em_update(em_p, g_p, acc, step_size):
        flows, acc_g, acc_o = acc
        s = float(step_size)

        def upd(p, f):
            # rows with ~zero total flow carry no evidence (dead units, or a
            # fully-missing variable under missing-data EM): keep the current
            # distribution instead of resetting to the pseudocount uniform
            tot = f.sum(dim=-1, keepdim=True)
            k = f.shape[-1]
            target = f.add(pseudocount).div_(tot + k * pseudocount)
            target = torch.where(tot > 1e-6, target, p)
            # (1 - s) p + s target, with two slot-sized tensors live at most
            return target.mul_(s).add_((1.0 - s) * p)

        new_em = {k: upd(v, flows[k]) for k, v in em_p.items()}
        new_g = dict(g_p)
        for i, _, mean_slot, std_slot in gauss:
            mu, sd = g_p[mean_slot], g_p[std_slot]
            s0 = acc_o[f"__off{i}"][:, 0, :]  # (F, K) expected counts
            g_mu, g_sd = acc_g[mean_slot], acc_g[std_slot]
            ok = s0 > 1e-6
            s0s = torch.where(ok, s0, 1.0)
            # the weighted sufficient statistics from the gradients:
            # g_mu = S1' / sd^2 with S1' = sum r (x - mu);
            # g_sd = sum r (x - mu)^2 / sd^3 - S0 / sd
            mu_t = mu + sd * sd * g_mu / s0s
            sum_sq = sd**3 * g_sd + sd * sd * s0
            var_t = (sum_sq - s0 * torch.square(mu_t - mu)) / s0s
            sd_t = torch.sqrt(torch.clamp_min(var_t, 1e-8))
            new_g[mean_slot] = torch.where(ok, (1.0 - s) * mu + s * mu_t, mu)
            new_g[std_slot] = torch.where(ok, (1.0 - s) * sd + s * sd_t, sd)
        for i, layer, slot, kind in binom:
            n = layer.total_count
            s0 = acc_o[f"__off{i}"][:, 0, :]
            g = acc_g[slot]
            ok = s0 > 1e-6
            s0s = torch.where(ok, s0, 1.0)
            theta = g_p[slot]
            if kind == "logits":
                # d log pmf / dtheta = k - n sigmoid(theta):
                # sum r k = g + n p S0, so p' = p + g / (n S0)
                p0 = torch.sigmoid(theta)
                p_t = p0 + g / (n * s0s)
            else:
                # d log pmf / dp = k/p - (n-k)/(1-p):
                # sum r k = p(1-p) g + n p S0, so p' = p + p(1-p) g / (n S0)
                p0 = theta
                p_t = p0 + p0 * (1.0 - p0) * g / (n * s0s)
            p_t = torch.clamp(p_t, 1e-7, 1.0 - 1e-7)
            p_n = torch.where(ok, (1.0 - s) * p0 + s * p_t, p0)
            new_g[slot] = torch.log(p_n) - torch.log1p(-p_n) if kind == "logits" else p_n
        return new_em, new_g

    def zero_acc():
        return (
            {k: torch.zeros_like(v) for k, v in em_params.items()},
            {k: torch.zeros_like(v) for k, v in gauss_params.items()},
            {k: _zeros(s) for k, s in off_shapes.items()},
        )

    state = {
        "em_params": em_params,
        "gauss_params": gauss_params,
        "frozen": frozen,
        "zero_acc": zero_acc,
        "store": store,
    }
    return flow_step, em_update, state


def fit_em(
    circuit: TorchCircuit,
    data: np.ndarray | torch.Tensor,
    *,
    store: Store | None = None,
    num_epochs: int = 1,
    batch_size: int = 1024,
    step_size: float | str | Callable[[int], float] = 1.0,
    update_every: str = "epoch",
    pseudocount: float = 1e-6,
    shuffle: bool = False,
    strict: bool = False,
    seed: int = 0,
    mesh=None,
    axis: str = "data",
    missing: str | float | int | None = None,
    sample_weight: np.ndarray | None = None,
    checkpoint_every: int | None = None,
    checkpoint_path: str | None = None,
    resume: bool = False,
) -> tuple[dict[str, torch.Tensor], list[float]]:
    """Train a circuit by (mini-batch) EM.

    Per epoch: accumulate the expected flows over all batches (one forward
    and one backward each, no optimizer state), then set every EM slot to
    the renormalized flows, interpolated with the previous weights when
    ``step_size < 1`` (damped EM). ``step_size=1.0`` is exact full-dataset
    EM, which increases the train log-likelihood monotonically.

    ``update_every="batch"`` runs **online (mini-batch) EM**: the M-step
    follows every batch, on that batch's flows, damped by ``step_size``.
    ``step_size`` may also be a schedule: ``"robbins-monro"`` (the decay
    ``(t + 2) ** -0.75``) or a callable ``t -> float`` of the 0-based M-step
    counter.

    Input leaves update only when their parameter slots are plain (see the
    module docstring); build templates with ``em_ready=True``. When the
    circuit has input leaves but none are EM-updatable, a warning is
    emitted (sum weights still train); ``strict=True`` raises instead.

    ``missing`` runs EM over incomplete data: ``"nan"`` (float data; a NaN
    float value is accepted too) or a sentinel value (e.g. ``-1`` for
    categorical data). Missing entries are marginalized per sample, and the
    E-step runs on the marginal likelihood (see :func:`em_programs`).

    ``sample_weight`` (length ``len(data)``, nonnegative) runs weighted EM:
    the flows are gradients of ``sum_i w_i log p(x_i)``, so integer weights
    reproduce EM on the replicated dataset. The losses become
    weight-normalized mean NLLs.

    Shuffling draws one permutation per epoch with ``torch.randperm`` from a
    ``torch.Generator`` seeded with ``seed`` (the JAX package takes a
    ``key``; the permutations differ).

    ``checkpoint_every=N`` writes an atomic checkpoint (EM parameters,
    epoch and M-step counters, losses) to ``checkpoint_path`` every N
    epochs; ``resume=True`` restores it if present and continues with the
    next epoch, so a resumed run reproduces the uninterrupted one. SIGTERM
    or SIGINT during a checkpointing run writes a checkpoint after the epoch
    and raises :class:`Preempted`.

    Returns the updated store and the mean train NLL per epoch, and binds
    the new store as ``circuit.default_store``. With ``update_every="epoch"``
    each loss is measured under the weights before that epoch's update.

    With a ``mesh`` every rank calls ``fit_em`` with the same arguments: the
    parameters are replicated, each rank takes its rows of every batch
    (``batch_size`` must divide over the mesh's devices), and the flows are
    summed over ``axis`` (:func:`em_programs`), so every rank holds the same
    store. Only the mesh's first rank writes the checkpoint, then the ranks
    meet at a barrier.
    """
    store = _bound_store(circuit, store)
    if mesh is not None:
        check_mesh(mesh)
        if batch_size % mesh.size() != 0:
            raise ValueError("The batch size must divide evenly across the mesh devices")
    if update_every not in ("epoch", "batch"):
        raise ValueError(f"update_every must be 'epoch' or 'batch', got {update_every!r}")
    if (checkpoint_every is not None or resume) and checkpoint_path is None:
        raise ValueError("checkpoint_every/resume require checkpoint_path")
    if checkpoint_every is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if callable(step_size):
        schedule = step_size
    elif isinstance(step_size, str):
        if step_size != "robbins-monro":
            raise ValueError(f"Unknown step-size schedule {step_size!r}")
        schedule = lambda t: (t + 2.0) ** -0.75  # noqa: E731
    else:
        schedule = None

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
        ck_schedule = np.asarray([len(data), batch_size, int(shuffle)], np.int64)
        ck_data_fp = data_fingerprint(data)
        if sample_weight is not None:
            # resume must replay the same weighted objective
            ck_data_fp = ck_data_fp ^ data_fingerprint(sample_weight)
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

    flow_step, em_update, state = em_programs(
        circuit, store, pseudocount=pseudocount, strict=strict, mesh=mesh, axis=axis,
        missing=miss_all is not None,
    )
    em_params, gauss_params = state["em_params"], state["gauss_params"]
    store, zero_acc = state["store"], state["zero_acc"]
    device = _device(store)
    dtype = next(iter(store.values())).dtype

    num_batches = -(-len(data) // batch_size)
    total_weight = (
        float(len(data)) if sample_weight is None
        else max(float(np.sum(sample_weight, dtype=np.float64)), 1e-30)
    )
    losses: list[float] = []
    m_steps = 0
    start_epoch = 0
    if resume:
        restored = load_training_state(
            checkpoint_path,
            like={
                "em_params": em_params,
                "gauss_params": gauss_params,
                "epoch": np.int64(0),
                "m_steps": np.int64(0),
                "losses": np.zeros(0),
                "schedule": ck_schedule,
                "data_fp": ck_data_fp,
            },
        )
        if restored is not None:
            if not np.array_equal(restored["schedule"], ck_schedule) or int(
                restored["data_fp"]
            ) != int(ck_data_fp):
                raise ValueError(
                    "Checkpoint was written for a different run: exact resume "
                    "replays the original batch schedule, so data, batch_size "
                    f"and shuffle must match (saved len/batch/shuffle="
                    f"{restored['schedule'].tolist()}, this run={ck_schedule.tolist()})"
                )
            start_epoch = int(restored["epoch"])
            m_steps = int(restored["m_steps"])
            losses = [float(v) for v in np.asarray(restored["losses"]).ravel()]
            if start_epoch > num_epochs:
                raise ValueError(
                    f"Checkpoint at epoch {start_epoch} is beyond this run's "
                    f"{num_epochs} epochs — resume with the same (or more) epochs"
                )
            em_params = place_replicated(restored["em_params"], mesh)
            gauss_params = place_replicated(restored["gauss_params"], mesh)

    def current_step_size() -> float:
        return step_size if schedule is None else schedule(m_steps)

    def save_ck(done_epochs: int) -> None:
        if mesh is None or dist.get_rank() == 0:
            save_training_state(
                checkpoint_path,
                {
                    "em_params": em_params,
                    "gauss_params": gauss_params,
                    "epoch": np.int64(done_epochs),
                    "m_steps": np.int64(m_steps),
                    "losses": np.asarray(losses, np.float64),
                    "schedule": ck_schedule,
                    "data_fp": ck_data_fp,
                },
            )
        if mesh is not None:
            dist.barrier()

    def to_device(a: np.ndarray) -> torch.Tensor:
        if mesh is not None:
            a = local_rows(a, mesh, axis)  # this rank's rows of the global batch
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    gen = torch.Generator().manual_seed(seed)
    with _PreemptionGuard(checkpoint_every is not None) as guard:
        for epoch in range(num_epochs):
            # draw every epoch's permutation, so resumed epochs see the ones
            # the uninterrupted run saw
            perm = torch.randperm(len(data), generator=gen).numpy() if shuffle else None
            if epoch < start_epoch:
                continue
            if perm is None:
                perm = np.arange(len(data))
            acc = zero_acc()
            acc_ll = torch.zeros((), dtype=dtype, device=device)
            for b in range(num_batches):
                idx = perm[b * batch_size : (b + 1) * batch_size]
                weights = np.zeros(batch_size, np.float32)
                weights[: len(idx)] = 1.0 if sample_weight is None else sample_weight[idx]
                if len(idx) < batch_size:
                    # zero-pad the final partial batch; pad rows carry weight 0
                    idx = np.concatenate([idx, np.zeros(batch_size - len(idx), idx.dtype)])
                args = [to_device(data[idx]), to_device(weights)]
                if miss_all is not None:
                    args.append(to_device(miss_all[idx]))
                if update_every == "batch":
                    acc = zero_acc()
                acc, acc_ll = flow_step(em_params, gauss_params, acc, acc_ll, *args)
                if update_every == "batch":
                    em_params, gauss_params = em_update(
                        em_params, gauss_params, acc, current_step_size()
                    )
                    m_steps += 1
            if update_every == "epoch":
                em_params, gauss_params = em_update(
                    em_params, gauss_params, acc, current_step_size()
                )
                m_steps += 1
            losses.append(-float(acc_ll) / total_weight)
            if guard.flag is not None:
                save_ck(epoch + 1)
                raise Preempted(
                    f"fit_em() caught signal {guard.flag} after epoch {epoch + 1}; "
                    f"checkpoint written to {checkpoint_path}: rerun with resume=True "
                    "to continue"
                )
            if checkpoint_every is not None and (epoch + 1) % checkpoint_every == 0:
                save_ck(epoch + 1)

    new_store = {**store, **em_params, **gauss_params}
    learnable = circuit.learnable_slots
    bound = {**(circuit.default_store or {}), **new_store}
    circuit.default_store = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(v.detach(), requires_grad=k in learnable) for k, v in bound.items()}
    )
    return new_store, losses
