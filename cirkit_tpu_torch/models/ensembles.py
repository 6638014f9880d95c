"""Ensemble learners built on the ``mixture`` operator.

Stagewise **generative boosting** of probabilistic circuits (Rosset &
Segal, "Boosting density estimation", NeurIPS 2002): each stage trains a
fresh component on data reweighted by the current ensemble's *inverse*
density (the functional gradient of the log-likelihood), then a line
search blends it in:

    F_t = (1 - a_t) F_{t-1} + a_t h_t,    w_i  proportional to  1 / F_{t-1}(x_i)

The final model is ONE circuit — :func:`cirkit_tpu_torch.symbolic.functional.
mixture` over the trained components with weights ``a_t prod_{s>t}
(1 - a_s)`` divided by each component's partition function, so the served
ensemble is exactly the normalized stagewise blend and every query
(marginals, MAP, sampling, expectations) applies to it directly.

The counterpart of ``cirkit_tpu/models/ensembles.py``: the components train
through the port's ``fit`` and ``fit_em`` on the context's device, and the
per-sample log-likelihoods, the partition functions, the line search and
the early stop run on the host in float64, as there. ``seed`` takes the
place of the JAX package's ``key`` (see :func:`bag_mixture` and
:func:`boost_mixture` for what it seeds).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.utils.scope import Scope

__all__ = ["BoostResult", "bag_mixture", "boost_mixture"]


@dataclass
class BoostResult:
    """The outcome of :func:`boost_mixture`.

    ``circuit`` is the compiled ensemble (a single component if boosting
    stopped after one stage); ``store`` holds every trained parameter;
    ``components`` are the trained stage circuits; ``weights`` the blend
    coefficients (sum to 1); ``stage_lls`` the eval-set mean log-likelihood
    after each ACCEPTED stage (non-decreasing by construction).
    """

    circuit: object
    store: dict
    components: list
    weights: np.ndarray
    stage_lls: list[float]


def _per_sample_ll(cc, store, data: np.ndarray, batch_size: int) -> np.ndarray:
    """Per-sample NORMALIZED log density: batched forward minus log Z,
    through one static batch shape (zero-padding the tail)."""
    n = len(data)
    b = min(batch_size, n)
    pad = (-n) % b
    padded = np.concatenate([data, data[:pad]]) if pad else data
    device = next(iter(store.values())).device
    outs = []
    with torch.inference_mode():
        for lo in range(0, len(padded), b):
            out = cc(store, torch.as_tensor(padded[lo : lo + b], device=device))
            outs.append(out.reshape(out.shape[0], -1)[:, 0].cpu().numpy())
    ll = np.concatenate(outs)[:n].astype(np.float64)
    return ll - _component_log_z(cc, store, data)


def _train_component(
    cc,
    ctx,
    data: np.ndarray,
    sample_weight,
    stage_seed: int,
    *,
    method: str,
    optimizer,
    num_epochs: int,
    batch_size: int,
    kwargs: dict,
) -> None:
    """Train one ensemble component in-place on ``ctx.parameters``."""
    if method == "adam":
        from cirkit_tpu_torch.parallel import fit

        fit(
            cc,
            data,
            store=ctx.parameters,
            num_epochs=num_epochs,
            batch_size=min(batch_size, len(data)),
            # None: fit's default, torch.optim.Adam(lr=1e-2)
            optimizer=optimizer,
            sample_weight=sample_weight,
            seed=stage_seed,
            **kwargs,
        )
    else:
        from cirkit_tpu_torch.parallel import fit_em

        fit_em(
            cc,
            data,
            store=ctx.parameters,
            num_epochs=num_epochs,
            batch_size=min(batch_size, len(data)),
            sample_weight=sample_weight,
            **kwargs,
        )
    ctx.update_parameters(cc.default_store)


def _check_distinct_slots(cc, seen_slots: set, stage: int) -> None:
    """Reject a component that aliases an earlier component's parameters.

    If ``component_factory`` returns the same symbolic circuit (or circuits
    sharing ``TensorParameter`` objects) across stages, the pipeline compile
    cache points every "component" at the same store slots; each stage then
    overwrites the previous fit and the ensemble silently degenerates to n
    copies of the last component."""
    overlap = set(cc.used_slots) & seen_slots
    if overlap:
        raise ValueError(
            f"ensemble stage {stage} shares parameter slots with an earlier "
            f"component (e.g. {sorted(overlap)[:3]}): component_factory must "
            "build a FRESH symbolic circuit (fresh TensorParameters) per "
            "stage, otherwise later fits overwrite earlier components "
            "through the shared store."
        )
    seen_slots.update(cc.used_slots)


def _normalized_mixture_weights(
    weights: np.ndarray, log_zs: np.ndarray
) -> np.ndarray:
    """``w_i / Z_i`` computed in log space so |log Z| > ~709 cannot overflow
    ``exp`` to inf (silently dropping the component to weight 0) or
    underflow to 0 (inf weight)."""
    w = np.exp(
        np.log(np.asarray(weights, np.float64))
        - np.asarray(log_zs, np.float64)
    )
    if not np.all(np.isfinite(w)) or np.any(w <= 0.0):
        raise ValueError(
            f"non-finite or zero normalized mixture weight (weights="
            f"{np.asarray(weights).tolist()}, log_zs="
            f"{np.asarray(log_zs).tolist()}): a component's partition "
            "function is out of float range; normalize the component "
            "parameters before blending."
        )
    return w


def _component_log_z(cc, store, data: np.ndarray) -> float:
    from cirkit_tpu_torch.backend.torch.queries import IntegrateQuery

    log_z = IntegrateQuery(cc)(data[:1], integrate_vars=Scope(cc.scope), store=store)
    return float(log_z.reshape(-1)[0].double().cpu())


def bag_mixture(
    component_factory: Callable[[int], Circuit],
    data: np.ndarray,
    *,
    ctx=None,
    num_components: int = 4,
    method: str = "adam",
    optimizer=None,
    num_epochs: int = 10,
    batch_size: int = 256,
    train_kwargs: dict | None = None,
    eval_batch_size: int = 1024,
    seed: int = 0,
) -> BoostResult:
    """Bagged density estimation: bootstrap-trained components, one circuit.

    Each component trains on a bootstrap resample of ``data`` realized as
    **multinomial sample weights** (the multiplicity of each row in the
    resample) — no data copies, every stage reuses the same static batch
    shapes. The result is a uniform mixture over the trained components,
    each divided by its partition function, served as ONE circuit via
    :func:`cirkit_tpu_torch.symbolic.functional.mixture` — so the bagged
    model answers every query (marginals, MAP, sampling, expectations)
    directly. Bagging reduces the variance of the density estimate across
    structure/seed draws (Breiman, 1996, applied to density estimation).

    ``component_factory(t)`` returns a fresh symbolic circuit for member
    ``t`` (same scope; vary structure/seed for diversity). ``stage_lls``
    records each member's train-set mean log-likelihood. ``optimizer`` is
    ``fit``'s optimizer factory (default ``torch.optim.Adam(lr=1e-2)``).

    The bootstrap counts are drawn by ``np.random.default_rng([0, seed])``,
    the generator the JAX package seeds from ``PRNGKey(seed)``'s raw bits,
    so they equal its counts for that key; member ``t`` trains with
    ``fit(seed=seed + t)`` (its batch order; ``fit_em`` does not shuffle).
    """
    from cirkit_tpu_torch.pipeline import PipelineContext

    if num_components < 1:
        raise ValueError(f"num_components must be >= 1, found {num_components}")
    if method not in ("adam", "em"):
        raise ValueError(f"method must be 'adam' or 'em', found {method!r}")
    if ctx is None:
        ctx = PipelineContext(semiring="lse-sum", fold=True)
    data = np.asarray(data)
    kwargs = dict(train_kwargs or {})
    n = len(data)
    rng = np.random.default_rng([0, seed])

    components: list = []
    stage_lls: list[float] = []
    seen_slots: set = set()
    for t in range(num_components):
        counts = rng.multinomial(n, np.full(n, 1.0 / n)).astype(np.float64)
        cc = ctx.compile(component_factory(t))
        _check_distinct_slots(cc, seen_slots, t)
        _train_component(
            cc,
            ctx,
            data,
            counts,
            seed + t,
            method=method,
            optimizer=optimizer,
            num_epochs=num_epochs,
            batch_size=batch_size,
            kwargs=kwargs,
        )
        stage_lls.append(
            float(
                _per_sample_ll(cc, ctx.parameters, data, eval_batch_size).mean()
            )
        )
        components.append(cc)

    weights = np.full(len(components), 1.0 / len(components))
    if len(components) == 1:
        mixed = components[0]
    else:
        log_zs = np.asarray(
            [_component_log_z(cc, ctx.parameters, data) for cc in components]
        )
        mixed = ctx.mixture(
            *components,
            weights=_normalized_mixture_weights(weights, log_zs),
        )
    return BoostResult(
        circuit=mixed,
        store=dict(ctx.parameters),
        components=components,
        weights=weights,
        stage_lls=stage_lls,
    )


def boost_mixture(
    component_factory: Callable[[int], Circuit],
    data: np.ndarray,
    *,
    ctx=None,
    num_stages: int = 4,
    method: str = "adam",
    optimizer=None,
    num_epochs: int = 10,
    batch_size: int = 256,
    train_kwargs: dict | None = None,
    alpha_grid: np.ndarray | None = None,
    valid_data: np.ndarray | None = None,
    tol: float = 1e-5,
    weight_clip: float | None = 1e4,
    eval_batch_size: int = 1024,
    seed: int = 0,
) -> BoostResult:
    """Boosted density estimation: a stagewise-trained ensemble circuit.

    ``component_factory(t)`` returns a fresh SYMBOLIC circuit for stage
    ``t`` (same scope every stage; vary the structure or seed for
    diversity). Stages train on ``data`` with per-sample weights
    proportional to ``1 / F_{t-1}(x)`` (clipped at ``weight_clip`` times
    the mean — inverse-density weights are heavy-tailed), using ``method``
    ``"adam"`` (:func:`cirkit_tpu_torch.parallel.fit`; pass ``optimizer``, an
    optimizer factory, or ``train_kwargs``) or ``"em"``
    (:func:`cirkit_tpu_torch.parallel.fit_em`; components must be
    ``em_ready``). The blend coefficient ``a_t`` is an exact line search of
    the eval-set log-likelihood over ``alpha_grid`` (host-side
    ``logaddexp`` of two per-sample vectors); a stage that cannot improve it
    by ``tol`` is discarded and boosting stops early.

    ``valid_data`` drives the line search and early stop (default: the
    training data — then stage LLs are train LLs). Components and the
    final mixture compile into ``ctx`` (default: a fresh lse-sum folded
    context on the CUDA card), so the returned store serves the ensemble
    directly. Stage ``t`` trains with ``fit(seed=seed + t)`` (its batch
    order; ``fit_em`` does not shuffle).

    Reference: Rosset & Segal, NeurIPS 2002. No cirkit counterpart.
    """
    from cirkit_tpu_torch.pipeline import PipelineContext

    if num_stages < 1:
        raise ValueError(f"num_stages must be >= 1, found {num_stages}")
    if method not in ("adam", "em"):
        raise ValueError(f"method must be 'adam' or 'em', found {method!r}")
    if ctx is None:
        ctx = PipelineContext(semiring="lse-sum", fold=True)
    if alpha_grid is None:
        alpha_grid = np.linspace(0.05, 0.95, 19)
    alpha_grid = np.asarray(alpha_grid, np.float64)
    if np.any(alpha_grid <= 0.0) or np.any(alpha_grid >= 1.0):
        raise ValueError("alpha_grid entries must lie strictly inside (0, 1)")
    data = np.asarray(data)
    eval_data = data if valid_data is None else np.asarray(valid_data)
    kwargs = dict(train_kwargs or {})

    def _train(cc, sample_weight, stage_seed):
        _train_component(
            cc,
            ctx,
            data,
            sample_weight,
            stage_seed,
            method=method,
            optimizer=optimizer,
            num_epochs=num_epochs,
            batch_size=batch_size,
            kwargs=kwargs,
        )

    components: list = []
    log_zs: list[float] = []
    weights = np.zeros(0, np.float64)
    lf_train: np.ndarray | None = None  # per-sample log F on the train set
    lf_eval: np.ndarray | None = None
    stage_lls: list[float] = []
    seen_slots: set = set()

    for t in range(num_stages):
        if lf_train is None:
            w = None
        else:
            # functional-gradient weights: w_i proportional to 1/F(x_i)
            # (shift by the min so the largest weight is exp(0) — no overflow)
            w = np.exp(-(lf_train - lf_train.min()))
            w *= len(w) / w.sum()
            if weight_clip is not None:
                w = np.minimum(w, weight_clip)
                w *= len(w) / w.sum()
        cc = ctx.compile(component_factory(t))
        _check_distinct_slots(cc, seen_slots, t)
        _train(cc, w, seed + t)
        lh_eval = _per_sample_ll(cc, ctx.parameters, eval_data, eval_batch_size)

        if lf_eval is None:
            components.append(cc)
            weights = np.array([1.0])
            lf_eval = lh_eval
            lf_train = (
                lh_eval
                if valid_data is None
                else _per_sample_ll(cc, ctx.parameters, data, eval_batch_size)
            )
            stage_lls.append(float(lf_eval.mean()))
            continue

        # exact line search: ll(a) = mean log[(1-a) F + a h] on the eval set
        cand = np.logaddexp(
            lf_eval[None, :] + np.log1p(-alpha_grid)[:, None],
            lh_eval[None, :] + np.log(alpha_grid)[:, None],
        ).mean(axis=1)
        best = int(np.argmax(cand))
        if cand[best] <= stage_lls[-1] + tol:
            break  # the new component cannot improve the blend: discard it
        a = float(alpha_grid[best])
        components.append(cc)
        weights = np.concatenate([weights * (1.0 - a), [a]])
        lf_eval = np.logaddexp(lf_eval + np.log1p(-a), lh_eval + np.log(a))
        if valid_data is None:
            lf_train = lf_eval
        else:
            lh_train = _per_sample_ll(cc, ctx.parameters, data, eval_batch_size)
            lf_train = np.logaddexp(
                lf_train + np.log1p(-a), lh_train + np.log(a)
            )
        stage_lls.append(float(cand[best]))

    # serve the blend as ONE circuit: mixture weights divide by each
    # component's partition function, so the compiled ensemble's raw
    # output IS the normalized stagewise density
    for cc in components:
        log_zs.append(_component_log_z(cc, ctx.parameters, data))
    if len(components) == 1:
        mixed = components[0]
    else:
        mixed = ctx.mixture(
            *components,
            weights=_normalized_mixture_weights(
                weights, np.asarray(log_zs)
            ),
        )
    return BoostResult(
        circuit=mixed,
        store=dict(ctx.parameters),
        components=components,
        weights=weights,
        stage_lls=stage_lls,
    )
