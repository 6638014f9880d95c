"""Rank functions of the port's distributed tests (``test_torch_distributed.py``
and ``test_torch_tensor_parallel.py``), run on gloo CPU ranks by
``cirkit_tpu_torch.parallel.launch.run_ranks``.

A module of its own, imported by the spawned ranks: it imports the port and
never JAX, so a rank starts in seconds. Every function builds the port's
circuit in float64 from the JAX store's arrays that the test passes in, runs
the checks of one mesh and returns plain tensors and numbers; the tests
compare them with JAX and with the port's single-device runs.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from cirkit_tpu_torch.backend.torch.queries import MAPQuery, SamplingQuery
from cirkit_tpu_torch.models import image_data, tabular_data
from cirkit_tpu_torch.parallel import (
    adam_lowmem,
    data_parallel_step,
    em_programs,
    evaluate_ll,
    fit,
    fit_em,
    shard_batch,
    shard_store_tp,
    split_trainable,
    tp_forward,
    tp_train_step,
)
from cirkit_tpu_torch.parallel.mesh import axis_rank, tree_map
from cirkit_tpu_torch.parallel.training import (
    replicate_store,
    shard_opt_state_zero1,
    zero1_state_shardings,
)
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

LR = 1e-2
DP_SPEC = ("image", "quad-graph", "tucker", 4, True, False)
EM_SPEC = ("image", "quad-graph", "cp", 4, True, True)


def circuit(spec, image, tabular):
    """The symbolic circuit of a test spec and whether to optimize it:
    ``("image", region graph, sum-product layer, units, optimize,
    em_ready)``, or ``("gaussian",)``, the 6-feature tabular circuit of
    Gaussian leaves; built with either package's ``image_data`` and
    ``tabular_data``."""
    if spec[0] == "gaussian":
        return tabular("random-binary-tree", num_features=6,
                       input_layers={"name": "gaussian", "args": {}}, num_input_units=8,
                       sum_product_layer="cp", num_sum_units=8), True
    _, rg, sp, units, optimize, em_ready = spec
    return image((1, 4, 4), rg, input_layer="categorical", num_input_units=units,
                 sum_product_layer=sp, num_sum_units=units, em_ready=em_ready), optimize


def port(spec, arrays):
    """The port's compiled circuit of ``spec`` holding ``arrays`` (float64;
    call it under a float64 default type: the port's constants take it)."""
    sc, optimize = circuit(spec, image_data, tabular_data)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize, device="cpu")
    cc = ctx.compile(sc)
    ctx.load_parameters(arrays)
    return ctx, cc


def _trainable(tr):
    return {k: v.detach().clone().requires_grad_(True) for k, v in tr.items()}


def _adam(ps):
    return torch.optim.Adam(ps, lr=LR)


OPTIMIZERS = {
    "adam": _adam,
    "lowmem_f32": adam_lowmem(LR, state_dtype=torch.float32),
    "lowmem_bf16": adam_lowmem(LR),
}


def _run_steps(cc, ctx, mesh, x, opt_name, zero1, steps=3, weights=None, missing=None):
    tr, fr = split_trainable(cc, ctx.parameters)
    tr = _trainable(replicate_store(tr, mesh))
    fr = replicate_store(fr, mesh)
    factory = OPTIMIZERS[opt_name]
    step = data_parallel_step(cc, factory if zero1 else factory(list(tr.values())), mesh=mesh,
                              zero1=zero1, weighted=weights is not None,
                              marginalize_missing=missing is not None)
    extra = [shard_batch(a, mesh) for a in (weights, missing) if a is not None]
    losses = [float(step(tr, fr, shard_batch(x, mesh), *extra)) for _ in range(steps)]
    return losses, {k: v.detach().clone() for k, v in tr.items()}, step


def _halves_reference(cc, ctx, x, n, opt_name, steps=3):
    """The single-device run of the optimizer on the gradient a mesh of
    ``n`` ranks averages: each rank's rows' gradient, summed in rank order
    and divided by ``n``."""
    tr, fr = split_trainable(cc, ctx.parameters)
    tr = _trainable(tr)
    opt = OPTIMIZERS[opt_name](list(tr.values()))
    rows = len(x) // n
    for _ in range(steps):
        total = None
        for r in range(n):
            ll = cc.evaluate({**tr, **fr}, torch.as_tensor(x[r * rows : (r + 1) * rows]))
            g = torch.autograd.grad(-ll.mean(), list(tr.values()))
            total = g if total is None else [a + b for a, b in zip(total, g)]
        for t, g in zip(tr.values(), total):
            t.grad = g / n
        opt.step()
    return {k: v.detach().clone() for k, v in tr.items()}


class _Killed(RuntimeError):
    pass


def _killer(at):
    def callback(epoch, step, loss):
        if step == at:
            raise _Killed
    return callback


def _errors(cc, ctx, mesh, x):
    """The messages of the calls a mesh refuses."""
    out = {}
    for name, call in [
        ("fit", lambda: fit(cc, x, store=dict(ctx.parameters), batch_size=3, mesh=mesh)),
        ("evaluate_ll", lambda: evaluate_ll(cc, x, batch_size=3, mesh=mesh)),
        ("fit_em", lambda: fit_em(cc, x, batch_size=3, mesh=mesh)),
    ]:
        try:
            call()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def dp_checks(rank, arrays, em_arrays, data, ckdir):
    """Data parallelism, ZeRO-1, fit, EM and checkpoints on a 1-D mesh of
    the world's ranks."""
    torch.set_default_dtype(torch.float64)
    world = torch.distributed.get_world_size()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    ctx, cc = port(DP_SPEC, arrays)
    x = data["x"]
    out: dict = {"rank": rank}
    for opt_name in ("adam", "lowmem_f32"):
        for zero1 in (False, True):
            out[f"steps:{opt_name}:{zero1}"] = _run_steps(cc, ctx, mesh, x, opt_name, zero1)[:2]
    losses, tr, step = _run_steps(cc, ctx, mesh, x, "lowmem_bf16", True)
    out["zero1_bf16"] = tr
    out["zero1_local_rows"] = {
        k: [v.shape[0] for v in state.values() if torch.is_tensor(v) and v.dim() >= 1]
        for k, state in zip(step.zero1.names,
                            (step.zero1.optimizer.state[p] for p in step.zero1.params))
    }
    if rank == 0:
        out["zero1_bf16_reference"] = _halves_reference(cc, ctx, x, world, "lowmem_bf16")
    out["weighted"] = _run_steps(cc, ctx, mesh, x, "adam", False, steps=1,
                                 weights=data["weights"])[:2]
    out["missing"] = _run_steps(cc, ctx, mesh, x, "adam", False, steps=1,
                                missing=data["missing"])[:2]
    out["evaluate_ll"] = evaluate_ll(cc, data["eval"], store=dict(ctx.parameters),
                                     batch_size=4, mesh=mesh)

    fit_kw = dict(num_epochs=2, batch_size=4, seed=3, optimizer=_adam)
    store, losses = fit(cc, data["fit"], store=dict(ctx.parameters), mesh=mesh, **fit_kw)
    out["fit"] = (losses, {k: v.detach() for k, v in store.items()})
    store, losses = fit(cc, x, store=dict(ctx.parameters), mesh=mesh, batch_size=len(x),
                        shuffle=False, optimizer=_adam)
    out["fit_one_batch"] = (losses, {k: v.detach() for k, v in store.items()})
    for opt_name in ("adam", "lowmem_bf16"):
        path = os.path.join(ckdir, f"fit_{opt_name}")
        kw = dict(fit_kw, store=dict(ctx.parameters), mesh=mesh,
                  optimizer=OPTIMIZERS[opt_name])
        full = fit(cc, data["fit"], **kw)
        try:
            fit(cc, data["fit"], callback=_killer(4), checkpoint_every=3, checkpoint_path=path,
                **kw)
        except _Killed:
            pass
        resumed = fit(cc, data["fit"], checkpoint_every=3, checkpoint_path=path, resume=True,
                      **kw)
        out[f"resume:{opt_name}"] = (full, resumed)

    em_ctx, em_cc = port(EM_SPEC, em_arrays)
    flow_step, _, state = em_programs(em_cc, em_ctx.parameters, mesh=mesh)
    acc, ll = flow_step(state["em_params"], state["gauss_params"], state["zero_acc"](),
                        torch.zeros(()), shard_batch(data["em"][:8], mesh),
                        shard_batch(np.ones(8), mesh))
    out["em_flows"] = (acc, float(ll))
    store, losses = fit_em(em_cc, data["em"], store=dict(em_ctx.parameters), mesh=mesh,
                           num_epochs=2, batch_size=8, update_every="batch", step_size=0.5)
    out["fit_em"] = (losses, {k: v.detach() for k, v in store.items()})
    out["errors"] = _errors(em_cc, em_ctx, mesh, data["em"])

    # the ZeRO-1 state written by every rank for its slices, with the
    # replicated parameters and a step counter; each rank's parts returned
    state = step.zero1.sharded_state()
    save_checkpoint(os.path.join(ckdir, "dcp"), {"trainable": tr, "opt_state": state,
                                                 "step": 3})
    out["written"] = {"trainable": tr, "opt_state": _local_parts(state)}
    return out


def _local_parts(state):
    from torch.distributed.tensor import DTensor

    return {k: {key: v.to_local() if isinstance(v, DTensor) else v for key, v in st.items()}
            for k, st in state.items()}


def dcp_load(rank, full, ckdir):
    """Read the ZeRO-1 checkpoint of :func:`dp_checks` into this world's
    ZeRO-1 placement (``zero1_state_shardings`` of the ``full`` state read
    at one rank: DTensors sharded on dim 0 where the fold axis divides the
    world, whole tensors elsewhere). Returns the local parts, the restored
    step and ``shard_opt_state_zero1`` of the full state."""
    from torch.distributed.tensor import DTensor, Shard

    world = torch.distributed.get_world_size()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    specs = zero1_state_shardings(full["opt_state"], mesh)

    def place(v, spec):
        if spec is None:
            return torch.zeros_like(v)
        part = torch.zeros_like(v[: v.shape[0] // world])
        return DTensor.from_local(part, mesh, [Shard(0)], run_check=False)

    like = {"trainable": {k: torch.zeros_like(v) for k, v in full["trainable"].items()},
            "opt_state": tree_map(place, full["opt_state"], specs), "step": 0}
    got = load_checkpoint(os.path.join(ckdir, "dcp"), like)
    return {"rank": rank, "trainable": got["trainable"], "step": got["step"],
            "opt_state": _local_parts(got["opt_state"]),
            "sharded": shard_opt_state_zero1(full["opt_state"], mesh)}


def tp_checks(rank, shape, cases):
    """Tensor parallelism on a (data, model) mesh: for each case the
    forward of this rank's rows, the per-slot gradients of one SGD(lr=1)
    step (``old - new``), MAP at a 50% evidence mask, and conditional and
    unconditional samples from fixed seeds."""
    torch.set_default_dtype(torch.float64)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = []
    for spec, arrays, x, mask in cases:
        ctx, cc = port(spec, arrays)
        store = dict(cc.restrict_store(ctx.parameters))
        st, specs = shard_store_tp(cc, store, mesh)
        xt = torch.as_tensor(x)
        y = tp_forward(cc, mesh)(st, shard_batch(xt, mesh))
        tr, fr = split_trainable(cc, st)
        tr = _trainable(tr)
        old = {k: v.detach().clone() for k, v in tr.items()}
        step = tp_train_step(cc, torch.optim.SGD(list(tr.values()), lr=1.0), mesh)
        loss = step(tr, fr, shard_batch(xt, mesh))
        asg, val = MAPQuery(cc, mesh=mesh)(xt, evidence_mask=torch.as_tensor(mask), store=st)
        q = SamplingQuery(cc, mesh=mesh)
        cond = q.conditional(xt, evidence_mask=torch.as_tensor(mask), store=st,
                             generator=torch.Generator().manual_seed(5))
        unc = q(4, store=st, generator=torch.Generator().manual_seed(6))[0]
        try:
            MAPQuery(cc, mesh=mesh)(store=st, top_k=2)
            top_k = None
        except NotImplementedError as exc:
            top_k = str(exc)
        out.append({
            "top_k": top_k,
            "coords": (axis_rank(mesh, "data"), axis_rank(mesh, "model")),
            "forward": y.detach(), "loss": float(loss), "specs": specs,
            "grads": {k: old[k] - tr[k].detach() for k in tr},
            "map": (asg, val), "conditional": cond, "unconditional": unc,
        })
    return out
