"""The port's maximum-likelihood trainer (``cirkit_tpu_torch.parallel``)
against the JAX package's (``cirkit_tpu.parallel``), on the CPU.

The same circuit is built in both packages and the JAX store is carried
into the port by slot name, in float64:

- the gradient of the mean NLL of every learnable slot, through the port's
  plain backward versions, against ``jax.value_and_grad`` over JAX's
  ``split_trainable``, to 1e-10 of the slot's largest entry; the trainable
  slot sets are equal;
- ``fit(shuffle=False)`` with the default ``torch.optim.Adam(lr=1e-2)``
  against JAX's ``fit(shuffle=False)`` with ``optax.adam(1e-2)``: the loss
  of every step to rtol 1e-9 (the two Adams round in different orders),
  for full batches, a zero-padded final partial batch and sample weights.

The trainer's own semantics (partial batches, sample weights, resume,
freeze, evaluate_ll, preemption) are pinned as in the JAX package's tests.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.parallel import fit as jax_fit
from cirkit_tpu.parallel.training import split_trainable as jax_split_trainable
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.parallel import (
    Preempted,
    data_parallel_step,
    evaluate_ll,
    fit,
    split_trainable,
)
from cirkit_tpu_torch.pipeline import PipelineContext

FLAGS = dict(semiring="lse-sum", fold=True, optimize=True)


def _kw(spl, k=4):
    return dict(input_layer="categorical", num_input_units=k, sum_product_layer=spl,
                num_sum_units=k)


def _port(spl="cp", seed=0, dtype=torch.float64):
    ctx = PipelineContext(**FLAGS, device="cpu", seed=seed)
    cc = ctx.compile(image_data((1, 4, 4), "quad-graph", **_kw(spl)))
    if dtype is not None:
        ctx.load_parameters({s: v.detach().numpy() for s, v in ctx.parameters.items()},
                            dtype=dtype)
    return ctx, cc


def _both(spl):
    """The JAX circuit with its store in float64, and the port's circuit
    holding the same store."""
    jctx = JaxPipelineContext(**FLAGS)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-graph", **_kw(spl)))
    jstore = {s: jnp.asarray(v, jnp.float64) for s, v in jctx.parameters.items()}
    ctx, cc = _port(spl, dtype=None)
    ctx.load_parameters({s: np.asarray(v) for s, v in jstore.items()})
    return jcc, jstore, ctx, cc


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 16))


@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_gradients_match_jax_float64(spl):
    jcc, jstore, ctx, cc = _both(spl)
    x = _data(16)
    jtr, jfr = jax_split_trainable(jcc, jstore)

    def jax_loss(tr):
        return -jnp.mean(jcc.evaluate({**tr, **jfr}, jnp.asarray(x)))

    jl, jgrads = jax.jit(jax.value_and_grad(jax_loss))(jtr)
    tr, fr = split_trainable(cc, ctx.parameters)
    assert set(tr) == set(jtr) and set(fr) == set(jfr)
    loss = -cc.evaluate({**tr, **fr}, torch.as_tensor(x)).mean()
    grads = dict(zip(tr, torch.autograd.grad(loss, list(tr.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-10)
    for s, g in grads.items():
        ref = np.asarray(jgrads[s])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-10 * np.abs(ref).max(),
                                   err_msg=s)


@pytest.mark.parametrize(
    "n,batch_size,num_epochs,sample_weight",
    [(96, 32, 1, None), (100, 64, 2, None), (6, 6, 3, [2.0, 1.0, 3.0, 1.0, 2.0, 1.0])],
    ids=["full-batches", "partial-batch", "sample-weight"],
)
def test_fit_matches_jax_fit_float64(n, batch_size, num_epochs, sample_weight):
    jcc, jstore, ctx, cc = _both("cp")
    data = _data(n, seed=1)
    kw = dict(num_epochs=num_epochs, batch_size=batch_size, shuffle=False,
              sample_weight=None if sample_weight is None else np.asarray(sample_weight))
    jstore_new, jlosses = jax_fit(jcc, data, store=jstore, optimizer=optax.adam(1e-2), **kw)
    store, losses = fit(cc, data, store=dict(ctx.parameters), **kw)
    assert len(losses) == len(jlosses) == num_epochs * -(-n // batch_size)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-9)
    for s, v in store.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jstore_new[s]), rtol=1e-7,
                                   atol=1e-9, err_msg=s)


def test_fit_binds_the_new_store_and_returns_copies():
    ctx, cc = _port()
    before = {s: v.detach().clone() for s, v in ctx.parameters.items()}
    data = _data(64)
    store, losses = fit(cc, data, num_epochs=2, batch_size=32)
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(torch.equal(ctx.parameters[s], v) for s, v in before.items())
    assert set(cc.default_store) == set(store)
    x = torch.as_tensor(data[:8])
    with torch.no_grad():
        torch.testing.assert_close(cc(x), cc(store, x), rtol=0, atol=0)


def test_fit_partial_final_batch_trains_every_sample():
    """A trailing partial batch is zero-padded and weighted: fit over 100
    samples in batches of 64 equals two manual weighted steps."""
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.05)  # noqa: E731
    data = _data(100, seed=1)
    ctx, cc = _port()
    store, losses = fit(cc, data, store=dict(ctx.parameters), batch_size=64, optimizer=sgd,
                        shuffle=False)
    assert len(losses) == 2

    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = {k: v.detach().clone().requires_grad_() for k, v in sorted(trainable.items())}
    step = data_parallel_step(cc, sgd(list(trainable.values())), weighted=True)
    l1 = step(trainable, frozen, torch.as_tensor(data[:64]), torch.ones(64))
    pad = torch.as_tensor(np.concatenate([data[64:], np.zeros((28, 16), data.dtype)]))
    l2 = step(trainable, frozen, pad, torch.cat([torch.ones(36), torch.zeros(28)]))
    np.testing.assert_allclose(losses, [float(l1), float(l2)], rtol=1e-12)
    for k, v in trainable.items():
        torch.testing.assert_close(store[k], v.detach(), rtol=1e-12, atol=0)


def test_fit_dataset_smaller_than_batch_trains_one_weighted_step():
    ctx, cc = _port()
    _, losses = fit(cc, _data(10, seed=5), num_epochs=3, batch_size=64,
                    optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05))
    assert len(losses) == 3  # one step per epoch
    assert losses[-1] < losses[0]


def test_fit_sample_weight_matches_replicated_dataset():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(6, 16))
    weights = np.array([2, 1, 3, 1, 2, 1], np.float32)
    replicated = np.repeat(data, weights.astype(int), axis=0)  # 10 rows

    def run(d, sw, bs):
        ctx, cc = _port(seed=7)
        return fit(cc, d, store=dict(ctx.parameters), num_epochs=3, batch_size=bs,
                   optimizer=lambda ps: torch.optim.SGD(ps, lr=0.05), shuffle=False,
                   sample_weight=sw)

    store_r, losses_r = run(replicated, None, 10)
    store_w, losses_w = run(data, weights, 6)
    np.testing.assert_allclose(losses_w, losses_r, rtol=1e-9)
    for k in store_r:
        torch.testing.assert_close(store_w[k], store_r[k], rtol=1e-9, atol=1e-12)


def test_fit_validates_its_arguments():
    ctx, cc = _port()
    data = np.zeros((8, 16), np.int64)
    with pytest.raises(ValueError, match="entries for"):
        fit(cc, data, batch_size=8, sample_weight=np.ones(5))
    with pytest.raises(ValueError, match="finite and >= 0"):
        fit(cc, data, batch_size=8, sample_weight=-np.ones(8))
    with pytest.raises(ValueError, match="checkpoint_path"):
        fit(cc, data, batch_size=8, resume=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        fit(cc, data, batch_size=8, mesh=object())
    with pytest.raises(NotImplementedError, match="item 6"):
        fit(cc, data, batch_size=8, missing=-1)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    with pytest.raises(NotImplementedError, match="item 12"):
        data_parallel_step(cc, opt, zero1=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        data_parallel_step(cc, opt, marginalize_missing=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        evaluate_ll(cc, data, axis="model")


class _Killed(RuntimeError):
    pass


def test_fit_resume_reproduces_uninterrupted_run(tmp_path):
    data = _data(96)
    ck = tmp_path / "fit_ck"
    kw = dict(num_epochs=2, batch_size=32, optimizer=lambda ps: torch.optim.Adam(ps, lr=0.05))

    ctx, cc = _port(seed=11)
    full_store, full_losses = fit(cc, data, store=dict(ctx.parameters), **kw)

    def killer(epoch, step, loss):
        if step == 4:
            raise _Killed

    ctx2, cc2 = _port(seed=11)
    with pytest.raises(_Killed):
        fit(cc2, data, store=dict(ctx2.parameters), callback=killer, checkpoint_every=3,
            checkpoint_path=str(ck), **kw)
    assert (tmp_path / "fit_ck.npz").exists()

    ctx3, cc3 = _port(seed=11)
    store, losses = fit(cc3, data, store=dict(ctx3.parameters), checkpoint_every=3,
                        checkpoint_path=str(ck), resume=True, **kw)
    assert len(losses) == len(full_losses)
    np.testing.assert_allclose(losses, full_losses, rtol=1e-12)
    for k in full_store:
        torch.testing.assert_close(store[k], full_store[k], rtol=1e-12, atol=0)

    with pytest.raises(ValueError, match="different run"):
        fit(cc3, data[:64], checkpoint_path=str(ck), resume=True, **kw)


def test_sigterm_writes_a_checkpoint_and_raises_preempted(tmp_path):
    data = _data(96)
    ck = str(tmp_path / "pre")
    kw = dict(num_epochs=1, batch_size=32, checkpoint_every=10, checkpoint_path=ck)

    def term(epoch, step, loss):
        if step == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    ctx, cc = _port()
    with pytest.raises(Preempted):
        fit(cc, data, store=dict(ctx.parameters), callback=term, **kw)
    _, losses = fit(cc, data, store=dict(ctx.parameters), resume=True, **kw)
    assert len(losses) == 3


def test_freeze_keeps_slots_fixed():
    ctx, cc = _port()
    frozen_slot = sorted(cc.learnable_slots)[0]
    store, _ = fit(cc, _data(32), store=dict(ctx.parameters), batch_size=32,
                   freeze=[frozen_slot])
    for s, v in store.items():
        assert torch.equal(v, ctx.parameters[s]) == (s == frozen_slot), s
    assert cc.shared_learnable_slots == frozenset()
    trainable, frozen = split_trainable(cc, ctx.parameters, freeze="shared")
    assert set(trainable) == set(cc.learnable_slots) and not frozen
    with pytest.raises(ValueError, match="freeze"):
        split_trainable(cc, ctx.parameters, freeze="all")


def test_store_views_match_jax():
    jctx = JaxPipelineContext(**FLAGS)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-graph", **_kw("tucker")))
    ctx, cc = _port("tucker")
    assert cc.used_slots == jcc.used_slots
    assert cc.learnable_slots == jcc.learnable_slots
    assert cc.shared_learnable_slots == jcc.shared_learnable_slots
    assert set(cc.restrict_store({**ctx.parameters, "other": None})) == set(jcc.used_slots)


def test_evaluate_ll_matches_direct_mean():
    ctx, cc = _port()
    data = _data(100, seed=9)  # a partial last batch
    with torch.no_grad():
        direct = float(cc(torch.as_tensor(data)).mean())
    np.testing.assert_allclose(evaluate_ll(cc, data, batch_size=32), direct, rtol=1e-12)
