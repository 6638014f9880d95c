"""The port's low-memory Adam (``cirkit_tpu_torch.parallel.optimizers``)
against its definition and the JAX package's optimizers, on the CPU.

The rounding bits are Philox draws, not the TPU's rbg bits, so the
stochastic-rounding cast is held to its properties (unbiased, rounds to a
bf16 neighbour), as ``tests/parallel/test_optimizers.py`` holds the JAX
one, and not bit for bit. ``torch.optim.Adam`` (the trainer's default) is
held against ``optax.adam`` on one gradient sequence in float64.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cirkit_tpu_torch.parallel import AdamLowMem, adam_lowmem
from cirkit_tpu_torch.parallel.optimizers import _scramble16, _sr_to_bf16


def _sr_many(x: float, n: int, seed: int) -> np.ndarray:
    """n independent stochastic roundings of the scalar x."""
    rnd = torch.as_tensor(np.random.default_rng(seed).integers(0, 1 << 16, n), dtype=torch.int32)
    return _sr_to_bf16(torch.full((n,), x, dtype=torch.float32), rnd).float().numpy()


def test_sr_cast_rounds_to_neighbors_and_is_unbiased():
    # bf16 spacing in [1, 2) is 2^-7; pick x 30% of the way up the gap
    x = float(np.float32(1.0 + 0.3 * 2.0**-7))
    outs = _sr_many(x, 16384, seed=0)
    assert set(np.unique(outs)) <= {1.0, 1.0 + 2.0**-7}
    np.testing.assert_allclose(outs.mean(), x, atol=1e-4)


def test_sr_cast_unbiased_for_negative_values():
    x = float(-np.float32(3.0) * (1.0 + 0.7 * 2.0**-8))
    np.testing.assert_allclose(_sr_many(x, 16384, seed=1).mean(), x, rtol=5e-5)


def test_scramble_is_a_bijection_on_16_bits():
    rnd = torch.arange(1 << 16, dtype=torch.int32)
    assert torch.equal(torch.sort(_scramble16(rnd)).values, rnd)


def _run(make, steps=25, dtype=torch.float32):
    p = torch.tensor([1.0, -2.0, 0.5], dtype=dtype, requires_grad=True)
    opt = make([p])
    for t in range(steps):
        p.grad = torch.tensor([0.1 * (t + 1), -0.3, 2.0], dtype=dtype)
        opt.step()
    return p.detach()


def test_f32_state_equals_torch_adam():
    ours = _run(adam_lowmem(1e-2, state_dtype=torch.float32))
    ref = _run(lambda ps: torch.optim.Adam(ps, lr=1e-2))
    torch.testing.assert_close(ours, ref, rtol=0, atol=0)


def test_torch_adam_equals_optax_adam_float64():
    ref_p = jnp.array([1.0, -2.0, 0.5], jnp.float64)
    opt = optax.adam(1e-2)
    state = opt.init(ref_p)
    for t in range(25):
        g = jnp.array([0.1 * (t + 1), -0.3, 2.0], jnp.float64)
        updates, state = opt.update(g, state, ref_p)
        ref_p = optax.apply_updates(ref_p, updates)
    ours = _run(lambda ps: torch.optim.Adam(ps, lr=1e-2), dtype=torch.float64)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_p), rtol=1e-13, atol=1e-15)


def test_bf16_moments_and_trajectory_close_to_adam():
    target = torch.linspace(1, -1, 64)

    def run(make, steps=200):
        p = torch.linspace(-2, 2, 64).requires_grad_()
        opt = make([p])
        for _ in range(steps):
            p.grad = p.detach() - target
            opt.step()
        return p.detach(), opt

    ours, opt = run(adam_lowmem(5e-2))
    ref, _ = run(lambda ps: torch.optim.Adam(ps, lr=5e-2))
    torch.testing.assert_close(ours, ref, rtol=0, atol=0.03)
    state = next(iter(opt.state.values()))
    assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.bfloat16
    assert int(state["step"]) == 200


def test_bf16_second_moment_tracks_its_ema():
    """A constant gradient: nu converges toward g^2 under stochastic
    rounding, where round-to-nearest bf16 would stall."""
    g = torch.full((256,), 0.125)
    p = torch.zeros(256, requires_grad=True)
    opt = AdamLowMem([p], lr=1e-3)
    steps = 1500
    for _ in range(steps):
        p.grad = g.clone()
        opt.step()
    nu = opt.state[p]["exp_avg_sq"].float()
    expected = 0.125**2 * (1 - 0.999**steps)
    np.testing.assert_allclose(float(nu.mean()), expected, rtol=0.05)


def test_draws_replay_from_seed_and_state_round_trips():
    def run(seed, state=None, first=0, last=5):
        p = torch.linspace(-1, 1, 32).requires_grad_()
        opt = AdamLowMem([p], lr=1e-2, seed=seed)
        if state is not None:
            p.data.copy_(state[0])
            opt.load_state_dict(state[1])
        for t in range(first, last):
            p.grad = torch.sin(p.detach() * (t + 1))
            opt.step()
        return p.detach().clone(), opt.state_dict()

    a, _ = run(0)
    b, _ = run(0)
    c, _ = run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    half_p, half_state = run(0, last=2)
    assert half_state["state"][0]["exp_avg"].dtype == torch.bfloat16
    resumed, state = run(0, state=(half_p, half_state), first=2)
    # a resumed run replays the uninterrupted one's draws
    assert torch.equal(resumed, a)
    assert state["state"][0]["exp_avg"].dtype == torch.bfloat16


def test_state_dtype_is_checked():
    with pytest.raises(ValueError, match="state_dtype"):
        AdamLowMem([torch.zeros(1, requires_grad=True)], state_dtype=torch.float16)
