"""The bf16-weight and ``CIRKIT_TPU_FAST`` configurations of the blocked
dense kernels (3 and 4) and the bf16 ``th`` of the routing kernels (8 and
9) against the JAX package, on the CPU.

On CPU tensors the port runs its plain versions, which round at the port's
kernels' points (``ops/lse_einsum.py``: the blocked forward's exponentials
over the row's running max of chunks of ``_BLOCKED_KC`` columns, its
backward's ``gy``,
weights and exponentials); the JAX package runs ``_blocked_fwd_call`` and
``_blocked_p`` in interpret mode in the mode ``_cfg_fast`` gives
(``CIRKIT_TPU_FORCE_PALLAS``, as ``tests/test_torch_fast_modes.py`` and
``tests/test_torch_wide.py`` do). The two round at different points, so
each is held against float64 within the JAX package's fast bounds (8e-3
forward, 4e-2 gradient, ``tests/ops/test_lse_einsum.py``'s ``_BOUNDS``) and
against the other within twice them. ``sr`` has no interpret-mode lowering
in JAX, which runs it as ``bf16``: the port's ``sr`` is held to the same
bounds and to itself, bit for bit. A bf16 weight's gradient comes back
bf16, as JAX's ``_blocked_p_bwd`` casts it. The f32-grade mode on a bf16
weight is held to float32's bounds.

The routing ops on a bf16 ``th`` are held to JAX's kernels on the same bf16
``th`` (the max kind: JAX has no sample kind in interpret mode) and equal
the port's own run on the widened ``th``, to the bit.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu_torch.ops import _build
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.ops import routing as R

FWD_TOL, GRAD_TOL = 8e-3, 4e-2
MODES = {"bf16": "1", "sr": "sr"}  # mode -> CIRKIT_TPU_FAST
# (F, B, I, O): a small blocked shape, then shapes that no tile of the
# float32 kernels divides (tests/test_torch_wide.py's RAGGED_BLOCKED)
BLOCKED_SHAPES = [(2, 9, 300, 16), (1, 130, 777, 70), (1, 13, 1000, 1)]


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("CIRKIT_TPU_FAST", raising=False)
    monkeypatch.setattr(T, "WIDE_WIDTH", 64)  # the shapes here take the blocked route
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in T.LAUNCHES.values()), "a CPU test launched a kernel"


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even) and widened back, exactly."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _blocked_inputs(shape, w16: bool, seed: int = 31):
    """x with a row that is all -inf, linear weights (bf16-valued for
    ``w16``) and a cotangent with a row of zeros."""
    f, b, i, o = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(f, b, i)) * 3.0 - 2.0).astype(np.float32)
    x[0, min(2, b - 1)] = -np.inf
    w = rng.uniform(0.01, 1.0, size=(f, o, i)).astype(np.float32)
    if w16:
        w = _bf16(w)
    g = rng.normal(size=(f, b, o)).astype(np.float32)
    g[0, min(5, b - 1)] = 0.0
    return x, w, g


def _port(x, w, g, w16: bool):
    """The port's wide ``lse_matmul`` (the blocked route) and its gradients."""
    xt = torch.as_tensor(x).requires_grad_()
    wt = torch.tensor(w)
    wt = (wt.to(torch.bfloat16) if w16 else wt).requires_grad_()
    out = T.lse_matmul(xt, wt)
    dx, dw = torch.autograd.grad(out, [xt, wt], torch.as_tensor(g))
    assert dw.dtype == wt.dtype  # a bf16 weight's gradient comes back bf16
    return out.detach().numpy(), dx.numpy(), dw.float().numpy()


def _jax(x, w, g, w16: bool):
    """``_blocked_fwd_call`` and the VJP of ``_blocked_p`` in interpret mode,
    in the mode ``_cfg_fast`` gives, the batch and width padded as
    ``_dispatch_blocked`` pads them."""
    f, b, i = x.shape
    bt, ic = (16 if b > 8 else 8), 128
    bp, ip = -(-b // bt) * bt, -(-i // ic) * ic
    cfg = J._BCfg(bt=bt, nbt=bp // bt, ic=ic, nic=ip // ic, interpret=True,
                  fast=J._cfg_fast(True))
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, bp - b), (0, ip - i)),
                 constant_values=jnp.finfo(jnp.float32).min)
    wj = jnp.asarray(w).astype(jnp.bfloat16) if w16 else jnp.asarray(w)
    wp = jnp.pad(wj, ((0, 0), (0, 0), (0, ip - i)))
    gp = jnp.pad(jnp.asarray(g), ((0, 0), (0, bp - b), (0, 0)))
    out, vjp = jax.vjp(lambda x, w: J._blocked_p(cfg, x, w), xp, wp)
    dx, dw = vjp(gp)
    assert dw.dtype == wj.dtype
    return (np.asarray(out)[:, :b], np.asarray(dx)[:, :b, :i],
            np.asarray(dw.astype(jnp.float32))[:, :, :i])


def _f64(x, w, g):
    """The float64 composition on the (bf16-valued) weight."""
    x64, w64, g64 = (torch.as_tensor(a, dtype=torch.float64) for a in (x, w, g))
    out, m = T.lse_matmul_blocked_ref(x64, w64)
    dx, dw = T.lse_matmul_blocked_bwd_ref(x64, w64, out, m, g64)
    return out.numpy(), dx.numpy(), dw.numpy()


def _held(label, got, want, tol, *, scale=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert not np.isnan(got).any(), f"{label}: NaN"
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got)), f"{label}: -inf pattern differs"
    err = np.max(np.abs(got[finite] - want[finite]), initial=0.0)
    denom = max(1.0, float(np.max(np.abs(want[finite]), initial=0.0))) if scale else 1.0
    assert err / denom < tol, f"{label}: error {err:.3e} (scale {denom:.3g}) exceeds {tol}"


@pytest.mark.parametrize("shape", BLOCKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("w16", [False, True], ids=["f32-w", "bf16-w"])
@pytest.mark.parametrize("mode", list(MODES))
def test_blocked_fast_modes_against_float64_and_the_interpret_kernel(mode, w16, shape,
                                                                     monkeypatch):
    """The fast blocked forward and backward (kernels 3' and 4'): the port's
    and JAX's interpret-mode kernels', each within the fast bounds of
    float64 and of each other within twice them; a row that is all -inf
    gives -inf and zero gradients, no NaN; ``sr`` repeats to the bit."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", MODES[mode])
    x, w, g = _blocked_inputs(shape, w16)
    port = _port(x, w, g, w16)
    ref = _f64(x, w, g)
    jx = _jax(x, w, g, w16)
    for k, name in enumerate(("out", "dx", "dw")):
        tol = FWD_TOL if k == 0 else GRAD_TOL
        _held(f"port {name}", port[k], ref[k], tol, scale=k > 0)
        _held(f"jax {name}", jx[k], ref[k], tol, scale=k > 0)
        _held(f"port vs jax {name}", port[k], jx[k], 2 * tol, scale=k > 0)
    b_inf = min(2, shape[1] - 1)
    assert np.isneginf(port[0][0, b_inf]).all() and (port[1][0, b_inf] == 0).all()
    if mode == "sr" and shape == BLOCKED_SHAPES[0]:
        # a stateless hash of the element's index: a call repeats. At this
        # size the CPU's exponentials run on one thread; split across
        # threads, torch.exp on the CPU was seen to differ in its last bit
        # between calls, which a rounding to bf16 can carry
        again = _port(x, w, g, w16)
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(port, again))


@pytest.mark.parametrize("shape", BLOCKED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_blocked_bf16_weight_f32_grade(shape):
    """The f32-grade mode on a bf16 weight (the ``_w16`` instances): the
    port's forward and gradients against float64 on the widened weight and
    against JAX's interpret-mode kernels on the bf16 one, within float32's
    bounds (those of ``tests/test_torch_wide.py``)."""
    x, w, g = _blocked_inputs(shape, True, seed=32)
    port = _port(x, w, g, True)
    ref = _f64(x, w, g)
    jx = _jax(x, w, g, True)
    _held("port out", port[0], ref[0], 1e-4)
    _held("port vs jax out", port[0], jx[0], 5e-4)
    # dw comes back bf16: its rounding, 2^-8 relative, bounds the gradient
    for k, name, tol in ((1, "dx", 1e-4), (2, "dw", 2 ** -8)):
        _held(f"port {name}", port[k], ref[k], tol, scale=True)
        _held(f"port vs jax {name}", port[k], jx[k], 2 * tol + 5e-3, scale=True)


@pytest.mark.parametrize("mode", list(MODES))
def test_blocked_fast_forward_rounds_over_the_running_max(mode, monkeypatch):
    """Within one chunk of ``_BLOCKED_KC`` columns the running max is the row
    max, so the fast blocked forward rounds as the single-pass one does, to
    the bit; the row max ``m`` the backward reads is the clamped max in every
    mode. Over several chunks a row whose max sits in the last chunk rounds
    its early exponentials against the smaller running max, as the kernel
    does."""
    kc = T._BLOCKED_KC
    rng = np.random.default_rng(33)
    x = torch.as_tensor((rng.normal(size=(2, 5, kc)) * 3.0).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.01, 1.0, size=(2, 7, kc)).astype(np.float32))
    out, m = T.lse_matmul_blocked_ref(x, w, mode)
    assert torch.equal(out, T.lse_matmul_ref(x, w, mode))
    assert torch.equal(m, T._clamp_max(x))
    wide = torch.cat([x, x + 0.37, x - 1.0], dim=-1)  # row maxes in the second chunk
    e = T._blocked_fast_e(wide, T._clamp_max(wide), mode)
    first = T.round_bf16(torch.exp(wide - T._clamp_max(wide[..., :kc])), mode, T.ROLE_E)
    scale = torch.exp(T._clamp_max(wide[..., :kc]) - T._clamp_max(wide))
    assert torch.equal(e[..., :kc], first[..., :kc] * scale)


def test_blocked_instances_have_entries_and_counts():
    """Every blocked instance has its forward and backward entries in the
    library's signatures, both in ``csrc/blocked_bf16.cu``, and a
    ``LAUNCHES`` key each; its gy scratch is bf16, one plane of rows padded to
    8 units (the ``_w16`` split: two), the float32 kernel's two f32 planes;
    its weight's gradient has the weight's type; the routing kernels have a
    ``_w16`` instance alone."""
    src = (Path(T.__file__).parent.parent / "csrc" / "blocked_bf16.cu").read_text()
    for sfx in T.INSTANCES:
        assert {f"lse_fwd_blocked{sfx}", f"lse_bwd_blocked{sfx}"} <= set(_build._SIGNATURES)
        assert {f"lse_matmul_blocked{sfx}", f"lse_matmul_blocked{sfx}_bwd"} <= set(T.LAUNCHES)
        assert _build._SIGNATURES[f"lse_fwd_blocked{sfx}"] == _build._SIGNATURES["lse_fwd_blocked"]
        assert _build._SIGNATURES[f"lse_bwd_blocked{sfx}"] == _build._SIGNATURES["lse_bwd_blocked"]
        assert f"BLOCKED_BF16_ENTRIES({sfx}, " in src
        planes = 2 if sfx == "_w16" else 1
        assert T._blocked_gy_shape(3, 130, 70, "", sfx) == (planes, 3, 130, 72)
        assert T._blocked_gy_shape(3, 130, 64, "", sfx) == (planes, 3, 130, 64)
        assert T._blocked_gy_dtype(torch.float32, sfx) == torch.bfloat16
        w_dtype = torch.bfloat16 if sfx.startswith("_w16") else torch.float32
        assert T._blocked_dw_dtype(torch.float32, sfx) == w_dtype
    assert T._blocked_gy_shape(3, 130, 70, "", "") == (3, 130, 70, 2)
    assert T._blocked_gy_dtype(torch.float32, "") == torch.float32
    assert T._blocked_dw_dtype(torch.float32, "") == torch.float32
    assert T._blocked_dw_dtype(torch.float64, "") == torch.float64
    assert "BLOCKED_INSTANCES" not in (Path(T.__file__).parent.parent / "csrc"
                                       / "lse_wide.cu").read_text()
    for op, entry in (("tropical_tucker2", "tropical_tucker"), ("route_tucker2", "route_tucker")):
        assert f"{op}_w16" in R.LAUNCHES and f"{op}_fast" not in R.LAUNCHES
        assert _build._SIGNATURES[f"{entry}_w16"] == _build._SIGNATURES[entry]


def test_blocked_chunk_width_matches_the_kernel():
    """The plain fast forward rounds over the running max of chunks of
    ``_BLOCKED_KC`` columns, the chunk width ``bb::KC`` of the kernels'
    source: a kernel with other chunks would round other exponentials."""
    src = (Path(T.__file__).parent.parent / "csrc" / "blocked_bf16.cu").read_text()
    ns = src[src.index("namespace bb {"):]
    ns = ns[:ns.index("}  // namespace bb")]
    assert re.search(r"constexpr int KC = (\d+);", ns).group(1) == str(T._BLOCKED_KC)


# --------------------------------------------------------------------------- #
# Kernels 8' and 9': the routing kernels on a bf16 th
# --------------------------------------------------------------------------- #

F, K, O = 3, 16, 16  # the smallest shape the JAX kernels take (M % 128 == 0)


def _route_inputs(seed, b, log_weights):
    rng = np.random.default_rng(seed)
    x1 = (rng.standard_normal((F, b, K)) * 4.0 - 10.0).astype(np.float32)
    x2 = (rng.standard_normal((F, b, K)) * 4.0 - 10.0).astype(np.float32)
    th = ((rng.standard_normal((F, O, K * K)) * 1.5).astype(np.float32) if log_weights
          else rng.uniform(0.01, 1.0, (F, O, K * K)).astype(np.float32))
    x1[0, 1, :4] = -np.inf  # children of -inf
    sel = rng.integers(0, O, (F, b))
    return x1, x2, _bf16(th), sel


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_tropical_bf16_th_matches_jax_and_the_widened_run(log_weights, b):
    """MAP's max-plus Tucker on a bf16 ``th`` (whole and in 3 ranges of m):
    against JAX's kernel on the same bf16 ``th`` (rtol = atol = 1e-5, as on
    a float32 one), and equal to the port's run on the widened ``th``."""
    x1, x2, th, _ = _route_inputs(74, b, log_weights)
    want = J.tropical_tucker2(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(th).astype(jnp.bfloat16), log_weights=log_weights)
    assert want is not None  # the Pallas kernel ran (interpret mode)
    t1, t2, t32 = (torch.as_tensor(a) for a in (x1, x2, th))
    t16 = t32.to(torch.bfloat16)
    for splits in (None, 3):
        got = R.tropical_tucker2(t1, t2, t16, log_weights=log_weights, splits=splits)
        assert got.dtype == torch.float32
        assert torch.equal(got, R.tropical_tucker2(t1, t2, t32, log_weights=log_weights,
                                                   splits=splits))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_route_bf16_th_matches_jax_and_the_widened_run(log_weights, b):
    """The routing choice on a bf16 ``th``: the max kind's indices equal JAX's
    kernel's on the same bf16 ``th``, and both kinds equal the port's run on
    the widened ``th`` (the sample kind from the same seed)."""
    x1, x2, th, sel = _route_inputs(75, b, log_weights)
    want = J.route_tucker2(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(th).astype(jnp.bfloat16),
                           jnp.asarray(sel.astype(np.int32)), kind="max",
                           log_weights=log_weights)
    assert want is not None
    t1, t2, t32, ts = (torch.as_tensor(a) for a in (x1, x2, th, sel))
    t16 = t32.to(torch.bfloat16)
    got = R.route_tucker2(t1, t2, t16, ts, kind="max", log_weights=log_weights)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, R.route_tucker2(t1, t2, t32, ts, kind="max", log_weights=log_weights))
    draw = R.route_tucker2(t1, t2, t16, ts, kind="sample", log_weights=log_weights, seed=9)
    assert torch.equal(draw, R.route_tucker2(t1, t2, t32, ts, kind="sample",
                                             log_weights=log_weights, seed=9))
