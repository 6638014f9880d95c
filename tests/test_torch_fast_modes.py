"""The port's speed modes and bf16 weight operands against the JAX package,
on the CPU.

``CIRKIT_TPU_FAST`` and a bf16 weight reach the log-einsum-exp ops of both
packages the same way; on CPU tensors the port runs its plain versions,
which round at the port's kernels' points (``ops/lse_einsum.py``), and the
JAX package runs its Pallas kernels in interpret mode
(``CIRKIT_TPU_FORCE_PALLAS``, as ``tests/ops/test_lse_einsum.py`` does).
The two round at different points, so each is held against the float64
composition within the JAX package's documented fast bounds (``_BOUNDS``
of ``tests/ops/test_lse_einsum.py``: 8e-3 forward, 4e-2 gradient) and
against the other within twice them. ``sr`` has no interpret-mode lowering
in JAX, which runs it as ``bf16``: the port's plain ``sr`` is held to the
same float64 bounds and to itself, bit for bit. A bf16 weight's gradient
comes back bf16, as JAX's ``_fused_p_bwd`` casts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu_torch.ops import lse_einsum as T

FWD_TOL, GRAD_TOL = 8e-3, 4e-2
F, B, O, I, K1, K2 = 2, 16, 16, 64, 8, 8
OPS = ["lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax"]


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.delenv("CIRKIT_TPU_FAST", raising=False)
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in T.LAUNCHES.values()), "a CPU test launched a kernel"


def _inputs(op: str, seed: int = 20, k1: int = K1, k2: int = K2) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)

    def logx(*shape):
        return (rng.normal(size=shape) * 3.0 - 2.0).astype(np.float32)

    tucker = "tucker" in op
    xs = [logx(F, B, k1), logx(F, B, k2)] if tucker else [logx(F, B, I)]
    width = k1 * k2 if tucker else I
    if "softmax" in op:
        w = rng.normal(size=(F, O, width)).astype(np.float32)
    else:
        w = rng.uniform(0.01, 1.0, size=(F, O, width)).astype(np.float32)
    return [*xs, w]


def _f64_ref(op: str, ins: list[np.ndarray]) -> torch.Tensor:
    """The float64 composition (the port's f32-grade plain version in
    float64)."""
    return T._ENTRIES[op][2](*(torch.as_tensor(a, dtype=torch.float64) for a in ins))


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even) and widened back, exactly."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _sin_grads(fn, args, argnums):
    """The gradients of ``sum(sin(fn(*args)))`` with respect to ``argnums``."""
    ts = [torch.as_tensor(a).requires_grad_(k in argnums) for k, a in enumerate(args)]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad(torch.sin(out).sum(), [ts[k] for k in argnums])


def _jax_sin_grads(fn, args, argnums):
    jargs = [jnp.asarray(a) for a in args]
    out = fn(*jargs)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(fn(*a))), argnums=argnums)(*jargs)
    return np.asarray(out), [np.asarray(g, np.float64) for g in grads]


def _held(label, got, want, tol, *, scale=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    denom = max(1.0, float(np.max(np.abs(want)))) if scale else 1.0
    assert err / denom < tol, f"{label}: error {err:.3e} (scale {denom:.3g}) exceeds {tol}"


def _argnums(op):
    # the inputs' gradient for plain weights, the logits' for softmax (as
    # tests/ops/test_lse_einsum.py:test_error_bounds_vs_float64)
    return (len(_inputs(op)) - 1,) if "softmax" in op else (0,)


@pytest.mark.parametrize("w16", [False, True], ids=["f32-w", "bf16-w"])
@pytest.mark.parametrize("op", OPS)
def test_fast_mode_against_float64_and_the_interpret_kernel(op, w16, monkeypatch):
    """``CIRKIT_TPU_FAST=1``: the port's forward and gradients and JAX's
    interpret-mode kernel's, each within the fast bounds of float64 (on the
    bf16-rounded weight where the weight is a bf16 store), and of each other
    within twice them."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    ins = _inputs(op)
    if w16:
        ins[-1] = _bf16(ins[-1])
    argnums = _argnums(op)
    if w16:
        # a bf16 weight: its gradient comes back bf16; the inputs' in f32
        ts = [torch.as_tensor(a) for a in ins[:-1]] + [
            torch.as_tensor(ins[-1]).to(torch.bfloat16).requires_grad_()
        ]
        out = getattr(T, op)(*ts)
        (dw,) = torch.autograd.grad(torch.sin(out).sum(), [ts[-1]])
        assert dw.dtype == torch.bfloat16
        jargs = [jnp.asarray(a) for a in ins[:-1]] + [jnp.asarray(ins[-1]).astype(jnp.bfloat16)]
        jout = getattr(J, op)(*jargs)
        jdw = jax.grad(lambda w: jnp.sum(jnp.sin(getattr(J, op)(*jargs[:-1], w))))(jargs[-1])
        assert jdw.dtype == jnp.bfloat16
        f64 = [torch.as_tensor(a, dtype=torch.float64) for a in ins]
        ref, (ref_dw,) = _sin_grads(T._ENTRIES[op][2], f64, (len(ins) - 1,))
        jdw32 = np.asarray(jdw.astype(jnp.float32))
        _held(f"{op} port", out.detach().numpy(), ref.numpy(), FWD_TOL)
        _held(f"{op} jax", np.asarray(jout), ref.numpy(), FWD_TOL)
        _held(f"{op} port-jax", out.detach().numpy(), np.asarray(jout), 2 * FWD_TOL)
        _held(f"{op} dw port", dw.float().numpy(), ref_dw.numpy(), GRAD_TOL, scale=True)
        _held(f"{op} dw jax", jdw32, ref_dw.numpy(), GRAD_TOL, scale=True)
        _held(f"{op} dw port-jax", dw.float().numpy(), jdw32, 2 * GRAD_TOL, scale=True)
        return
    out, grads = _sin_grads(getattr(T, op), ins, argnums)
    jout, jgrads = _jax_sin_grads(getattr(J, op), ins, argnums)
    with torch.no_grad():
        ref = _f64_ref(op, ins)
    f64 = [torch.as_tensor(a, dtype=torch.float64) for a in ins]
    _, rgrads = _sin_grads(T._ENTRIES[op][2], f64, argnums)
    _held(f"{op} port", out.numpy(), ref.numpy(), FWD_TOL)
    _held(f"{op} jax", jout, ref.numpy(), FWD_TOL)
    _held(f"{op} port-jax", out.numpy(), jout, 2 * FWD_TOL)
    for g, jg, rg in zip(grads, jgrads, rgrads):
        _held(f"{op} grad port", g.numpy(), rg.numpy(), GRAD_TOL, scale=True)
        _held(f"{op} grad jax", jg, rg.numpy(), GRAD_TOL, scale=True)
        _held(f"{op} grad port-jax", g.numpy(), jg, 2 * GRAD_TOL, scale=True)


@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
def test_fast_mode_chunked_tucker_against_the_interpret_kernel(softmax, monkeypatch):
    """Kernel 5's route (the K1-chunked Tucker forward, ``WIDE_WIDTH``
    patched down) in the fast mode against ``_dispatch_tucker_chunked`` in
    interpret mode (kc=8, nkc=2 at K1 = K2 = 16) and float64."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    monkeypatch.setattr(T, "WIDE_WIDTH", 256)
    op = "lse_tucker2_softmax" if softmax else "lse_tucker2"
    ins = _inputs(op, seed=3, k1=16, k2=16)
    ref = J._dispatch_tucker_chunked((jnp.asarray(ins[0]), jnp.asarray(ins[1])),
                                     jnp.asarray(ins[2]), softmax=softmax, interpret=True)
    assert ref is not None, "the chunked kernel must engage at these shapes"
    calls = []
    key = f"{op}_chunked"
    entry, bwd_entry, plain, bwd_plain = T._ENTRIES[key]
    monkeypatch.setitem(T._ENTRIES, key, (
        entry, bwd_entry, lambda *a, **kw: calls.append(kw.get("mode")) or plain(*a, **kw),
        bwd_plain))
    with torch.no_grad():
        out = getattr(T, op)(*(torch.as_tensor(a) for a in ins))
        want = _f64_ref(op, ins)
    assert calls == ["bf16"]
    _held(f"{key} port", out.numpy(), want.numpy(), FWD_TOL)
    _held(f"{key} jax", np.asarray(ref), want.numpy(), FWD_TOL)
    _held(f"{key} port-jax", out.numpy(), np.asarray(ref), 2 * FWD_TOL)


@pytest.mark.parametrize("op", OPS)
def test_sr_mode_repeats_and_holds_the_fast_bound(op, monkeypatch):
    """``CIRKIT_TPU_FAST=sr``: JAX interprets it as ``bf16``
    (``_cfg_fast``), so the port's ``bf16`` mode is the one held to JAX's
    interpret kernel above; the port's plain ``sr`` repeats to the bit,
    differs from its ``bf16`` rounding, and stays within the fast bounds of
    float64, forward and gradients."""
    monkeypatch.setenv("CIRKIT_TPU_FAST", "sr")
    assert T.fast_mode() == "sr" and J._cfg_fast(interpret=True) == "bf16"
    ins = _inputs(op, seed=31)
    argnums = _argnums(op)
    out, grads = _sin_grads(getattr(T, op), ins, argnums)
    again, grads2 = _sin_grads(getattr(T, op), ins, argnums)
    assert torch.equal(out, again) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    monkeypatch.setenv("CIRKIT_TPU_FAST", "1")
    rn, _ = _sin_grads(getattr(T, op), ins, argnums)
    assert not torch.equal(out, rn)
    f64 = [torch.as_tensor(a, dtype=torch.float64) for a in ins]
    with torch.no_grad():
        ref = _f64_ref(op, ins)
    _, rgrads = _sin_grads(T._ENTRIES[op][2], f64, argnums)
    _held(f"{op} sr", out.numpy(), ref.numpy(), FWD_TOL)
    for g, rg in zip(grads, rgrads):
        _held(f"{op} sr grad", g.numpy(), rg.numpy(), GRAD_TOL, scale=True)


def _tiles_in_order(x1, x2, theta, mode):
    """The fast Tucker forward with logits tile by tile, as the kernels of
    ``csrc/tucker_bf16.cu`` run it: chunks of ``_TUCKER_JC`` columns, a row
    ``i`` of a chunk a tile; each unit's running max raised by the tile's,
    its float64 sums and normalizer shrunk by ``exp(old - new)``, the tile's
    ``exp(theta - max)`` rounded at its flat index in ``theta``."""
    f, b, k1 = x1.shape
    k2, o = x2.shape[2], theta.shape[1]
    e1 = torch.exp(x1 - T._clamp_max(x1)).double()
    e2 = T.round_bf16(torch.exp(x2 - T._clamp_max(x2)), mode, T.ROLE_E).double()
    run = torch.full((f, o), -torch.inf)
    acc = torch.zeros((f, b, o), dtype=torch.float64)
    z = torch.zeros((f, o), dtype=torch.float64)
    th = theta.view(f, o, k1, k2)
    for j0 in range(0, k2, T._TUCKER_JC):
        cols = slice(j0, j0 + T._TUCKER_JC)
        for i in range(k1):
            seg = th[:, :, i, cols]
            new = torch.maximum(run, seg.amax(dim=-1))
            scl = torch.where(new == -torch.inf, 1.0, torch.exp(run - new)).double()
            ex = torch.exp(seg - torch.where(new == -torch.inf, 0.0, new)[..., None])
            run = new
            z = z * scl + ex.double().sum(dim=-1)
            staged = torch.zeros_like(th)
            staged[:, :, i, cols] = ex
            r = T.round_bf16(staged.view(f, o, k1 * k2), mode, T.ROLE_W).view(f, o, k1, k2)
            s = torch.einsum("fbj,foj->fbo", e2[:, :, cols], r[:, :, i, cols].double())
            acc = acc * scl[:, None, :] + e1[:, :, i, None] * s
    shift = T._clamp_max(x1) + T._clamp_max(x2)
    return torch.log(acc) - torch.log(z)[:, None, :] + shift.double()


@pytest.mark.parametrize("mode", ["bf16", "sr"])
@pytest.mark.parametrize("k1,k2", [(4, 20), (3, 64), (3, 130)], ids=["k2-20", "k2-64", "k2-130"])
def test_fast_tucker_logits_round_over_the_tiles_running_max(k1, k2, mode):
    """The plain fast Tucker forward with logits (the single-pass and the
    K1-chunked one) rounds what the kernels round: ``exp(theta - r)`` over
    each unit's running max of the tiles so far, in the kernels' tile order
    (K2 of one chunk, a whole one, and three with a ragged last), held to the
    tile-by-tile run in float64 sums to float32's rounding; with a unit whose
    first tile is all -inf, one whose max rises tile by tile and one whose
    logits are -inf but in the last tile."""
    rng = np.random.default_rng(7)
    x1 = torch.as_tensor((rng.normal(size=(2, 5, k1)) * 3.0 - 2.0).astype(np.float32))
    x2 = torch.as_tensor((rng.normal(size=(2, 5, k2)) * 3.0 - 2.0).astype(np.float32))
    theta = torch.as_tensor(rng.normal(size=(2, 4, k1 * k2)).astype(np.float32))
    theta[0, 0, :k2] = -torch.inf
    theta[0, 1] += torch.linspace(-20.0, 20.0, k1 * k2)
    theta[1, 2, :-1] = -torch.inf
    got = T.lse_tucker2_softmax_ref(x1, x2, theta, mode)
    want = _tiles_in_order(x1, x2, theta, mode)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5, atol=2e-5)
    f64 = T.lse_tucker2_softmax_ref(x1.double(), x2.double(), theta.double())
    _held(f"running max {mode}", got.numpy(), f64.numpy(), FWD_TOL)


def test_tucker_chunk_width_matches_the_kernel():
    """The plain fast Tucker forward's tiles are ``_TUCKER_JC`` columns wide,
    the chunk width ``tb::JC`` of ``csrc/tucker_bf16.cu``: a kernel with
    other tiles would round over other running maxes."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent.parent / "csrc" / "tucker_bf16.cu").read_text()
    ns = src[src.index("namespace tb {"):]
    ns = ns[:ns.index("}  // namespace tb")]
    assert re.search(r"constexpr int JC = (\d+);", ns).group(1) == str(T._TUCKER_JC)


def test_fast_tucker_backward_tiles_match_the_kernel():
    """The fast Tucker backward's scratch (``_tucker_bf16_bwd_scratch``)
    counts the kernel's partial dx planes by its unit group ``tbw::UG`` and
    column chunk ``tbw::JC`` of ``csrc/tucker_bf16_bwd.cu``: a kernel with
    other tiles would write past the scratch."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent.parent / "csrc" / "tucker_bf16_bwd.cu").read_text()
    ns = src[src.index("namespace tbw {"):]
    ns = ns[:ns.index("}  // namespace tbw")]
    assert re.search(r"constexpr int UG = (\d+);", ns).group(1) == str(T._BWD_UNIT_GROUP)
    assert re.search(r"constexpr int JC = (\d+);", ns).group(1) == str(T._TUCKER_JC)


@pytest.mark.parametrize("softmax,shape,want", [
    # the K=64 entry: e1, e2 transposed and gy in bf16; one block finishes dx
    (False, (784, 128, 64, 64, 64), 784 * 128 * 128 + 784 * 128 * 32),
    (True, (784, 128, 64, 64, 64), 784 * 128 * 160 + 2 * 784 * 64),  # the logits' lse and r_o
    (True, (784, 128, 128, 128, 128),  # two column chunks
     784 * 256 * 128 + 784 * 128 * 64 + 2 * 784 * 128 + 2 * 784 * 128 * 128),
    (False, (2, 33, 3, 100, 200),  # two unit groups too; B and O rounded up to 8
     2 * 103 * 40 + 2 * 33 * 100 + 4 * 2 * 33 * 3 + 2 * 2 * 33 * 100),
], ids=["k64", "k64-softmax", "k128-softmax", "o200"])
def test_fast_tucker_backward_scratch(softmax, shape, want):
    """The fast Tucker backward's float32 scratch: e1 and e2 transposed over
    the batch rounded up to 8 and gy in bf16 over the units rounded up to 8;
    lse and r_o for logits; then a dx1 plane for each unit group and column
    chunk and a dx2 plane for each unit group, where there are more than
    one."""
    assert T._tucker_bf16_bwd_scratch(softmax, *shape) == want


@pytest.mark.parametrize("mode", ["bf16", "sr"])
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_fast_tucker_backward_casts_its_float32_sum(op, mode):
    """With a bf16 weight in a fast mode the Tucker backward returns the
    weight's gradient in bf16, the round-to-nearest of the plain version's
    float32 sum (the kernel writes that itself), and the input gradients as
    the plain version gives them; only these instances take the fast Tucker
    kernel's path (``_bf16_tucker_bwd``)."""
    ins = [torch.as_tensor(a) for a in _inputs(op)]
    ins[-1] = ins[-1].to(torch.bfloat16)
    out = T._ENTRIES[op][2](*ins, mode=mode)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    needs = (True, True, True)
    got = T.backward(op, tuple(ins), out, g, needs, mode)
    f32 = T._ENTRIES[op][3](*ins, out, g, needs, mode)
    assert got[-1].dtype == torch.bfloat16 and f32[-1].dtype == torch.float32
    assert torch.equal(got[-1], f32[-1].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got[:-1], f32[:-1]))
    assert T._bf16_tucker_bwd(op, mode, "")
    assert not T._bf16_tucker_bwd(op, "", "") and not T._bf16_tucker_bwd(op, mode, "_f64")
    assert not T._bf16_tucker_bwd(op.replace("tucker2", "matmul"), mode, "")


def test_sr_bits_are_a_stateless_hash():
    """The bits depend on the flat index and the operand's role only, use
    the full 16-bit range, and round a value up with the probability of its
    remainder (here 1/4: a quarter of the bf16 step above 1)."""
    idx = torch.arange(1 << 16, dtype=torch.int64)
    bits = T.sr_bits(idx, T.ROLE_W)
    assert torch.equal(bits, T.sr_bits(idx, T.ROLE_W))
    assert not torch.equal(bits, T.sr_bits(idx, T.ROLE_E))
    assert int(bits.min()) >= 0 and int(bits.max()) < 1 << 16
    assert 0.48 < float(bits.float().mean()) / (1 << 16) < 0.52
    big = T.sr_bits(idx + (1 << 32), T.ROLE_W)  # the high half of the index counts
    assert not torch.equal(bits, big)
    v = torch.full((1 << 16,), 1.0 + 2.0**-9, dtype=torch.float32)  # a quarter step up
    up = (T.round_bf16(v, "sr", T.ROLE_W) > 1.0).double().mean()
    assert 0.24 < float(up) < 0.26
    assert torch.equal(T.round_bf16(v, "bf16", 0), torch.ones_like(v))
    w16 = torch.randn(1000).to(torch.bfloat16).float()  # bf16 values pass through
    assert torch.equal(T.round_bf16(w16, "sr", T.ROLE_W), w16)


@pytest.mark.parametrize("env,mode", [("", ""), ("1", "bf16"), ("yes", "bf16"), ("SR", "sr"),
                                      ("sr", "sr")])
def test_fast_mode_reads_the_variable_as_jax_does(env, mode, monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FAST", env)
    assert T.fast_mode() == mode == J._fast_mode()


@pytest.mark.parametrize("op", OPS)
def test_bf16_weight_gradient_matches_jax_cast(op):
    """f32-grade mode on a bf16 weight: the port's forward equals JAX's
    interpret kernel's within the f32-grade bound, and the weight's gradient
    comes back bf16 from both, equal but for the last bf16 place (both cast
    an f32 sum that differs in its last f32 places)."""
    ins = _inputs(op, seed=7)
    w16 = jnp.asarray(ins[-1]).astype(jnp.bfloat16)
    jargs = [jnp.asarray(a) for a in ins[:-1]]
    jout, jvjp = jax.vjp(lambda w: getattr(J, op)(*jargs, w), w16)
    g = np.random.default_rng(8).normal(size=jout.shape).astype(np.float32)
    (jdw,) = jvjp(jnp.asarray(g))
    ts = [torch.as_tensor(a) for a in ins[:-1]]
    w = torch.as_tensor(np.asarray(w16.astype(jnp.float32))).to(torch.bfloat16).requires_grad_()
    out = getattr(T, op)(*ts, w)
    (dw,) = torch.autograd.grad(out, [w], torch.as_tensor(g))
    assert jdw.dtype == jnp.bfloat16 and dw.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=5e-4, atol=5e-4)
    jdw32 = np.asarray(jdw.astype(jnp.float32))
    np.testing.assert_allclose(dw.float().numpy(), jdw32, rtol=2**-7,
                               atol=1e-3 * np.abs(jdw32).max())


def test_float64_activations_widen_a_bf16_weight():
    """Float64 runs no fast mode; a bf16 weight is widened to float64 and
    its gradient cast back."""
    ins = _inputs("lse_tucker2_softmax")
    x1, x2 = (torch.as_tensor(a, dtype=torch.float64) for a in ins[:2])
    th = torch.as_tensor(ins[2]).to(torch.bfloat16).requires_grad_()
    out = T.lse_tucker2_softmax(x1, x2, th)
    assert out.dtype == torch.float64
    want = T.lse_tucker2_softmax_ref(x1, x2, th.detach().double())
    assert torch.equal(out.detach(), want)
    (dth,) = torch.autograd.grad(out.sum(), [th])
    assert dth.dtype == torch.bfloat16
