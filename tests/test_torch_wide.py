"""The port's wide log-einsum-exp route (contractions of width
``WIDE_WIDTH`` or more: the K1-chunked Tucker forward, the blocked dense
forward and backward) against the JAX package's kernels and fallbacks, on
the CPU, and the port's default device.

The same inputs, made from a seed with numpy, go through both:

- in float32 against the JAX Pallas kernels in interpret mode
  (``_blocked_fwd_call``, ``_blocked_p``, ``_dispatch_tucker_chunked``,
  forced with ``CIRKIT_TPU_FORCE_PALLAS``), to the 5e-4 (forward) and 5e-3
  (backward) of the kernels' bf16x3 dots, as in
  ``tests/ops/test_lse_einsum.py``;
- in float64 against the JAX XLA fallbacks, to rtol 1e-9.

On CPU tensors the wide route runs the plain versions of its kernels (the
blocked ``lse_matmul_blocked_ref``/``lse_matmul_blocked_bwd_ref``; for the
Tucker ops ``lse_tucker2[_softmax]_ref`` and the backward kernel's
``*_bwd_ref``); the kernels themselves are tested on the card
(``test_torch_cuda.py``). ``WIDE_WIDTH`` is patched down so that small
widths take the route, as the JAX tests patch ``_VMEM_BUDGET``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.ops import lse_einsum as J
from cirkit_tpu.parallel.training import split_trainable as jax_split_trainable
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.parallel import split_trainable
from cirkit_tpu_torch.pipeline import PipelineContext


@pytest.fixture(autouse=True)
def _zero_launches():
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0


def _logx(rng, shape, dtype=np.float32):
    return (rng.normal(size=shape) * 3.0 - 2.0).astype(dtype)


def _weights(rng, shape, dtype=np.float32):
    return rng.uniform(0.01, 1.0, size=shape).astype(dtype)


def _logits(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


def _port_vjp(fn, ins, g):
    ts = [torch.as_tensor(a).requires_grad_() for a in ins]
    out = fn(*ts)
    return out.detach().numpy(), [d.numpy() for d in torch.autograd.grad(out, ts,
                                                                          torch.as_tensor(g))]


# --------------------------------------------------------------------------- #
# Kernels 3 and 4: the blocked dense forward and backward
# --------------------------------------------------------------------------- #


def _blocked_cfg(b, i, *, bt=8, ic=128):
    """A blocked-kernel config over (B, I) padded up to the tiles."""
    bp, ip = -(-b // bt) * bt, -(-i // ic) * ic
    return J._BCfg(bt=bt, nbt=bp // bt, ic=ic, nic=ip // ic, interpret=True, fast=""), bp, ip


def _pad(x, w, bp, ip):
    f, b, i = x.shape
    x = jnp.pad(x, ((0, 0), (0, bp - b), (0, ip - i)), constant_values=jnp.finfo(x.dtype).min)
    return x, jnp.pad(w, ((0, 0), (0, 0), (0, ip - i)))


# (F, B, I, O) that no tile of the float32 kernels divides (strips of 64
# columns, 128 batch rows, chunks of 64 units), I odd among them
RAGGED_BLOCKED = [(1, 130, 777, 70), (1, 13, 1000, 1)]


@pytest.mark.parametrize("shape", [(2, 9, 1000, 16), (1, 8, 512, 8), (3, 13, 300, 1),
                                   *RAGGED_BLOCKED])
def test_blocked_forward_matches_pallas_kernel_float32(shape):
    """The port's blocked forward (out and the row max m) against
    ``_blocked_fwd_call`` in interpret mode, ragged batch and width padded
    as ``_dispatch_blocked`` pads them; a row that is all -inf gives -inf."""
    f, b, i, o = shape
    rng = np.random.default_rng(11)
    x, w = _logx(rng, (f, b, i)), _weights(rng, (f, o, i))
    x[0, 2] = -np.inf
    cfg, bp, ip = _blocked_cfg(b, i, bt=16 if b > 8 else 8)
    ref, ref_m = J._blocked_fwd_call(cfg, *_pad(jnp.asarray(x), jnp.asarray(w), bp, ip))
    out, m = T.lse_matmul_blocked_ref(torch.as_tensor(x), torch.as_tensor(w))
    assert out.shape == (f, b, o) and m.shape == (f, b, 1)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m)[:, :b])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :b], rtol=5e-4, atol=5e-4)
    assert np.isneginf(out[0, 2].numpy()).all() and not np.isnan(out.numpy()).any()


@pytest.mark.parametrize("shape", [(1, 8, 512, 8), (2, 16, 384, 16)])
def test_blocked_backward_matches_pallas_kernel_float32(shape):
    """``lse_matmul_blocked_bwd_ref`` against ``jax.vjp`` through
    ``_blocked_p`` (``_blocked_bwd_kernel`` in interpret mode), with a row
    that is all -inf (zero gradients, no NaN) and one whose cotangent is 0."""
    f, b, i, o = shape
    rng = np.random.default_rng(12)
    x, w = _logx(rng, (f, b, i)), _weights(rng, (f, o, i))
    x[0, 3] = -np.inf
    g = rng.normal(size=(f, b, o)).astype(np.float32)
    g[0, 5] = 0.0
    cfg, _, _ = _blocked_cfg(b, i)
    _, vjp = jax.vjp(lambda x, w: J._blocked_p(cfg, x, w), jnp.asarray(x), jnp.asarray(w))
    refs = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    out, m = T.lse_matmul_blocked_ref(xt, wt)
    got = T.lse_matmul_blocked_bwd_ref(xt, wt, out, m, torch.as_tensor(g))
    for name, a, r in zip(("dx", "dw"), got, refs):
        assert not np.isnan(a.numpy()).any() and not np.isnan(r).any(), name
        np.testing.assert_allclose(a.numpy(), r, rtol=5e-3, atol=5e-3, err_msg=name)
    assert (got[0][0, 3] == 0).all() and (got[0][0, 5] == 0).all()
    skip_dx = T.lse_matmul_blocked_bwd_ref(xt, wt, out, m, torch.as_tensor(g), (False, True))
    assert skip_dx[0] is None and torch.equal(skip_dx[1], got[1])


@pytest.mark.parametrize("shape", RAGGED_BLOCKED)
def test_ragged_blocked_backward_matches_pallas_kernel_float32(shape):
    """``lse_matmul_blocked_bwd_ref`` at shapes that no tile divides against
    ``jax.vjp`` through ``_blocked_p`` (``_blocked_bwd_kernel`` in interpret
    mode), the batch and width padded as ``_dispatch_blocked`` pads them."""
    f, b, i, o = shape
    rng = np.random.default_rng(22)
    x, w = _logx(rng, (f, b, i)), _weights(rng, (f, o, i))
    x[0, 3] = -np.inf
    g = rng.normal(size=(f, b, o)).astype(np.float32)
    g[0, 5] = 0.0
    cfg, bp, ip = _blocked_cfg(b, i, bt=16 if b > 8 else 8)
    xp, wp = _pad(jnp.asarray(x), jnp.asarray(w), bp, ip)
    gp = jnp.pad(jnp.asarray(g), ((0, 0), (0, bp - b), (0, 0)))
    _, vjp = jax.vjp(lambda x, w: J._blocked_p(cfg, x, w), xp, wp)
    refs = [np.asarray(d) for d in vjp(gp)]
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    out, m = T.lse_matmul_blocked_ref(xt, wt)
    got = T.lse_matmul_blocked_bwd_ref(xt, wt, out, m, torch.as_tensor(g))
    for name, a, r in zip(("dx", "dw"), got, (refs[0][:, :b, :i], refs[1][:, :, :i])):
        assert not np.isnan(a.numpy()).any() and not np.isnan(r).any(), name
        np.testing.assert_allclose(a.numpy(), r, rtol=5e-3, atol=5e-3, err_msg=name)
    assert (got[0][0, 3] == 0).all() and (got[0][0, 5] == 0).all()


@pytest.mark.parametrize("op", ["lse_matmul", "lse_matmul_softmax"])
def test_wide_dense_route_matches_jax_fallback_float64(op, monkeypatch):
    """At wide I the port's ``lse_matmul`` takes the blocked route (and
    ``lse_matmul_softmax`` normalizes, then takes it): forward and backward
    against the JAX XLA fallback in float64."""
    _dense_route_matches_jax_float64(op, (2, 13, 96, 5), monkeypatch)


@pytest.mark.parametrize("shape", RAGGED_BLOCKED)
@pytest.mark.parametrize("op", ["lse_matmul", "lse_matmul_softmax"])
def test_ragged_wide_dense_route_matches_jax_fallback_float64(op, shape, monkeypatch):
    """The same at shapes that no tile of the float32 kernels divides."""
    _dense_route_matches_jax_float64(op, shape, monkeypatch)


def _dense_route_matches_jax_float64(op, shape, monkeypatch):
    monkeypatch.setattr(T, "WIDE_WIDTH", 64)
    rng = np.random.default_rng(13)
    f, b, i, o = shape
    w = _logits if "softmax" in op else _weights
    ins = [_logx(rng, (f, b, i), np.float64), w(rng, (f, o, i), np.float64)]
    g = rng.normal(size=(f, b, o))
    ref, vjp = jax.vjp(getattr(J, op), *(jnp.asarray(a) for a in ins))
    refs = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    calls = []
    blocked_ref = T.lse_matmul_blocked_ref
    monkeypatch.setattr(T, "lse_matmul_blocked_ref",
                        lambda *a: calls.append(1) or blocked_ref(*a))
    out, grads = _port_vjp(getattr(T, op), ins, g)
    assert calls == [1]
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-9, atol=1e-12)
    for a, r in zip(grads, refs):
        np.testing.assert_allclose(a, r, rtol=1e-9, atol=1e-12 * np.abs(r).max())
    assert all(n == 0 for n in T.LAUNCHES.values())


# --------------------------------------------------------------------------- #
# Kernel 5: the K1-chunked Tucker forward
# --------------------------------------------------------------------------- #


def _tucker_inputs(shape, softmax, seed=7, dtype=np.float32):
    f, b, k1, k2, o = shape
    rng = np.random.default_rng(seed)
    th = (_logits if softmax else _weights)(rng, (f, o, k1 * k2), dtype)
    return [_logx(rng, (f, b, k1), dtype), _logx(rng, (f, b, k2), dtype), th]


def _tucker_op(softmax):
    return T.lse_tucker2_softmax if softmax else T.lse_tucker2


@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
@pytest.mark.parametrize(
    "shape", [(2, 8, 16, 16, 8), (2, 16, 128, 128, 64), (1, 13, 128, 64, 16),
              (1, 8, 256, 128, 32), (1, 13, 48, 16, 70)]
)
def test_chunked_tucker_matches_pallas_kernel_float32(shape, softmax, monkeypatch):
    """The port's wide Tucker route against ``_dispatch_tucker_chunked`` in
    interpret mode (``_ct_fwd_kernel``: kc=8, nkc=2 at K1=K2=16), the
    shapes of ``tests/ops/test_lse_einsum.py:817-820`` among them."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.setattr(T, "WIDE_WIDTH", 256)
    ins = _tucker_inputs(shape, softmax)
    ref = J._dispatch_tucker_chunked((jnp.asarray(ins[0]), jnp.asarray(ins[1])),
                                     jnp.asarray(ins[2]), softmax=softmax, interpret=True)
    assert ref is not None, "the chunked kernel must engage at these shapes"
    calls = []
    key = "lse_tucker2_softmax_chunked" if softmax else "lse_tucker2_chunked"
    entry, bwd_entry, plain, bwd_plain = T._ENTRIES[key]
    monkeypatch.setitem(T._ENTRIES, key, (entry, bwd_entry,
                                          lambda *a: calls.append(1) or plain(*a), bwd_plain))
    with torch.no_grad():
        out = _tucker_op(softmax)(*(torch.as_tensor(a) for a in ins))
    assert calls == [1] and out.shape == (shape[0], shape[1], shape[4])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
def test_chunked_tucker_backward_matches_jax_float32(softmax, monkeypatch):
    """The wide Tucker route's backward (the backward kernel's plain
    version) against ``jax.vjp`` through ``_dispatch_tucker_chunked``, whose
    VJP is the XLA ``_ct_p_bwd``; a row of x1 that is all -inf gets zero
    input gradients and no NaN."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.setattr(T, "WIDE_WIDTH", 256)
    x1, x2, th = _tucker_inputs((2, 8, 16, 16, 8), softmax, seed=8)
    x1[1, 4] = -np.inf
    g = np.random.default_rng(9).normal(size=(2, 8, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, w: J._dispatch_tucker_chunked((a, b), w, softmax=softmax,
                                                                interpret=True),
                     *(jnp.asarray(a) for a in (x1, x2, th)))
    refs = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    _, grads = _port_vjp(_tucker_op(softmax), [x1, x2, th], g)
    for name, a, r in zip(("dx1", "dx2", "dw"), grads, refs):
        assert not np.isnan(a).any() and not np.isnan(r).any(), name
        np.testing.assert_allclose(a, r, rtol=5e-3, atol=5e-3, err_msg=name)
    assert (grads[0][1, 4] == 0).all() and (grads[1][1, 4] == 0).all()


@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
def test_chunked_tucker_matches_jax_fallback_float64(softmax, monkeypatch):
    """The wide Tucker route, forward and backward, against the JAX XLA
    fallback (``lse_tucker2[_softmax]`` with Pallas off) in float64, at
    K1 != K2 with a K1 that the JAX chunk sizes do not divide."""
    _tucker_route_matches_jax_float64(softmax, (2, 5, 13, 6, 3), monkeypatch)


@pytest.mark.parametrize("shape", [(1, 130, 99, 600, 70), (2, 13, 7, 129, 1)])
@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
def test_ragged_chunked_tucker_matches_jax_fallback_float64(softmax, shape, monkeypatch):
    """The same at shapes that no tile of the float32 kernel divides (128
    batch rows and units, chunks of 32 columns j): K2 = 600, an odd K2."""
    _tucker_route_matches_jax_float64(softmax, shape, monkeypatch)


def _tucker_route_matches_jax_float64(softmax, shape, monkeypatch):
    monkeypatch.setattr(T, "WIDE_WIDTH", 64)
    ins = _tucker_inputs(shape, softmax, seed=10, dtype=np.float64)
    g = np.random.default_rng(11).normal(size=(*shape[:2], shape[4]))
    jop = J.lse_tucker2_softmax if softmax else J.lse_tucker2
    ref, vjp = jax.vjp(jop, *(jnp.asarray(a) for a in ins))
    refs = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    out, grads = _port_vjp(_tucker_op(softmax), ins, g)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-9, atol=1e-12)
    for a, r in zip(grads, refs):
        np.testing.assert_allclose(a, r, rtol=1e-9, atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("softmax", [False, True], ids=["plain", "softmax"])
def test_chunked_tucker_neg_inf_rows_and_chunks_give_no_nan(softmax, monkeypatch):
    """A row of x1 that is all -inf gives -inf; a K1-chunk of logits that is
    all -inf (or a chunk of zero weights) leaves the rest finite, as in the
    JAX chunked kernel."""
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    monkeypatch.setattr(T, "WIDE_WIDTH", 256)
    x1, x2, th = _tucker_inputs((2, 8, 16, 16, 8), softmax, seed=12)
    x1[0, 3] = -np.inf
    th[1, 2, :128] = -np.inf if softmax else 0.0  # the first of two chunks (kc = 8)
    ref = np.asarray(J._dispatch_tucker_chunked(
        (jnp.asarray(x1), jnp.asarray(x2)), jnp.asarray(th), softmax=softmax, interpret=True))
    out = _tucker_op(softmax)(*(torch.as_tensor(a) for a in (x1, x2, th))).numpy()
    assert not np.isnan(out).any() and not np.isnan(ref).any()
    assert np.isneginf(out[0, 3]).all() and np.isneginf(ref[0, 3]).all()
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(out))
    np.testing.assert_allclose(out[finite], ref[finite], rtol=5e-4, atol=5e-4)


# --------------------------------------------------------------------------- #
# The float32 blocked backward's scratch
# --------------------------------------------------------------------------- #


def test_blocked_gy_scratch_holds_the_tf32_planes_in_float32():
    """The blocked backward's gy scratch: (F, B, O) for the float64 kernel,
    twice that (a plane of TF32 high parts and one of low parts) for the
    float32 one."""
    assert T._blocked_gy_shape(3, 130, 70, "_f64") == (3, 130, 70)
    assert T._blocked_gy_shape(3, 130, 70, "") == (3, 130, 70, 2)


# --------------------------------------------------------------------------- #
# The slice: a small Tucker circuit through the wide route
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("optimize", [True, False], ids=["optimized", "folded"])
def test_slice_through_wide_route_matches_jax_float64(optimize, monkeypatch):
    """A 4x4 QuadGraph Tucker circuit at K=8, with the wide width lowered to
    64 so its Tucker entries (K1*K2 = 64, ``optimize=True``) or its sums
    over Kronecker products (I = 64, ``optimize=False``) take the wide
    route: the forward and the gradient of every learnable slot against
    JAX's compile of the same circuit in float64, the store carried over by
    slot name."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 64)
    kw = dict(input_layer="categorical", num_input_units=8, sum_product_layer="tucker",
              num_sum_units=8)
    flags = dict(semiring="lse-sum", fold=True, optimize=optimize)
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-graph", **kw))
    jstore = {s: jnp.asarray(v, jnp.float64) for s, v in jctx.parameters.items()}
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(image_data((1, 4, 4), "quad-graph", **kw))
    ctx.load_parameters({s: np.asarray(v) for s, v in jstore.items()})
    x = np.random.default_rng(0).integers(0, 256, (16, 16))

    jtr, jfr = jax_split_trainable(jcc, jstore)
    jll = jax.jit(jcc.evaluate)({**jtr, **jfr}, jnp.asarray(x))
    jgrads = jax.jit(jax.grad(lambda tr: -jnp.mean(jcc.evaluate({**tr, **jfr},
                                                                 jnp.asarray(x)))))(jtr)

    calls = {"chunked": 0, "blocked": 0}
    for key in ("lse_tucker2_chunked", "lse_tucker2_softmax_chunked"):
        entry, bwd_entry, plain, bwd_plain = T._ENTRIES[key]

        def spy(*a, plain=plain):
            calls["chunked"] += 1
            return plain(*a)

        monkeypatch.setitem(T._ENTRIES, key, (entry, bwd_entry, spy, bwd_plain))
    blocked_ref = T.lse_matmul_blocked_ref

    def blocked_spy(*a):
        calls["blocked"] += 1
        return blocked_ref(*a)

    monkeypatch.setattr(T, "lse_matmul_blocked_ref", blocked_spy)
    tr, fr = split_trainable(cc, ctx.parameters)
    assert set(tr) == set(jtr)
    ll = cc.evaluate({**tr, **fr}, torch.as_tensor(x))
    grads = dict(zip(tr, torch.autograd.grad(-ll.mean(), list(tr.values()))))
    assert (calls["chunked"] > 0) == optimize and (calls["blocked"] > 0) != optimize
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(jll), rtol=1e-9)
    for s, gr in grads.items():
        ref = np.asarray(jgrads[s])
        np.testing.assert_allclose(gr.numpy(), ref, rtol=0, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=s)
    assert all(n == 0 for n in T.LAUNCHES.values())


# --------------------------------------------------------------------------- #
# The default device
# --------------------------------------------------------------------------- #


def test_default_device_is_cuda_or_raises(monkeypatch):
    """``PipelineContext()`` runs on the CUDA card; without one it raises
    and says to pass ``device="cpu"``, which works; the compiler takes its
    device from the context and has no default of its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PipelineContext(semiring="lse-sum", fold=True, optimize=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PipelineContext(device="cuda")
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu")
    cc = ctx.compile(image_data((1, 4, 4), "quad-graph", input_layer="categorical",
                                num_input_units=2, sum_product_layer="cp", num_sum_units=2))
    assert ctx.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in ctx.parameters.values())
    with torch.no_grad():
        assert torch.isfinite(cc(torch.zeros((2, 16), dtype=torch.long))).all()
    with pytest.raises(TypeError, match="device"):
        TorchCompiler(semiring="lse-sum")
