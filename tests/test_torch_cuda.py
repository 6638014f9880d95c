"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has a card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each forward entry is held against its plain PyTorch version on the same
CUDA tensors, to ``1e-4 + 1e-5 |plain|`` in log space (f32 FMAs sum in
another order than cuBLAS); each backward entry against its plain version
(``*_bwd_ref``) to ``1e-4 max|plain| + 1e-4 |plain|`` per gradient (linear
sums of up to B or O*K2 terms). The max-product Tucker kernel is held
against its plain version to ``1e-5 |plain| + 1e-5``, the routing choice
by the plain score of the index it picks, and the routing draws by their
frequencies against ``softmax(scores)``. The wide kernels (the K1-chunked
Tucker forward, the blocked dense forward and backward) are held against
their plain versions with the same bounds, at small widths with
``WIDE_WIDTH`` patched down and at the K=128 entry shapes. The signed
kernels are held against their plain versions in linear space scaled by
each row's absolute mass (a sum that nearly cancels has no accurate
log-magnitude in f32), at small widths and at the SoS TensorDot entry. The
complex kernels are held the same way on the real and imaginary parts, in
complex64 and complex128, and the float64 instances of the single-pass lse
and signed kernels to 1e-10 in log space (1e-12 of the row's mass) and
``1e-9 (max|plain| + |plain|)`` backward. A
small circuit's forward, its gradients and its queries through the
kernels, and a small squared circuit's, are held against the same store
evaluated in float64 on the CPU.
"""

import numpy as np
import pytest
import torch

from cirkit_tpu_torch.backend.torch.layers import TorchSumLayer
from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.pipeline import PipelineContext

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0


def _inputs(op, f, b, o, k1=8, k2=16, i=32):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def logx(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 3.0 - 2.0

    width = k1 * k2 if "tucker" in op else i
    xs = [logx(f, b, k1), logx(f, b, k2)] if "tucker" in op else [logx(f, b, i)]
    if "softmax" in op:
        w = torch.randn((f, o, width), generator=gen, device="cuda")
    else:
        w = torch.rand((f, o, width), generator=gen, device="cuda") * 0.99 + 0.01
    return [*xs, w]


OPS = ["lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax"]


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70)])
@pytest.mark.parametrize("op", OPS)
def test_kernel_matches_plain(op, f, b, o):
    ins = _inputs(op, f, b, o)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    out = getattr(T, op)(*ins)
    ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1
    assert not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    assert torch.isneginf(out[0, 2]).all()
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-4 + 1e-5 * ref[finite].abs()).all()), float(err.max())


def _close(got, ref, *, zeros=False):
    """The backward bound: ``|kernel - plain| <= 1e-4 max|plain| + 1e-4 |plain|``;
    with ``zeros``, 0 wherever the plain version gives 0 (the input
    gradients' rows of -inf inputs or of zero cotangent)."""
    assert got.shape == ref.shape and not torch.isnan(got).any()
    assert not zeros or bool((got[ref == 0] == 0).all())
    err = (got - ref).abs()
    bound = 1e-4 * ref.abs().max() + 1e-4 * ref.abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70)])
@pytest.mark.parametrize(
    "op,k1,k2",  # K2 = 64: the Tucker dx kernel's s tiles each lie in one K1 segment
    [(op, 8, 16) for op in OPS] + [(op, 4, 64) for op in OPS if "tucker" in op],
)
def test_backward_kernel_matches_plain(op, k1, k2, f, b, o):
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[1, 3:5] = 0.0  # rows whose upstream gradient is 0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, ref) in enumerate(zip(grads, refs)):
        _close(got, ref, zeros=k < len(ins) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()


@pytest.mark.parametrize("op", ["lse_matmul_softmax", "lse_tucker2_softmax"])
def test_backward_skips_what_needs_no_gradient(op):
    ins = _inputs(op, 2, 8, 16)
    ins[-1].requires_grad_()  # the weight only: the inputs need no gradient
    out = getattr(T, op)(*ins)
    (dw,) = torch.autograd.grad(out.sum(), [ins[-1]])
    with torch.no_grad():
        ref = getattr(T, f"{op}_bwd_ref")(*ins, out, torch.ones_like(out))[-1]
    _close(dw, ref)
    assert T.LAUNCHES[f"{op}_bwd"] == 1


def test_backward_is_deterministic():
    ins = [t.requires_grad_() for t in _inputs("lse_tucker2_softmax", 3, 130, 70)]
    out = T.lse_tucker2_softmax(*ins)
    first = torch.autograd.grad(out.sum(), ins, retain_graph=True)
    again = torch.autograd.grad(out.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w = _inputs("lse_matmul", 2, 8, 16)
    with pytest.raises(TypeError, match="float64"):  # one type for every operand
        T.lse_matmul(x.double(), w)
    with pytest.raises(TypeError, match="float32"):
        T.lse_matmul(x, w.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.lse_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="operands on"):
        T.lse_matmul(x, w.cpu())
    assert T.LAUNCHES["lse_matmul"] == 0


def _flagship_like(spl, device, em_ready=False):
    kw = dict(input_layer="categorical", num_input_units=8, sum_product_layer=spl,
              num_sum_units=8, em_ready=em_ready)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=0, device=device)
    return ctx, ctx.compile(image_data((1, 8, 8), "quad-graph", **kw))


@pytest.mark.parametrize("spl,em_ready", [("cp", False), ("tucker", False), ("tucker", True)])
def test_small_circuit_train_step_through_the_kernels(spl, em_ready):
    """One Adam step of ``data_parallel_step`` on the card: the gradients of
    every learnable slot against the same store's float64 CPU gradients, to
    ``2e-3 max|slot| + 1e-5``: f32 log-values near the log-likelihood of
    -360 round at 3e-5, which becomes relative error of the gradients, and
    the softmax VJP leaves an absolute floor near the root (the plain f32
    composition on the CPU stays within a fifth of this bound)."""
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable

    ctx, cc = _flagship_like(spl, "cuda", em_ready)
    x = np.random.default_rng(0).integers(0, 256, (16, 64))
    ctx_cpu, cc_cpu = _flagship_like(spl, "cpu", em_ready)
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    ref_loss = -cc_cpu(torch.as_tensor(x)).mean()
    ref_grads = dict(zip(ctx_cpu.parameters.keys(),
                         torch.autograd.grad(ref_loss, list(ctx_cpu.parameters.values()))))

    trainable, frozen = split_trainable(cc, ctx.parameters)
    trainable = {k: v.detach().clone().requires_grad_() for k, v in trainable.items()}
    opt = torch.optim.Adam(list(trainable.values()), lr=1e-2)
    step = data_parallel_step(cc, opt)
    loss = step(trainable, frozen, torch.as_tensor(x, device="cuda"))
    torch.cuda.synchronize()
    n_kernel = sum(isinstance(l, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer))
                   for l in cc.layers)
    assert sum(n for op, n in T.LAUNCHES.items() if op.endswith("_bwd")) == n_kernel
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k, p in trainable.items():
        ref = ref_grads[k].numpy()
        got = p.grad.double().cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max() + 1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("spl", ["cp", "tucker"])
def test_small_circuit_through_the_kernels(spl):
    shape = (1, 8, 8)
    kw = dict(input_layer="categorical", num_input_units=8, sum_product_layer=spl,
              num_sum_units=8)
    flags = dict(semiring="lse-sum", fold=True, optimize=True, seed=0)
    ctx = PipelineContext(**flags, device="cuda")
    cc = ctx.compile(image_data(shape, "quad-graph", **kw))
    x = np.random.default_rng(0).integers(0, 256, (16, 64))
    with torch.inference_mode():
        out = cc(torch.as_tensor(x, device="cuda"))
    n_kernel = sum(isinstance(l, (TorchSumLayer, TorchCPTLayer, TorchTuckerLayer))
                   for l in cc.layers)
    assert sum(T.LAUNCHES.values()) == n_kernel
    ctx_cpu = PipelineContext(**flags, device="cpu")
    cc_cpu = ctx_cpu.compile(image_data(shape, "quad-graph", **kw))
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    with torch.inference_mode():
        ref = cc_cpu(torch.as_tensor(x))
    np.testing.assert_allclose(out.double().cpu().numpy(), ref.numpy(), rtol=1e-5)


# --------------------------------------------------------------------------- #
# The routing kernels (csrc/tucker_route.cu) and the queries
# --------------------------------------------------------------------------- #


def _route_inputs(f, b, k1, k2, o, log_weights, seed=0, edges=True):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn((f, b, k1), generator=gen, device="cuda") * 3.0 - 2.0
    x2 = torch.randn((f, b, k2), generator=gen, device="cuda") * 3.0 - 2.0
    th = (torch.randn((f, o, k1 * k2), generator=gen, device="cuda") if log_weights
          else torch.rand((f, o, k1 * k2), generator=gen, device="cuda") * 0.99 + 0.01)
    if edges:
        x1[0, 1] = float("-inf")  # a row of -inf children
        if not log_weights:
            th[:, :, 3] = 0.0  # zero weights never win
    sel = torch.randint(-1, o, (f, b), generator=gen, device="cuda")
    return x1, x2, th, sel


ROUTE_SHAPES = [(3, 8, 16, 16, 16), (3, 13, 8, 16, 1), (2, 130, 16, 8, 70), (2, 5, 3, 5, 3)]


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_tropical_kernel_matches_plain(f, b, k1, k2, o, log_weights):
    """``|kernel - plain| <= 1e-5 |plain| + 1e-5`` (the kernel subtracts the
    softmax normalizer after the max, the plain version before)."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, _ = _route_inputs(f, b, k1, k2, o, log_weights)
    out = R.tropical_tucker2(x1, x2, th, log_weights=log_weights)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    torch.cuda.synchronize()
    assert T.LAUNCHES["tropical_tucker2"] == 1
    assert not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    assert torch.isneginf(out[0, 1]).all()
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-5 + 1e-5 * ref[finite].abs()).all()), float(err.max())


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_route_kernel_matches_plain_by_score(f, b, k1, k2, o, log_weights):
    """The plain scores at the kernel's index lie within ``1e-5 |max| + 1e-5``
    of the plain maximum (f32 rounding may flip a near-tie)."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = _route_inputs(f, b, k1, k2, o, log_weights)
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=log_weights)
    scores = R.route_scores(x1, x2, th, sel, log_weights=log_weights)
    torch.cuda.synchronize()
    assert T.LAUNCHES["route_tucker2"] == 1
    assert idx.dtype == torch.int64 and idx.shape == (f, b)
    best = scores.amax(dim=-1)
    at = torch.gather(scores, -1, idx[..., None])[..., 0]
    assert bool(((at >= best - (1e-5 * best.abs() + 1e-5)) | torch.isneginf(best)).all())
    if not log_weights:
        assert bool((idx != 3).all())


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_route_kernel_sample_frequencies(log_weights):
    """Gumbel draws over 65,536 identical rows against ``softmax(scores)``,
    each frequency within ``5 sqrt(p (1 - p) / N) + 1e-3``; one seed gives
    the same draws, another seed others."""
    from cirkit_tpu_torch.ops import routing as R

    n = 65536
    x1, x2, th, _ = _route_inputs(2, 1, 4, 4, 8, log_weights, seed=3, edges=False)
    sel = torch.tensor([[3], [6]], device="cuda")
    p = torch.softmax(R.route_scores(x1.double(), x2.double(), th.double(), sel,
                                     log_weights=log_weights)[:, 0], dim=-1)
    rows = [t.expand(-1, n, -1).contiguous() for t in (x1, x2)]
    sel_rows = sel.expand(-1, n).contiguous()
    idx = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=99)
    again = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=99)
    other = R.route_tucker2(*rows, th, sel_rows, kind="sample", log_weights=log_weights, seed=98)
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    for ff in range(2):
        freq = torch.bincount(idx[ff], minlength=16).double() / n
        bound = 5 * torch.sqrt(p[ff] * (1 - p[ff]) / n) + 1e-3
        assert bool(((freq - p[ff]).abs() <= bound).all()), (freq, p[ff])


def test_route_wrapper_refuses_what_the_kernel_does_not_take():
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = _route_inputs(2, 8, 4, 4, 4, True)
    with pytest.raises(TypeError, match="int64"):
        R.route_tucker2(x1, x2, th, sel.int(), kind="max", log_weights=True)
    with pytest.raises(TypeError, match="float64"):  # one type for every operand
        R.tropical_tucker2(x1.double(), x2, th, log_weights=True)
    assert T.LAUNCHES["route_tucker2"] == T.LAUNCHES["tropical_tucker2"] == 0


def test_small_circuit_queries_through_the_kernels():
    """MAP, marginals and conditional sampling of a small Tucker circuit on
    the card against the same store in float64 on the CPU (rtol 1e-5), with
    one tropical and one route launch per Tucker entry for MAP."""
    from cirkit_tpu_torch.backend.torch import IntegrateQuery, MAPQuery, SamplingQuery

    ctx, cc = _flagship_like("tucker", "cuda")
    ctx_cpu, cc_cpu = _flagship_like("tucker", "cpu")
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    n_tucker = sum(isinstance(l, TorchTuckerLayer) and l.arity == 2 for l in cc.layers)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (16, 64))
    mask = rng.random((16, 64)) < 0.5
    xc, mc = torch.as_tensor(x, device="cuda"), torch.as_tensor(mask, device="cuda")
    asg, val = MAPQuery(cc)(xc, evidence_mask=mc)
    torch.cuda.synchronize()
    assert T.LAUNCHES["tropical_tucker2"] == T.LAUNCHES["route_tucker2"] == n_tucker
    want_asg, want_val = MAPQuery(cc_cpu)(x, evidence_mask=mask)
    np.testing.assert_allclose(val.double().cpu().numpy(), want_val.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(asg.cpu().numpy()[mask], x[mask])
    got = IntegrateQuery(cc)(xc, integrate_vars=mc)
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               IntegrateQuery(cc_cpu)(x, integrate_vars=mask).numpy(), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    samples, log_ev = SamplingQuery(cc).conditional(xc, evidence_mask=mc, generator=gen)
    _, want_ev = SamplingQuery(cc_cpu).conditional(x, evidence_mask=mask, generator=gen)
    np.testing.assert_allclose(log_ev.double().cpu().numpy(), want_ev.numpy(), rtol=1e-5)
    s = samples.cpu().numpy()
    np.testing.assert_array_equal(s[mask], x[mask])
    assert ((s >= 0) & (s <= 255)).all()
    assert T.LAUNCHES["route_tucker2"] == 2 * n_tucker


# --------------------------------------------------------------------------- #
# The wide kernels (csrc/lse_wide.cu)
# --------------------------------------------------------------------------- #


def _fwd_close(out, ref):
    """The forward bound, with the same -inf pattern and no NaN."""
    assert out.shape == ref.shape and not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-4 + 1e-5 * ref[finite].abs()).all()), float(err.max())


# (F, B, K1, K2, O): one K1-chunk of 512 columns or several (K2=16: two of
# 32 rows; K2=24: 21 rows and a ragged 19; K2=600: one row a chunk)
CHUNKED_CASES = [(3, 8, 64, 16, 16), (3, 13, 9, 5, 1), (2, 130, 40, 24, 70), (1, 8, 3, 600, 9)]


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("f,b,k1,k2,o", CHUNKED_CASES)
def test_chunked_tucker_kernel_matches_plain(op, f, b, k1, k2, o, monkeypatch):
    """The K1-chunked Tucker forward against its plain version, with a row
    that is all -inf and a first chunk of logits that is all -inf (zero
    weights without softmax); the backward is the Tucker backward kernel,
    whose float32 dx kernel takes any K1 and K2 (K2=600: ten column tiles)."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")
    chunk = max(1, 512 // k2) * k2
    if chunk < k1 * k2:  # not the whole row: its softmax would be NaN
        ins[-1][0, 0, :chunk] = float("-inf") if "softmax" in op else 0.0
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_chunked"] == 1 and T.LAUNCHES[op] == 0
    _fwd_close(out.detach(), ref)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    assert T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _close(got, r, zeros=k < len(refs) - 1)


# (F, B, I, O): I a multiple of the 256-column chunk or not, ragged B, O=1
BLOCKED_CASES = [(3, 8, 1000, 16), (3, 13, 300, 1), (2, 130, 777, 70), (1, 5, 512, 64)]


@pytest.mark.parametrize("f,b,i,o", BLOCKED_CASES)
def test_blocked_kernels_match_plain(f, b, i, o, monkeypatch):
    """The blocked forward (out and its row max) and backward against their
    plain versions, with a row that is all -inf, a row whose first chunk is
    all -inf and a row whose cotangent is 0; the backward twice, equal."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x[0, 2] = float("-inf")
    x[-1, 1, :256] = float("-inf")
    with torch.no_grad():
        ref, ref_m = T.lse_matmul_blocked_ref(x, w)
        got, got_m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got_m, ref_m)
    _fwd_close(got, ref)
    x, w = x.requires_grad_(), w.requires_grad_()
    out = T.lse_matmul(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[0, 1] = 0.0
    grads = torch.autograd.grad(out, [x, w], g, retain_graph=True)
    again = torch.autograd.grad(out, [x, w], g)
    with torch.no_grad():
        refs = T.lse_matmul_blocked_bwd_ref(x, w, out, ref_m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2 and T.LAUNCHES["lse_matmul"] == 0
    assert T.LAUNCHES["lse_matmul_blocked_bwd"] == 2
    for k, (a, r) in enumerate(zip(grads, refs)):
        _close(a, r, zeros=k == 0)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    assert (grads[0][0, 2] == 0).all() and (grads[0][0, 1] == 0).all()


def test_wide_softmax_matmul_normalizes_then_takes_the_blocked_kernels(monkeypatch):
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, th = [t.requires_grad_() for t in _inputs("lse_matmul_softmax", 2, 8, 16, i=300)]
    out = T.lse_matmul_softmax(x, th)
    _fwd_close(out.detach(), T.lse_matmul_softmax_ref(x, th).detach())
    out.sum().backward()
    assert T.LAUNCHES["lse_matmul_blocked"] == T.LAUNCHES["lse_matmul_blocked_bwd"] == 1
    assert T.LAUNCHES["lse_matmul_softmax"] == T.LAUNCHES["lse_matmul_softmax_bwd"] == 0
    with torch.no_grad():
        ref = T.lse_matmul_softmax_bwd_ref(x, th, out, torch.ones_like(out))
    _close(x.grad, ref[0], zeros=True)
    _close(th.grad, ref[1])


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax", "lse_matmul"])
def test_wide_kernels_at_the_k128_entry_shapes(op):
    """Once at the K=128 entries (F=784, B=128, K1=K2=O=128; dense I=16384),
    where WIDE_WIDTH routes them unpatched: the wide forward and its
    backward (the Tucker backward kernel, or the blocked one) against
    their plain versions."""
    f, b, k = 784, 128, 128
    ins = _inputs(op, f, b, k, k1=k, k2=k, i=k * k)
    out = getattr(T, op)(*ins)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    if op == "lse_matmul":
        ref, m = T.lse_matmul_blocked_ref(*ins)
        _fwd_close(out, ref)
        del ref
        grads = T._launch_blocked_bwd(*ins, out, m, g, (True, True))
        refs = T.lse_matmul_blocked_bwd_ref(*ins, out, m, g)
    else:
        _fwd_close(out, getattr(T, f"{op}_ref")(*ins))
        grads = T.backward(op, tuple(ins), out, g)
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    fwd_key = "lse_matmul_blocked" if op == "lse_matmul" else f"{op}_chunked"
    assert T.LAUNCHES[fwd_key] == 1 and T.LAUNCHES[op] == 0
    for a, r in zip(grads, refs):
        _close(a, r)


# --------------------------------------------------------------------------- #
# The signed kernels (the SIGNED instances of csrc/lse_einsum*.cu)
# --------------------------------------------------------------------------- #

SIGNED_OPS = ["slse_matmul", "slse_matmul_softmax", "slse_tucker2", "slse_tucker2_softmax"]


def _signed_inputs(op, f, b, o, k1=8, k2=16, i=32):
    """(log-magnitude, sign) inputs with signs in {-1, 0, +1} and weights of
    both signs (or logits)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ins = []
    for k in ((k1, k2) if "tucker" in op else (i,)):
        ins += [torch.randn((f, b, k), generator=gen, device="cuda") * 3.0 - 2.0,
                torch.randint(-1, 2, (f, b, k), generator=gen, device="cuda").float()]
    width = k1 * k2 if "tucker" in op else i
    ins.append(torch.randn((f, o, width), generator=gen, device="cuda"))
    return ins


def _signed_close(op, ins, got, ref, tol=1e-5):
    """The forward bound of chip_smoke's phase 3d: in linear space scaled by
    the row's absolute mass A, ``|s exp(a - A) - s' exp(a' - A)| <= tol``;
    signs equal above the bound; (-inf, 0) where the mass is 0."""
    (ga, gs), (pa, ps) = got, ref
    *xs, w = ins
    wabs = torch.softmax(w, dim=-1) if "softmax" in op else w.abs()
    mass = (T.lse_tucker2_ref(xs[0], xs[2], wabs) if "tucker" in op
            else T.lse_matmul_ref(xs[0], wabs))
    assert not torch.isnan(ga).any() and not torch.isnan(gs).any()
    empty = torch.isneginf(mass)
    assert torch.isneginf(ga[empty]).all() and (gs[empty] == 0).all()
    lin_k = torch.where(empty, 0.0, gs * torch.exp(ga - mass))
    lin_p = torch.where(empty, 0.0, ps * torch.exp(pa - mass))
    assert float((lin_k - lin_p).abs().max()) <= tol
    assert not bool(((gs != ps) & (lin_p.abs() > tol)).any())


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70), (144, 4096, 32)])
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_kernels_match_plain(op, f, b, o):
    """Forward and backward of each signed entry against its plain versions,
    with a row that is all -inf and a cotangent that is 0 on some rows; the
    last shape is the SoS TensorDot entry (B*Kq = 4096, I = O = 32)."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    if "tucker" in op and f == 144:
        f, b, o = 8, 512, 64  # the Tucker configurations at a larger batch instead
    ins = _signed_inputs(op, f, b, o)
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert not os_.requires_grad
    with torch.no_grad():
        ref = getattr(S, f"{op}_ref")(*ins)
    _signed_close(op, [t.detach() for t in ins], (oa.detach(), os_), ref)
    assert torch.isneginf(oa[0, 2]).all() and (os_[0, 2] == 0).all()
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[1, :3] = 0.0
    diff = [t for t in ins if t.requires_grad]
    grads = torch.autograd.grad(oa, diff, g)
    with torch.no_grad():  # on the kernel's own outputs: g / y is ill-conditioned near y = 0
        refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                if r is not None]
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _close(got, r, zeros=k < len(refs) - 1)
    assert (grads[0][0, 2] == 0).all()


@pytest.mark.parametrize("op", SIGNED_OPS)
def test_signed_exact_cancellation(op):
    """Equal magnitudes with alternating signs against equal weights: y = 0
    exactly gives (-inf, sign 0) and zero gradients, never NaN."""
    from cirkit_tpu_torch.ops import slse_einsum as S

    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(8)
    if "tucker" in op:
        ins = [torch.zeros(1, 8, 4, device="cuda"), alt[:4].expand(1, 8, 4).contiguous(),
               torch.zeros(1, 8, 4, device="cuda"), torch.ones(1, 8, 4, device="cuda")]
    else:
        ins = [torch.zeros(1, 8, 16, device="cuda"), alt.expand(1, 8, 16).contiguous()]
    ins.append((torch.zeros if "softmax" in op else torch.ones)(1, 8, 16, device="cuda"))
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert torch.isneginf(oa).all() and (os_ == 0).all()
    grads = torch.autograd.grad(oa, [t for t in ins if t.requires_grad], torch.ones_like(oa))
    assert all(bool((gr == 0).all()) for gr in grads)


def test_small_squared_circuit_through_the_kernels():
    """bench.py's SoS circuit at 6x6, K=8 on the card: one slse_matmul launch
    per TensorDot entry, and the forward of sq and zc against the same
    store in float64 on the CPU: zc to rtol 1e-5, sq to 1e-3 (its f32
    evaluation squares each sum's cancellation: the plain f32 composition
    on the CPU is off float64 by 1e-4 here; see chip_smoke's SOS_SQ_RTOL)."""
    from cirkit_tpu_torch.backend.torch.optimized import TorchTensorDotLayer
    from cirkit_tpu_torch.models.utils import Parameterization

    def build(device):
        sc = image_data((1, 6, 6), "quad-tree-2", input_layer="categorical", num_input_units=8,
                        sum_product_layer="cp", num_sum_units=8,
                        sum_weight_param=Parameterization(activation="none",
                                                          initialization="normal"))
        ctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True, seed=0,
                              device=device)
        cc = ctx.compile(sc)
        sq = ctx.multiply(ctx.conjugate(cc), cc)
        return ctx, sq, ctx.integrate(sq)

    ctx, sq, zc = build("cuda")
    ctx_cpu, sq_cpu, zc_cpu = build("cpu")
    ctx_cpu.load_parameters(
        {s: v.detach().cpu().numpy() for s, v in ctx.parameters.items()}, dtype=torch.float64
    )
    x = np.random.default_rng(0).integers(0, 256, (16, 36))
    for circuit, ref_circuit, rtol in ((sq, sq_cpu, 1e-3), (zc, zc_cpu, 1e-5)):
        for op in T.LAUNCHES:
            T.LAUNCHES[op] = 0
        with torch.inference_mode():
            a, s = circuit(torch.as_tensor(x, device="cuda"))
            ra, rs = ref_circuit(torch.as_tensor(x))
        assert T.LAUNCHES["slse_matmul"] == sum(isinstance(l, TorchTensorDotLayer)
                                                for l in circuit.layers)
        np.testing.assert_allclose(a.double().cpu().numpy(), ra.numpy(), rtol=rtol)
        assert (rs == 1).all() and (s != 0).all()


# --------------------------------------------------------------------------- #
# The complex kernels (csrc/clse_einsum.cu)
# --------------------------------------------------------------------------- #

COMPLEX_OPS = ["clse_matmul", "clse_tucker2"]
_COMPLEX_TOL = {torch.complex64: (1e-5, 1e-4), torch.complex128: (1e-12, 1e-9)}


def _complex_inputs(op, f, b, o, dtype, *, real_w=False, k1=8, k2=16, i=32):
    """Complex log-space inputs (real parts as the lse tests', phases uniform
    in (-pi, pi]) and normal weights, complex or real."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=real)

    def value(*shape):
        phase = (torch.rand(shape, generator=gen, device="cuda", dtype=real) * 2 - 1) * torch.pi
        return torch.complex(randn(*shape) * 3.0 - 2.0, phase)

    tucker = "tucker" in op
    xs = [value(f, b, k1), value(f, b, k2)] if tucker else [value(f, b, i)]
    width = k1 * k2 if tucker else i
    w = randn(f, o, width) if real_w else torch.complex(randn(f, o, width), randn(f, o, width))
    return [*xs, w]


def _complex_close(ins, got, ref, tol):
    """The forward bound of chip_smoke's phase 3e: in linear space scaled by
    the row's absolute mass A (the lse of the real parts against ``|w|``),
    ``|exp(out_k - A) - exp(out_p - A)| <= tol`` on the real and imaginary
    parts; real part -inf where the mass is 0; no NaN."""
    *xs, w = ins
    res = [x.real.contiguous() for x in xs]
    mass = (T.lse_tucker2_ref(*res, w.abs()) if len(xs) == 2 else T.lse_matmul_ref(*res, w.abs()))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert not torch.isnan(got.real).any() and not torch.isnan(got.imag).any()
    empty = torch.isneginf(mass)
    assert torch.isneginf(got.real[empty]).all()
    lin_k = torch.where(empty, 0.0, torch.exp(got - mass))
    lin_p = torch.where(empty, 0.0, torch.exp(ref - mass))
    assert float((lin_k - lin_p).abs().max()) <= tol


def _complex_bwd_close(got, ref, rel, *, zeros=False):
    """The backward bound on each plane: ``|kernel - plain| <= rel (max|plain|
    + |plain|)``."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    planes = [(got.real, ref.real), (got.imag, ref.imag)] if got.dtype.is_complex else [(got, ref)]
    scale = ref.abs().max()
    for k, p in planes:
        assert not torch.isnan(k).any()
        assert not zeros or bool((k[ref == 0] == 0).all())
        assert bool(((k - p).abs() <= rel * (scale + p.abs())).all()), float((k - p).abs().max())


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("real_w", [False, True], ids=["complex-w", "real-w"])
@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 5, 9),
                                         (2, 70, 64, 4, 64), (144, 4096, 32, 8, 16)])
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_kernels_match_plain(op, f, b, o, k1, k2, real_w, dtype):
    """Forward and backward of the complex ops against their plain versions,
    with a row that is all -inf and a cotangent that is 0 on some rows; the
    last shape is the SoS TensorDot entry (B*Kq = 4096, I = O = 32)."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    if f == 144 and ("tucker" in op or dtype == torch.complex128):
        f, b, o = 8, 512, 64
    tol, rel = _COMPLEX_TOL[dtype]
    ins = _complex_inputs(op, f, b, o, dtype, real_w=real_w, k1=k1, k2=k2)
    ins[0][0, 2] = complex(float("-inf"), 0.5)
    ins = [t.requires_grad_() for t in ins]
    out = getattr(C, op)(*ins)
    with torch.no_grad():
        ref = getattr(C, f"{op}_ref")(*ins)
    _complex_close([t.detach() for t in ins], out.detach(), ref, tol)
    assert torch.isneginf(out.real[0, 2]).all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=out.real.dtype)
                        for _ in range(2)))
    g[1, :3] = 0.0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():  # on the kernel's own output: g / conj(y) is ill-conditioned near 0
        refs = getattr(C, f"{op}_bwd_ref")(*ins, out.detach(), g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    assert grads[-1].dtype == ins[-1].dtype
    for k, (got, r) in enumerate(zip(grads, refs)):
        _complex_bwd_close(got, r, rel, zeros=k < len(refs) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, :3] == 0).all()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("op", COMPLEX_OPS)
def test_complex_exact_cancellation(op, dtype):
    """Equal magnitudes of opposite phase (0 and pi would round: the phases
    are 0 with weights +1 and -1) sum to exactly 0: real part -inf, zero
    gradients, never NaN."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    alt = torch.tensor([1.0, -1.0], device="cuda").repeat(8).to(dtype)
    if "tucker" in op:
        ins = [torch.zeros(1, 8, 4, device="cuda", dtype=dtype) for _ in range(2)]
    else:
        ins = [torch.zeros(1, 8, 16, device="cuda", dtype=dtype)]
    ins.append(alt.expand(1, 8, 16).contiguous())
    ins = [t.requires_grad_() for t in ins]
    out = getattr(C, op)(*ins)
    assert torch.isneginf(out.real).all() and not torch.isnan(out.imag).any()
    grads = torch.autograd.grad(out, ins, torch.ones_like(out))
    assert all(bool((gr == 0).all()) for gr in grads)


def test_complex_backward_skips_and_repeats():
    """Only the requested gradients are computed, and two backward calls give
    the same bits (every sum runs in a fixed order)."""
    from cirkit_tpu_torch.ops import clse_einsum as C

    x1, x2, w = _complex_inputs("clse_tucker2", 3, 130, 70, torch.complex64)
    w.requires_grad_()
    out = C.clse_tucker2(x1, x2, w)
    (dw,) = torch.autograd.grad(out, [w], torch.ones_like(out), retain_graph=True)
    (again,) = torch.autograd.grad(out, [w], torch.ones_like(out))
    assert torch.equal(dw, again) and T.LAUNCHES["clse_tucker2_bwd"] == 2
    with torch.no_grad():
        ref = C.clse_tucker2_bwd_ref(x1, x2, w, out.detach(), torch.ones_like(out),
                                     (False, False, True))[-1]
    _complex_bwd_close(dw, ref, 1e-4)


def test_complex_wrapper_refuses_what_the_kernel_does_not_take():
    from cirkit_tpu_torch.ops import clse_einsum as C

    x, w = _complex_inputs("clse_matmul", 2, 8, 16, torch.complex64)
    with pytest.raises(TypeError, match="complex"):
        C.clse_matmul(x.real.contiguous(), w)
    with pytest.raises(TypeError, match="operands of"):
        C.clse_matmul(x, w.to(torch.complex128))
    with pytest.raises(ValueError, match="operands on"):
        C.clse_matmul(x, w.cpu())
    assert T.LAUNCHES["clse_matmul"] == 0


# --------------------------------------------------------------------------- #
# The float64 instances of the single-pass lse and signed kernels
# --------------------------------------------------------------------------- #


def _bwd_close_f64(got, ref, *, zeros=False):
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert not torch.isnan(got).any()
    assert not zeros or bool((got[ref == 0] == 0).all())
    bound = 1e-9 * (ref.abs().max() + ref.abs())
    assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("f,b,o,k1,k2", [(3, 8, 16, 8, 16), (3, 13, 1, 8, 16), (2, 130, 70, 4, 64),
                                         (4, 128, 64, 64, 64)])
@pytest.mark.parametrize("op", OPS)
def test_float64_kernels_match_plain(op, f, b, o, k1, k2):
    """Forward (1e-10 relative in log space) and backward of the double
    instances of the lse kernels; the last shape is the K=64 Tucker entry's
    widths, whose dx accumulators fill most of a block's shared memory."""
    ins = [t.double() for t in _inputs(op, f, b, o, k1=k1, k2=k2)]
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_() for t in ins]
    out = getattr(T, op)(*ins)
    assert out.dtype == torch.float64
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out.detach()[finite] - ref[finite]).abs()
    assert bool((err <= 1e-10 * (1 + ref[finite].abs())).all()), float(err.max())
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[1, 3:5] = 0.0
    grads = torch.autograd.grad(out, ins, g)
    with torch.no_grad():
        refs = getattr(T, f"{op}_bwd_ref")(*ins, out.detach(), g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(ins) - 1)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()


@pytest.mark.parametrize("f,b,o", [(3, 8, 16), (3, 13, 1), (2, 130, 70), (144, 4096, 32)])
@pytest.mark.parametrize("op", SIGNED_OPS)
def test_float64_signed_kernels_match_plain(op, f, b, o):
    from cirkit_tpu_torch.ops import slse_einsum as S

    if "tucker" in op and f == 144:
        f, b, o = 8, 512, 64
    ins = [t.double() for t in _signed_inputs(op, f, b, o)]
    ins[0][0, 2] = float("-inf")
    ins = [t.requires_grad_(k % 2 == 0 or k == len(ins) - 1) for k, t in enumerate(ins)]
    oa, os_ = getattr(S, op)(*ins)
    assert oa.dtype == os_.dtype == torch.float64
    with torch.no_grad():
        ref = getattr(S, f"{op}_ref")(*ins)
    _signed_close(op, [t.detach() for t in ins], (oa.detach(), os_), ref, tol=1e-12)
    g = torch.randn(oa.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[1, :3] = 0.0
    diff = [t for t in ins if t.requires_grad]
    grads = torch.autograd.grad(oa, diff, g)
    with torch.no_grad():
        refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                if r is not None]
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1 and T.LAUNCHES[f"{op}_bwd"] == 1
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(refs) - 1)


def test_float64_refusals_name_the_shape():
    """The float64 Tucker backward at widths whose dx accumulators do not fit
    a block's shared memory (from K1 = K2 = 88): the K1-split dx kernel and
    its finish, against the plain float64 backward, at (90, 90), where the
    forward takes the single-pass kernel, and at (128, 128), where it takes
    the K1-chunked one. (Such widths raised until the split existed; the
    test keeps its name.)"""
    for k, fwd in ((90, "lse_tucker2"), (128, "lse_tucker2_chunked")):
        ins = [t.double() for t in _inputs("lse_tucker2", 2, 70, 5, k1=k, k2=k)]
        ins[0][0, 2] = float("-inf")
        ins = [t.requires_grad_() for t in ins]
        out = T.lse_tucker2(*ins)
        assert out.dtype == torch.float64 and T.LAUNCHES[fwd] == 1
        g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda", dtype=torch.float64)
        g[1, 3:5] = 0.0
        grads = torch.autograd.grad(out, ins, g)
        with torch.no_grad():
            refs = T.lse_tucker2_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            _bwd_close_f64(got, r, zeros=n < 2)
        assert (grads[0][0, 2] == 0).all() and (grads[0][1, 3:5] == 0).all()
    assert T.LAUNCHES["lse_tucker2_bwd"] == 2


def _fwd_close_f64(out, ref):
    assert out.dtype == torch.float64 and out.shape == ref.shape and not torch.isnan(out).any()
    assert torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    err = (out[finite] - ref[finite]).abs()
    assert bool((err <= 1e-10 * (1 + ref[finite].abs())).all()), float(err.max())


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
@pytest.mark.parametrize("f,b,k1,k2,o", CHUNKED_CASES)
def test_float64_chunked_tucker_kernel_matches_plain(op, f, b, k1, k2, o, monkeypatch):
    """The double instances of the K1-chunked Tucker forward (row 5) against
    the plain float64 version, with a row that is all -inf and a first chunk
    of logits that is all -inf; the backward through the float64 Tucker
    backward kernel where its dx accumulators fit (else dw only)."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    ins = [t.double() for t in _inputs(op, f, b, o, k1=k1, k2=k2)]
    ins[0][0, 2] = float("-inf")
    chunk = max(1, 512 // k2) * k2
    if chunk < k1 * k2:
        ins[-1][0, 0, :chunk] = float("-inf") if "softmax" in op else 0.0
    dx = k1 + k2 < 150
    ins = [t.requires_grad_(dx or k == 2) for k, t in enumerate(ins)]
    out = getattr(T, op)(*ins)
    with torch.no_grad():
        ref = getattr(T, f"{op}_ref")(*ins)
    assert T.LAUNCHES[f"{op}_chunked"] == 1 and T.LAUNCHES[op] == 0
    _fwd_close_f64(out.detach(), ref)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    grads = torch.autograd.grad(out, [t for t in ins if t.requires_grad], g)
    with torch.no_grad():
        refs = [r for r in getattr(T, f"{op}_bwd_ref")(*ins, out, g, (dx, dx, True))
                if r is not None]
    torch.cuda.synchronize()
    for k, (got, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(got, r, zeros=k < len(refs) - 1)


@pytest.mark.parametrize("f,b,i,o", BLOCKED_CASES)
def test_float64_blocked_kernels_match_plain(f, b, i, o, monkeypatch):
    """The double instances of the blocked dense forward and backward (rows
    3 and 4) against the plain float64 versions; the row max exactly."""
    monkeypatch.setattr(T, "WIDE_WIDTH", 1)
    x, w = (t.double() for t in _inputs("lse_matmul", f, b, o, i=i))
    x[0, 2] = float("-inf")
    x[-1, 1, :256] = float("-inf")
    with torch.no_grad():
        ref, ref_m = T.lse_matmul_blocked_ref(x, w)
        got, got_m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert got_m.dtype == torch.float64 and torch.equal(got_m, ref_m)
    _fwd_close_f64(got, ref)
    x, w = x.requires_grad_(), w.requires_grad_()
    out = T.lse_matmul(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda", dtype=torch.float64)
    g[0, 1] = 0.0
    grads = torch.autograd.grad(out, [x, w], g)
    with torch.no_grad():
        refs = T.lse_matmul_blocked_bwd_ref(x, w, out, ref_m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2 and T.LAUNCHES["lse_matmul_blocked_bwd"] == 1
    for k, (a, r) in enumerate(zip(grads, refs)):
        _bwd_close_f64(a, r, zeros=k == 0)


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
@pytest.mark.parametrize("f,b,k1,k2,o", ROUTE_SHAPES)
def test_float64_routing_kernels_match_plain(f, b, k1, k2, o, log_weights):
    """The double instances of the tropical Tucker (row 9; 1e-12 (1 +
    |plain|)) and of the routing choice (row 8): the argmax by its score
    (within 1e-12 of the plain maximum), and the sample kind's draws
    reproducible by seed, in range, never a zero weight."""
    from cirkit_tpu_torch.ops import routing as R

    x1, x2, th, sel = (t.double() if t.is_floating_point() else t
                       for t in _route_inputs(f, b, k1, k2, o, log_weights))
    out = R.tropical_tucker2(x1, x2, th, log_weights=log_weights)
    ref = R.tropical_tucker2_ref(x1, x2, th, log_weights=log_weights)
    torch.cuda.synchronize()
    assert out.dtype == torch.float64 and torch.equal(torch.isneginf(out), torch.isneginf(ref))
    finite = torch.isfinite(ref)
    assert bool(((out[finite] - ref[finite]).abs() <= 1e-12 * (1 + ref[finite].abs())).all())
    idx = R.route_tucker2(x1, x2, th, sel, kind="max", log_weights=log_weights)
    scores = R.route_scores(x1, x2, th, sel, log_weights=log_weights)
    best = scores.amax(dim=-1)
    at = torch.gather(scores, -1, idx[..., None])[..., 0]
    assert bool(((at >= best - 1e-12 * (1 + best.abs())) | torch.isneginf(best)).all())
    draw = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=log_weights, seed=7)
    again = R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=log_weights, seed=7)
    assert torch.equal(draw, again) and bool(((draw >= 0) & (draw < k1 * k2)).all())
    if not log_weights:
        assert bool((idx != 3).all()) and bool((draw != 3).all())
    assert T.LAUNCHES["tropical_tucker2"] == 1 and T.LAUNCHES["route_tucker2"] == 3


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_float64_route_sample_frequencies(log_weights):
    """The double instance's Gumbel draws over 65,536 identical rows against
    ``softmax(scores)``, as for float32."""
    from cirkit_tpu_torch.ops import routing as R

    n = 65536
    x1, x2, th, _ = (t.double() for t in _route_inputs(2, 1, 4, 4, 8, log_weights, seed=3,
                                                       edges=False))
    sel = torch.tensor([[3], [6]], device="cuda")
    p = torch.softmax(R.route_scores(x1, x2, th, sel, log_weights=log_weights)[:, 0], dim=-1)
    rows = [t.expand(-1, n, -1).contiguous() for t in (x1, x2)]
    idx = R.route_tucker2(*rows, th, sel.expand(-1, n).contiguous(), kind="sample",
                          log_weights=log_weights, seed=99)
    for ff in range(2):
        freq = torch.bincount(idx[ff], minlength=16).double() / n
        bound = 5 * torch.sqrt(p[ff] * (1 - p[ff]) / n) + 1e-3
        assert bool(((freq - p[ff]).abs() <= bound).all()), (freq, p[ff])


# --------------------------------------------------------------------------- #
# The float32 backward on the tensor cores (csrc/lse_einsum_bwd.cu, section 6)
# --------------------------------------------------------------------------- #

# (F, B, O, K1, K2): O, B, K1 and K2 that no tile divides, K1 != K2; the
# dense ops take I = K1 * K2
RAGGED = [(3, 100, 33, 13, 21), (2, 100, 33, 21, 13), (1, 37, 70, 70, 130), (2, 130, 17, 3, 600)]


def _tc_case(op, f, b, o, k1, k2):
    ins = _inputs(op, f, b, o, k1=k1, k2=k2, i=k1 * k2)
    ins[0][0, 2] = float("-inf")  # a row that is all -inf
    g = torch.randn((f, b, o), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[-1, 3:5] = 0.0  # rows whose upstream gradient is 0
    return ins, g


@pytest.mark.parametrize("f,b,o,k1,k2", RAGGED)
@pytest.mark.parametrize("op", OPS)
def test_tensor_core_backward_ragged(op, f, b, o, k1, k2):
    """Every gradient of the tensor-core path against the plain version on
    ragged shapes, zero gradients at the -inf row and at rows of zero
    cotangent, and a second call equal to the bit."""
    ins, g = _tc_case(op, f, b, o, k1, k2)
    with torch.no_grad():
        out = getattr(T, f"{op}_ref")(*ins)
    grads = T.backward(op, tuple(ins), out, g)
    again = T.backward(op, tuple(ins), out, g)
    refs = getattr(T, f"{op}_bwd_ref")(*ins, out, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES[f"{op}_bwd"] == 2
    for k, (a, r) in enumerate(zip(grads, refs)):
        _close(a, r, zeros=k < len(ins) - 1)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    assert (grads[0][0, 2] == 0).all() and (grads[0][-1, 3:5] == 0).all()


@pytest.mark.parametrize("which", ["dx", "dw", "dx1", "dx2"])
@pytest.mark.parametrize("op", OPS)
def test_tensor_core_backward_skips(op, which):
    """A call that asks for some gradients only: each one equal to the bit
    to the full call's, the others None."""
    if which in ("dx1", "dx2") and "tucker" not in op:
        which = "dx"
    ins, g = _tc_case(op, 2, 100, 33, 13, 21)
    with torch.no_grad():
        out = getattr(T, f"{op}_ref")(*ins)
    full = T.backward(op, tuple(ins), out, g)
    names = ("dx1", "dx2", "dw") if "tucker" in op else ("dx", "dw")
    needs = tuple(n == which or (which == "dx" and n.startswith("dx")) for n in names)
    part = T.backward(op, tuple(ins), out, g, needs)
    torch.cuda.synchronize()
    for need, p_, f_ in zip(needs, part, full):
        assert (p_ is None) == (not need)
        assert p_ is None or torch.equal(p_, f_)


# --------------------------------------------------------------------------- #
# The float32 wide kernels on the tensor cores (csrc/lse_wide.cu: ct_fwd_tc,
# blocked_gy_tc + blocked_bwd_tc)
# --------------------------------------------------------------------------- #


def _offset(t):
    """``t`` copied into a buffer one float past an aligned start: contiguous,
    but its rows' 16-byte copies are off."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


# (F, B, I, O): no tile of the kernel (64 strip columns, 128 batch rows, 64
# units) divides them; I odd (777) or past one strip row of 256 chunks (10000)
TC_BLOCKED = [(2, 130, 777, 70), (1, 13, 10000, 1), (3, 37, 1000, 33), (1, 257, 130, 128)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,i,o", TC_BLOCKED)
def test_tensor_core_blocked_backward(f, b, i, o, offset):
    """The blocked backward against its plain version with a row of x that is
    all -inf, a strip of a row that is -inf and a row whose cotangent is 0;
    a second call equal to the bit, and dx-only and dw-only calls equal to
    the bit to the full call's."""
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x[0, 2] = float("-inf")
    x[-1, 1, 64:128] = float("-inf")
    if offset:
        x, w = _offset(x), _offset(w)
    with torch.no_grad():
        out, m = T.lse_matmul_blocked_ref(x, w)
    g = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    g[0, 1] = 0.0
    full = T._launch_blocked_bwd(x, w, out, m, g, (True, True))
    again = T._launch_blocked_bwd(x, w, out, m, g, (True, True))
    dx_only = T._launch_blocked_bwd(x, w, out, m, g, (True, False))
    dw_only = T._launch_blocked_bwd(x, w, out, m, g, (False, True))
    refs = T.lse_matmul_blocked_bwd_ref(x, w, out, m, g)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked_bwd"] == 4
    _close(full[0], refs[0], zeros=True)
    _close(full[1], refs[1])
    assert all(torch.equal(a, b_) for a, b_ in zip(full, again))
    assert dx_only[1] is None and torch.equal(dx_only[0], full[0])
    assert dw_only[0] is None and torch.equal(dw_only[1], full[1])
    assert (full[0][0, 2] == 0).all() and (full[0][0, 1] == 0).all()


# (F, B, K1, K2, O): K1 != K2, K2 odd (no 16-byte copies) or past the
# 32-column chunk, O and B that no tile (128 units, 128 rows) divides
TC_CHUNKED = [(2, 130, 99, 600, 70), (3, 13, 40, 24, 1), (1, 37, 7, 129, 33),
              (1, 128, 128, 128, 128)]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,k1,k2,o", TC_CHUNKED)
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_chunked_tucker(op, f, b, k1, k2, o, offset):
    """The K1-chunked Tucker forward against its plain version, with rows of
    x1 and of x2 that are all -inf and a unit whose logits (weights) over
    one row i, and over a 32-column chunk of another, are -inf (0); a
    second call equal to the bit. The plain version runs on the inputs cast
    to float64: at I = 59400 its float32 composition is itself off float64
    by up to 1.9e-4 (cuBLAS's float32 sums), past the bound, where the
    kernel stays within 1e-5."""
    ins = _inputs(op, f, b, o, k1=k1, k2=k2)
    ins[0][0, 2] = float("-inf")
    ins[1][-1, 1] = float("-inf")
    zero = float("-inf") if "softmax" in op else 0.0
    ins[2][0, 0, :k2] = zero
    ins[2][-1, -1, k2 + 32:k2 + 64] = zero
    if offset:
        ins[2] = _offset(ins[2])
    key = f"{op}_chunked"
    got = T._launch_fwd(key, tuple(ins))
    again = T._launch_fwd(key, tuple(ins))
    ref = getattr(T, f"{op}_ref")(*(t.double() for t in ins))
    torch.cuda.synchronize()
    assert T.LAUNCHES[key] == 2
    _fwd_close(got.double(), ref)
    assert torch.equal(got, again)
    assert torch.isneginf(got[0, 2]).all() and torch.isneginf(got[-1, 1]).all()


# --------------------------------------------------------------------------- #
# The float32 forwards redesigned for the tensor cores: the blocked dense
# forward (csrc/lse_wide.cu blocked_fwd_tc) and the single-pass Tucker
# forward (csrc/lse_einsum.cu tucker_fwd_tc)
# --------------------------------------------------------------------------- #

# (F, B, I, O): ragged B, O = 1 and 129 (two unit tiles of 128), I = 8200
# (not a multiple of the 32-column chunk), I odd (4-byte copies)
TC_BLOCKED_FWD = [(2, 100, 8200, 1), (2, 100, 8200, 129), (3, 13, 777, 70), (1, 130, 1000, 128)]


def _blocked_fwd_edges(x):
    """A row of x that is all -inf, one whose max sits in the last chunk and
    one that rises along the row (every chunk raises its max, so the
    accumulators are rescaled on every chunk)."""
    i = x.shape[2]
    x[0, 2] = float("-inf")
    x[-1, 1, -3] = 40.0
    x[-1, 0] = torch.linspace(-30.0, 30.0, i, device=x.device) + x[-1, 0] * 0.1
    return x


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,i,o", TC_BLOCKED_FWD)
def test_tensor_core_blocked_fwd_edges(f, b, i, o, offset):
    """The blocked forward against its plain version at the edges, its row
    max equal to the clamped max of x, and a second call equal to the bit."""
    x, w = _inputs("lse_matmul", f, b, o, i=i)
    x = _blocked_fwd_edges(x)
    if offset:
        x, w = _offset(x), _offset(w)
    got, m = T._launch_blocked_fwd(x, w)
    again, m_again = T._launch_blocked_fwd(x, w)
    ref, ref_m = T.lse_matmul_blocked_ref(x, w)
    torch.cuda.synchronize()
    assert T.LAUNCHES["lse_matmul_blocked"] == 2
    _fwd_close(got, ref)
    assert torch.equal(m, ref_m)
    assert torch.equal(got, again) and torch.equal(m, m_again)
    assert torch.isneginf(got[0, 2]).all()


def test_tensor_core_blocked_fwd_row_max_is_the_clamped_max():
    """The row max the blocked forward writes is ``_clamp_max(x)`` to the bit
    (the blocked backward shifts by it), at I = 16384 with rows of -inf,
    rows whose max is in the last chunk and a rising row."""
    x, w = _inputs("lse_matmul", 8, 128, 128, i=128 * 128)
    x = _blocked_fwd_edges(x)
    x[3, 7, :100] = float("-inf")
    _, m = T._launch_blocked_fwd(x, w)
    torch.cuda.synchronize()
    assert torch.equal(m, T._clamp_max(x))


def test_tensor_core_blocked_fwd_against_float64_at_i16384():
    """The blocked forward at the dense K=128 entry's width (I = 16384, B = O
    = 128; 98 of the 784 folds) against the plain version run in float64."""
    x, w = _inputs("lse_matmul", 98, 128, 128, i=128 * 128)
    got, _ = T._launch_blocked_fwd(x, w)
    ref = T.lse_matmul_ref(x.double(), w.double())
    torch.cuda.synchronize()
    _fwd_close(got.double(), ref)


# (F, B, K1, K2, O): K1 != K2, K2 % 4 != 0 (4-byte loads), O = 1 and 65 (two
# unit tiles of 64), ragged B, K1 K2 = 8100 (just under WIDE_WIDTH), and the
# K=64 flagship's tile
TC_SINGLE = [(2, 100, 13, 21, 65), (3, 13, 8, 30, 1), (1, 130, 90, 90, 64), (2, 128, 64, 64, 64),
             (1, 37, 7, 129, 33)]


def _single_edges(op, ins):
    """Rows of x1 and of x2 that are all -inf; a unit whose logits are -inf
    over the first row i and over a 32-column chunk of another (weights 0),
    and, with logits, a unit whose logits are all -inf but the last one
    (its running max stays -inf to the last segment), without, a unit
    whose weights are all 0 (out -inf)."""
    k2 = ins[1].shape[2]
    ins[0][0, 2] = float("-inf")
    ins[1][-1, 1] = float("-inf")
    zero = float("-inf") if "softmax" in op else 0.0
    ins[2][0, 0, :k2] = zero
    ins[2][-1, -1, k2 + 32:k2 + 64] = zero
    ins[2][-1, 0, :-1 if "softmax" in op else None] = zero
    return ins


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("f,b,k1,k2,o", TC_SINGLE)
@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_single_pass_tucker_edges(op, f, b, k1, k2, o, offset):
    """The single-pass Tucker forward against its plain version at the edges,
    -inf rows giving -inf and no NaN, and a second call equal to the bit."""
    ins = _single_edges(op, _inputs(op, f, b, o, k1=k1, k2=k2))
    if offset:
        ins[2] = _offset(ins[2])
    got = T._launch_fwd(op, tuple(ins))
    again = T._launch_fwd(op, tuple(ins))
    ref = getattr(T, f"{op}_ref")(*ins)
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 2
    _fwd_close(got, ref)
    assert torch.equal(got, again)
    assert torch.isneginf(got[0, 2]).all() and torch.isneginf(got[-1, 1]).all()


@pytest.mark.parametrize("op", ["lse_tucker2", "lse_tucker2_softmax"])
def test_tensor_core_single_pass_tucker_against_float64_at_k64(op):
    """The single-pass Tucker forward at the K=64 flagship's entry (F=784,
    B=128, K1=K2=O=64), through the public op, against the plain version
    run in float64."""
    ins = _inputs(op, 784, 128, 64, k1=64, k2=64)
    got = getattr(T, op)(*ins)
    ref = getattr(T, f"{op}_ref")(*(t.double() for t in ins))
    torch.cuda.synchronize()
    assert T.LAUNCHES[op] == 1
    _fwd_close(got.double(), ref)


# --------------------------------------------------------------------------- #
# Every Tucker backward at widths past one block, and the signed and complex
# backwards (kernels 7 and 11) at the SoS entry and its edges
# --------------------------------------------------------------------------- #

# (op, dtype, K1, K2): each width past the single-block Tucker dx kernel's
# shared memory for its type (float32 signed from 202, float64 from 88,
# complex64 from 105, complex128 from 100), K1 = K2 = 128 and K1 != K2, and
# float32 signed at 128 (one block) beside 208 (the split)
WIDE_TUCKER = [
    ("slse_tucker2", torch.float32, 128, 128),
    ("slse_tucker2", torch.float32, 208, 208),
    ("slse_tucker2_softmax", torch.float32, 100, 120),
    ("slse_tucker2", torch.float64, 128, 128),
    ("slse_tucker2_softmax", torch.float64, 100, 120),
    *(("clse_tucker2", dtype, k1, k2, real_w) for dtype in (torch.complex64, torch.complex128)
      for k1, k2 in ((128, 128), (100, 120)) for real_w in (False, True)),
]


def _grads_twice(out, diff, g):
    first = torch.autograd.grad(out, diff, g, retain_graph=True)
    again = torch.autograd.grad(out, diff, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), "two calls differ"
    return first


@pytest.mark.parametrize("case", WIDE_TUCKER, ids=lambda c: "-".join(map(str, c)).replace(
    "torch.", ""))
def test_tucker_backward_past_one_block_matches_plain(case):
    """The signed and complex Tucker backwards where their dx accumulators do
    not fit one block (and float32 signed at 128, where they do): F = 2, a
    ragged batch of 70, O = 5, a row that is all -inf and a cotangent that
    is 0 on some rows, against the plain version in the op's type; two
    calls give the same bits."""
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    op, dtype, k1, k2 = case[:4]
    f, b, o = 2, 70, 5
    gen = torch.Generator(device="cuda").manual_seed(1)
    if op.startswith("clse"):
        tol, rel = _COMPLEX_TOL[dtype]
        ins = _complex_inputs(op, f, b, o, dtype, real_w=case[4], k1=k1, k2=k2)
        ins[0][0, 2] = complex(float("-inf"), 0.5)
        ins = [t.requires_grad_() for t in ins]
        out = C.clse_tucker2(*ins)
        real = out.real.dtype
        g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=real)
                            for _ in range(2)))
        g[1, :3] = 0.0
        grads = _grads_twice(out, ins, g)
        with torch.no_grad():
            refs = C.clse_tucker2_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            _complex_bwd_close(got, r, rel, zeros=n < 2)
    else:
        ins = [t.to(dtype) for t in _signed_inputs(op, f, b, o, k1=k1, k2=k2)]
        ins[0][0, 2] = float("-inf")
        ins = [t.requires_grad_(n % 2 == 0 or n == 4) for n, t in enumerate(ins)]
        oa, os_ = getattr(S, op)(*ins)
        g = torch.randn(oa.shape, generator=gen, device="cuda", dtype=dtype)
        g[1, :3] = 0.0
        diff = [t for t in ins if t.requires_grad]
        grads = _grads_twice(oa, diff, g)
        with torch.no_grad():
            refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                    if r is not None]
        torch.cuda.synchronize()
        for n, (got, r) in enumerate(zip(grads, refs)):
            if dtype == torch.float64:
                _bwd_close_f64(got, r, zeros=n < 2)
            else:
                _close(got, r, zeros=n < 2)
    assert (grads[0][0, 2] == 0).all() and (grads[0][1, :3] == 0).all()
    assert T.LAUNCHES[f"{op}_bwd"] == 2


# (f, B, I, O): the SoS entry, a ragged batch of 4000, O = 1, I = 33 (no
# 16-byte rows) and both at once
SOS_EDGES = [(144, 4096, 32, 32), (144, 4000, 32, 32), (16, 4096, 32, 1), (16, 4096, 33, 32),
             (16, 4000, 33, 33)]
SOS_OPS = [("slse_matmul", torch.float32), ("slse_matmul_softmax", torch.float32),
           ("slse_matmul", torch.float64), ("clse_matmul", torch.complex64, False),
           ("clse_matmul", torch.complex64, True), ("clse_matmul", torch.complex128, False),
           ("clse_matmul", torch.complex128, True)]


@pytest.mark.parametrize("opcase", SOS_OPS, ids=lambda c: "-".join(map(str, c)).replace(
    "torch.", ""))
@pytest.mark.parametrize("f,b,i,o", SOS_EDGES)
def test_sos_backward_edges_match_plain(f, b, i, o, opcase):
    """The dense signed and complex backwards (kernels 7 and 11: a dx tile
    that fits I, a dw split over the batch) against their plain versions at
    the SoS entry and its edges, with a row that is all -inf, rows of fold 0
    whose sum cancels exactly (gradient 0, no NaN) and a cotangent that is 0
    on some rows; two calls give the same bits."""
    from cirkit_tpu_torch.ops import clse_einsum as C
    from cirkit_tpu_torch.ops import slse_einsum as S

    op, dtype = opcase[:2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = slice(9, 12)  # the rows of fold 0 that cancel
    if op.startswith("clse"):
        tol, rel = _COMPLEX_TOL[dtype]
        x, w = _complex_inputs(op, f, b, o, dtype, real_w=opcase[2], i=i)
        x[0, 2] = complex(float("-inf"), 0.5)
        # phase 0, magnitude 1 against weights +1, -1, ...: y = 0 exactly
        x[0, rows] = 0.0
        x[0, rows, 32:] = complex(float("-inf"), 0.0)
        w[0] = torch.tensor([1.0, -1.0], device="cuda").repeat(i)[:i].to(w.dtype)
        ins = [x.requires_grad_(), w.requires_grad_()]
        out = C.clse_matmul(*ins)
        real = out.real.dtype
        g = torch.complex(*(torch.randn(out.shape, generator=gen, device="cuda", dtype=real)
                            for _ in range(2)))
        g[1, :3] = 0.0
        assert torch.isneginf(out.real[0, rows]).all()
        grads = _grads_twice(out, ins, g)
        with torch.no_grad():
            refs = C.clse_matmul_bwd_ref(*ins, out.detach(), g)
        torch.cuda.synchronize()
        _complex_bwd_close(grads[0], refs[0], rel, zeros=True)
        _complex_bwd_close(grads[1], refs[1], rel)
    else:
        a, s, w = (t.to(dtype) for t in _signed_inputs(op, f, b, o, i=i))
        a[0, 2] = float("-inf")
        # equal magnitudes, alternating signs against equal weights: y = 0
        a[0, rows] = 0.0
        s[0, rows] = torch.tensor([1.0, -1.0], device="cuda").repeat(i)[:i].to(dtype)
        s[0, rows, 32:] = 0.0
        w[0] = 0.0 if "softmax" in op else 1.0
        ins = [a.requires_grad_(), s, w.requires_grad_()]
        oa, os_ = getattr(S, op)(*ins)
        assert torch.isneginf(oa[0, rows]).all() and (os_[0, rows] == 0).all()
        g = torch.randn(oa.shape, generator=gen, device="cuda", dtype=dtype)
        g[1, :3] = 0.0
        grads = _grads_twice(oa, [ins[0], ins[2]], g)
        with torch.no_grad():
            refs = [r for r in getattr(S, f"{op}_bwd_ref")(*ins, oa.detach(), os_, g)
                    if r is not None]
        torch.cuda.synchronize()
        close = _bwd_close_f64 if dtype == torch.float64 else _close
        close(grads[0], refs[0], zeros=True)
        close(grads[1], refs[1])
    assert (grads[0][0, 2] == 0).all() and (grads[0][0, rows] == 0).all()
    assert (grads[0][1, :3] == 0).all()
    assert T.LAUNCHES[f"{op}_bwd"] == 2
