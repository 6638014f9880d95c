"""Fused log-einsum-exp ops for the circuit hot path.

The counterpart of ``cirkit_tpu/ops/lse_einsum.py:1590-1687``. The log-space
(lse-sum) semiring evaluates every sum layer as a max-shifted
log-einsum-exp: shift each input row by its clamped max, exponentiate,
contract in linear space, take the log and add the shift back.

- :func:`lse_matmul` / :func:`lse_matmul_softmax`: the dense folded
  contraction ``(F, B, I) x (F, O, I) -> (F, B, O)``; the ``_softmax``
  variant takes raw logits and normalizes the weight rows inside the kernel.
- :func:`lse_tucker2` / :func:`lse_tucker2_softmax`: the arity-2 Tucker
  contraction ``(F, B, K1) x (F, B, K2) x (F, O, K1*K2) -> (F, B, O)``; the
  outer product of the two inputs never reaches device memory.

Each op is a ``torch.autograd.Function`` (the counterpart of the JAX
package's custom VJP ``_fused_p``, ``cirkit_tpu/ops/lse_einsum.py:447-463``)
around two entries of the hand-written CUDA kernels: the forward in
``csrc/lse_einsum.cu`` and the backward in ``csrc/lse_einsum_bwd.cu``.
Contractions of width ``WIDE_WIDTH`` or more (I, or K1*K2 for Tucker: the
K=128 circuits) take the wide kernels of ``csrc/lse_wide.cu`` instead, as
the JAX package takes its chunked and blocked kernels there:

- the Tucker ops launch the K1-chunked forward (``_ct_fwd_kernel``'s
  counterpart, with the online softmax) and the backward kernel above;
- :func:`lse_matmul` launches the blocked forward, which also returns the
  row max, and the blocked backward that reads it (``_blocked_*``);
- :func:`lse_matmul_softmax` normalizes the logits with ``torch.softmax``
  and calls the blocked :func:`lse_matmul`, as the JAX package does
  (``cirkit_tpu/ops/lse_einsum.py:1620-1622``); autograd takes the
  softmax's VJP.

Beside each kernel stands a plain PyTorch version: ``*_ref`` for the
forward, mirroring the JAX package's XLA fallbacks, and ``*_bwd_ref`` for
the backward, computing exactly the backward kernel's math. An op takes the
plain versions only for tensors on the CPU; a CUDA tensor gets the kernel
or an exception. ``LAUNCHES`` counts the op calls that launched a kernel,
one key per op and one per op's backward (``lse_matmul_bwd``, ...), and one
per wide forward entry (``WIDE_OPS``) and the blocked backward.

Weight stores and speed modes (the counterpart of ``_fast_mode``,
``_cfg_fast``, ``_fcast`` and the bf16 branches of ``_dispatch`` and
``_dispatch_tucker_chunked``, ``cirkit_tpu/ops/lse_einsum.py:102-146,
466-476, 865-875``):

- the weight or logits operand of the single-pass, Tucker, K1-chunked and
  blocked dense kernels (kernels 1-5) and of the signed kernels 6 and 7
  (``ops/slse_einsum.py``) may be ``torch.bfloat16`` beside float32
  activations, the serving store of ``backend/torch/serving.py``: the
  kernels read it as bf16 and widen it on chip; the weight's gradient is
  accumulated in float32 and cast to the weight's type at the boundary, as
  the JAX package's ``_fused_p_bwd``, ``_blocked_p_bwd`` and
  ``_sfused_p_bwd`` do (the fast Tucker backward writes that cast itself,
  :func:`_bf16_tucker_bwd`). Float64 activations take a bf16 weight widened to
  float64 here, and the complex kernels a bf16 real weight widened to
  float32 in their op wrappers, as the JAX package widens it to complex64
  (the routing kernels read it as bf16: ``ops/routing.py``);
- ``CIRKIT_TPU_FAST`` (:func:`fast_mode`, read at each call as in JAX):
  unset runs the f32-grade instances (3xTF32 here and in the signed and
  complex Tucker kernels 6, 7, 10 and 11 against a real weight; float32
  FMAs in their other configurations, which run on the CUDA cores);
  ``sr`` stochastically rounds the contraction operands to bf16, any other
  value rounds them to the nearest bf16; the Tucker forwards (kernels 1
  and 5, and the signed and complex ones, 6 and 10 against a real weight)
  and their backwards, and the blocked dense kernels 3 and 4, then
  run their products on the bf16 tensor cores (``csrc/tucker_bf16.cu``,
  ``csrc/tucker_bf16_bwd.cu``, ``csrc/blocked_bf16.cu``), the other
  tensor-core kernels one TF32 pass
  over the bf16-valued operands, which multiplies them exactly too, both
  with float32 accumulation, and the CUDA-core kernels the same FMAs on
  bf16-valued operands. A mode applies to float32 (complex64) values only.

The rounding points are those of the port's kernels (kernels 6, 7, 10 and
11: ``ops/slse_einsum.py`` and ``ops/clse_einsum.py``), where the JAX
kernel's are partly artifacts of Mosaic's selector matmuls: the forward rounds the
shifted exponentials of a dense input, and of a Tucker contraction only
``e2 = exp(x2 - m2)``, since the kernels multiply by ``e1`` in float32 after
the tensor-core product (JAX rounds ``e1`` for its repeat selector and then
``e1 * e2``); logits round as ``exp(theta - max)`` over the row's global
max, the normalizer summed unrounded in float32 (JAX rounds the normalized
row), but for the Tucker forwards, which read the logits once and round
``exp(theta - r)`` over the unit's running max ``r`` of the tiles of
``_TUCKER_JC`` columns so far (:func:`_tucker_fast_numerators`; JAX's
K1-chunked kernel rounds over its running max too). The backward rounds
``gy`` and the weights of ``s = gy @ w`` and
``gy`` and ``e`` (for Tucker ``e1 * e2``) of ``dw = gy^T e``, and the
blocked dense kernels the same operands, the forward's ``e`` taken over
the row's running max of the chunks of ``_BLOCKED_KC`` columns so far (the
kernel rescales each chunk's sums to the final max after the products); the Tucker
dx folds and the softmax VJP stay float32 (JAX rounds the folds' operands
for its segment-sum selectors), and so do the softmax weights of ``s``,
``exp(theta - lse)``: they carry the row's log-normalizer, whose last bits
no plain version reproduces, so their rounding could not be held to one. ``sr`` adds 16 bits of a stateless hash of
the element's flat index in its operand and of the operand's role
(:func:`sr_bits`) below the bf16 cut and truncates, the counterpart of
``pltpu.stochastic_round`` with a grid-seeded PRNG: a call repeats bit for
bit. The plain versions round at the same points with the same bits, so a
kernel is held against its plain version as in float32.

Under a tracer the forward launches go through the operator
``cirkit_tpu_torch::lse_fwd`` (:func:`launch_op`, ``torch.library``), so that
``torch.export`` records them as one graph node each (``data_ptr()`` has no
meaning on the fake tensors it traces with); eager CUDA tensors call the
launcher directly (:func:`_traced`), and so does the operator when an exported
program runs. The backward launches are not wrapped.
"""

from __future__ import annotations

import os

import torch

from cirkit_tpu_torch.ops import _build

OPS = ("lse_matmul", "lse_matmul_softmax", "lse_tucker2", "lse_tucker2_softmax")
WIDE_OPS = ("lse_tucker2_chunked", "lse_tucker2_softmax_chunked", "lse_matmul_blocked")
"""The forward entries of the wide kernels (the blocked one also has a
backward, ``lse_matmul_blocked_bwd``)."""
MODE_SUFFIX = {"": "", "bf16": "_fast", "sr": "_sr"}
"""The suffix of a speed mode's entries and ``LAUNCHES`` keys."""
INSTANCES = _build.INSTANCES
"""The suffixes of the bf16-weight (``_w16``) and fast-mode instances of the
kernels 1-7 beside their float32 ones (no suffix): ``lse_tucker2_w16`` is
the Tucker forward on a bf16 weight in the f32-grade mode,
``lse_tucker2_softmax_w16_fast_bwd`` its softmax backward in the bf16 mode,
``lse_matmul_blocked_w16_sr_bwd`` the blocked dense backward on a bf16
weight in the ``sr`` mode."""
INSTANCE_OPS = (*OPS, *WIDE_OPS)
LAUNCHES: dict[str, int] = {
    **{name: 0 for op in OPS for name in (op, f"{op}_bwd")},
    **{op: 0 for op in WIDE_OPS},
    "lse_matmul_blocked_bwd": 0,
    **{f"{op}{sfx}": 0 for op in INSTANCE_OPS for sfx in INSTANCES},
    **{f"{op}{sfx}_bwd": 0 for op in (*OPS, "lse_matmul_blocked") for sfx in INSTANCES},
}
"""Kernel launches per op and per op's backward; a count rises by one only
where its op launches its kernel."""

WIDE_WIDTH = 8192
"""The contraction width (I, or K1*K2 for Tucker) from which the ops take the
wide kernels: the K=128 circuits' 16384 does, the K=64 flagship's 4096 keeps
the single-pass kernels, as the JAX package chooses on both."""

_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
# the single-pass forward kernels' output-unit and batch-row tiles (the FMA
# kernel's and the float32 Tucker kernel's on the tensor cores)
_BN, _BM = 64, 128
# the blocked forward's (batch-row, output-unit) tiles by entry suffix: the
# float32 kernel on the tensor cores covers 128 units, the float64 one 64
_BLOCKED_TILES = {"": (128, 128), "_f64": (128, 64)}
_BLOCKED_KC = 64
"""The columns of a chunk of the bf16-weight and fast-mode blocked forward
kernels, over whose running row max the fast modes round their
exponentials: ``bb::KC`` of ``csrc/blocked_bf16.cu``, which must change with
it (a test reads it there)."""
_TUCKER_JC = 64
"""The columns ``j`` of a chunk of the fast Tucker forwards: ``tb::JC`` of
``csrc/tucker_bf16.cu``, which must change with it (a test reads it there).
A tile is one row ``i`` of a chunk; the tiles run chunk by chunk, ``i`` in
order within each, and the fast modes round the logits over each unit's
running max of the tiles so far."""
# the backward kernels' grid tiles (csrc/lse_einsum_bwd.cu): rows per warp
# pass, and input columns of the dense dx kernel (the other grids are smaller)
_BWD_ROWS, _BWD_DX_COLS = 8, 64
_BWD_UNIT_GROUP = 128
"""The units of a block of the fast Tucker backward, ``tbw::UG`` of
``csrc/tucker_bf16_bwd.cu`` (its columns are ``tbw::JC`` = ``_TUCKER_JC``):
past it, and past one chunk of columns, its dx sums are partial and take
room in the scratch (:func:`_tucker_bf16_bwd_scratch`); both must change
with the kernel (a test reads them there)."""


def _clamp_max(x: torch.Tensor) -> torch.Tensor:
    """Trailing-axis max clamped to the finite range, so rows that are all
    -inf never produce NaNs via inf - inf."""
    info = torch.finfo(x.dtype)
    return x.amax(dim=-1, keepdim=True).clamp(info.min, info.max)


def fast_mode() -> str:
    """The speed mode from ``CIRKIT_TPU_FAST``, read at each call: ``""``
    (unset: f32-grade), ``"sr"`` (stochastic rounding to bf16) or ``"bf16"``
    (any other value: rounding to the nearest bf16)."""
    v = os.environ.get("CIRKIT_TPU_FAST", "")
    if not v:
        return ""
    return "sr" if v.lower() == "sr" else "bf16"


def _op_mode(x: torch.Tensor) -> str:
    """The mode of an op on activations ``x``: float64 runs no fast mode."""
    return fast_mode() if x.dtype == torch.float32 else ""


def _weight_for(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``w`` as a kernel with a bf16 instance takes it beside ``x``: a bf16
    weight stays bf16 beside float32 activations and is widened to the
    activations' type beside any other."""
    if w.dtype == torch.bfloat16 and x.dtype != torch.float32:
        return w.to(x.dtype)
    return w


def widened(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A bf16 weight widened (exactly) to the type of the activations ``x``:
    the operand of a kernel that has no bf16 instance."""
    return w.to(x.dtype) if w.dtype == torch.bfloat16 and x.dtype.is_floating_point else w


# The operand roles of the stochastic rounding's bits: the forward's
# exponentials and weights, the backward's gy, weights and exponentials.
ROLE_E, ROLE_W, ROLE_GY, ROLE_WB, ROLE_EB = range(5)
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32), in halves of ``c``
    so that no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def sr_bits(idx: torch.Tensor, role: int) -> torch.Tensor:
    """The 16 random bits of stochastic rounding for the elements at flat
    indices ``idx`` (int64) of an operand of ``role``: a murmur3 finalizer
    over both halves of the index and the role, as ``sr_bits`` in
    ``csrc/tc_common.cuh`` computes them."""
    h = (_mul32(idx & _M32, 0x9E3779B1) + _mul32(idx >> 32, 0x85EBCA77)
         + ((role + 1) * 0xC2B2AE3D & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >> 16


def round_bf16(v: torch.Tensor, mode: str, role: int) -> torch.Tensor:
    """A float32 operand rounded as the kernels of ``mode`` round it, kept
    float32: to the nearest bf16 (``"bf16"``), or (``"sr"``) by adding
    :func:`sr_bits` of each element's flat index in ``v``, which must have
    its operand's full shape, below the bf16 cut and truncating."""
    if mode == "bf16":
        return v.to(torch.bfloat16).to(v.dtype)
    if mode != "sr":
        return v
    flat = v.contiguous().view(-1)
    out = torch.empty_like(flat)
    step = 1 << 24  # slices bound the int64 temporaries (K=128 weights: 1.6e9 elements)
    for start in range(0, flat.numel(), step):
        part = flat[start : start + step]
        idx = torch.arange(start, start + part.numel(), device=v.device, dtype=torch.int64)
        u = part.view(torch.int32).to(torch.int64) & _M32
        u = (u + sr_bits(idx, role)) & 0xFFFF0000
        out[start : start + step] = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(
            torch.float32)
    return out.view(v.shape)


def _softmax_parts(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``exp(theta - max)`` over each row's max (0 for a row that is all
    -inf) and the log of its row sum: the fast modes' rounded numerators and
    their float32 normalizer."""
    mx = theta.amax(dim=-1, keepdim=True)
    mx = torch.where(mx == -torch.inf, torch.zeros_like(mx), mx)
    num = torch.exp(theta - mx)
    return num, torch.log(num.sum(dim=-1, keepdim=True))


# --------------------------------------------------------------------------- #
# Plain PyTorch versions
# --------------------------------------------------------------------------- #
# ``mode`` rounds the operands as the kernels of that mode do (module
# docstring); a bf16 weight is widened to the activations' type, exactly.


def lse_matmul_ref(x: torch.Tensor, w: torch.Tensor, mode: str = "") -> torch.Tensor:
    """``log(exp(x - m) @ w^T) + m``, composed from PyTorch ops."""
    m = _clamp_max(x)
    e, w = torch.exp(x - m), w.to(x.dtype)
    if mode:
        e, w = round_bf16(e, mode, ROLE_E), round_bf16(w, mode, ROLE_W)
    return torch.log(torch.bmm(e, w.transpose(1, 2))) + m


def lse_matmul_softmax_ref(x: torch.Tensor, theta: torch.Tensor, mode: str = "") -> torch.Tensor:
    theta = theta.to(x.dtype)
    if not mode:
        return lse_matmul_ref(x, torch.softmax(theta, dim=-1))
    num, lz = _softmax_parts(theta)
    return lse_matmul_ref(x, num, mode) - lz.transpose(1, 2)


def lse_tucker2_ref(
    x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor, mode: str = "", *, round_w: bool = True
) -> torch.Tensor:
    """The Tucker contraction with the (F, B, K1*K2) outer product
    materialized, composed from PyTorch ops; ``round_w=False`` takes ``w``
    as already rounded in a fast mode."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    e2, w = torch.exp(x2 - m2), w.to(x1.dtype)
    if mode:
        e2 = round_bf16(e2, mode, ROLE_E)
        w = round_bf16(w, mode, ROLE_W) if round_w else w
    e = torch.exp(x1 - m1)[..., :, None] * e2[..., None, :]
    y = torch.bmm(e.reshape(f, b, k1 * k2), w.transpose(1, 2))
    return torch.log(y) + m1 + m2


def _tucker_fast_numerators(
    theta: torch.Tensor, k2: int, mode: str
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast Tucker forwards' weights from logits ``theta`` (F, O, K1*K2)
    and the log of their normalizer: in each tile (a row ``i`` of a chunk of
    ``_TUCKER_JC`` columns, chunk by chunk) ``exp(theta - r)`` over the
    unit's running max ``r`` of the tiles so far (a shift of 0 while it is
    -inf), rounded (role ``ROLE_W``, the element's flat index in
    ``theta``), then scaled by ``exp(r - m)`` to the final max ``m``, as the
    kernels rescale their sums; the normalizer sums the unrounded values so
    scaled."""
    f, o, width = theta.shape
    if width == 0:
        return theta, torch.full((f, o, 1), -torch.inf, dtype=theta.dtype, device=theta.device)
    k1, jc = width // k2, _TUCKER_JC
    nj = -(-k2 // jc)
    pad = nj * jc - k2
    th = theta.view(f, o, k1, k2)
    th = (torch.nn.functional.pad(th, (0, pad), value=-torch.inf) if pad else th).view(
        f, o, k1, nj, jc)
    order = th.amax(dim=-1).transpose(2, 3).reshape(f, o, nj * k1)  # the tiles' maxes in order
    run = torch.cummax(order, dim=-1).values.view(f, o, nj, k1).transpose(2, 3)[..., None]
    shift = torch.where(run == -torch.inf, torch.zeros_like(run), run)
    final = shift[:, :, -1:, -1:]  # the last tile's: the row's max, or 0
    scale = torch.where(run == -torch.inf, torch.zeros_like(run), torch.exp(shift - final))

    def flat(t):  # (F, O, K1, nj, jc or 1) -> (F, O, K1 K2)
        t = t.expand(f, o, k1, nj, jc).reshape(f, o, k1, nj * jc)
        return t[..., :k2].reshape(f, o, width)

    num, scale = flat(torch.exp(th - shift)), flat(scale)
    lz = torch.log((num * scale).sum(dim=-1, keepdim=True))
    return round_bf16(num, mode, ROLE_W) * scale, lz


def lse_tucker2_softmax_ref(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor, mode: str = ""
) -> torch.Tensor:
    theta = theta.to(x1.dtype)
    if not mode:
        return lse_tucker2_ref(x1, x2, torch.softmax(theta, dim=-1))
    w, lz = _tucker_fast_numerators(theta, x2.shape[2], mode)
    return lse_tucker2_ref(x1, x2, w, mode, round_w=False) - lz.transpose(1, 2)


def _blocked_fast_e(x: torch.Tensor, m: torch.Tensor, mode: str) -> torch.Tensor:
    """The fast blocked forward's exponentials: ``exp(x - r)`` over the
    row's clamped running max ``r`` of the chunks of ``_BLOCKED_KC`` columns
    up to each column's own, rounded (role ``ROLE_E``, the element's flat
    index in ``x``), then scaled by ``exp(r - m)`` to the final max ``m``,
    as the kernel rescales each chunk's sums."""
    f, b, i = x.shape
    kc = _BLOCKED_KC
    n = -(-i // kc)
    pad = n * kc - i
    xp = (torch.nn.functional.pad(x, (0, pad), value=-torch.inf) if pad else x).view(f, b, n, kc)
    info = torch.finfo(x.dtype)
    run = torch.cummax(xp.amax(dim=-1), dim=-1).values.clamp(info.min, info.max)[..., None]
    e = round_bf16(torch.exp(xp - run).view(f, b, n * kc)[..., :i], mode, ROLE_E)
    e = (torch.nn.functional.pad(e, (0, pad)) if pad else e).view(f, b, n, kc)
    e.mul_(torch.exp(run - m[..., None]))
    return e.view(f, b, n * kc)[..., :i]


def lse_matmul_blocked_ref(
    x: torch.Tensor, w: torch.Tensor, mode: str = ""
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the blocked forward: :func:`lse_matmul_ref` and
    the (F, B, 1) clamped row max of ``x`` that the blocked backward reads,
    the same in every mode. ``mode`` rounds as the kernel of that mode does
    (:func:`_blocked_fast_e`, the weight with role ``ROLE_W``)."""
    m = _clamp_max(x)
    w = w.to(x.dtype)
    if not mode:
        return torch.log(torch.bmm(torch.exp(x - m), w.transpose(1, 2))) + m, m
    e = _blocked_fast_e(x, m, mode)
    return torch.log(torch.bmm(e, round_bf16(w, mode, ROLE_W).transpose(1, 2))) + m, m


# The plain backward versions: the math of the backward kernel (and of the
# JAX package's ``_bwd_kernel``, ``cirkit_tpu/ops/lse_einsum.py:350-396``).
# ``needs`` says which gradients to compute, in argument order; the others
# come back as None.


def _gy(g: torch.Tensor, out: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``g / y = g * exp(shift - out)``, with non-finite values set to 0, so
    a row that is all -inf gives zero gradients and no NaN."""
    gy = g * torch.exp(shift - out)
    return torch.where(torch.isfinite(gy), gy, torch.zeros_like(gy))


def _softmax_vjp(w: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The softmax VJP on the logits: ``w * (dw - sum_c w_c dw_c)`` per row."""
    return w * (dw - (w * dw).sum(dim=-1, keepdim=True))


def softmax_vjp_from_g(
    w: torch.Tensor, dw: torch.Tensor, g: torch.Tensor, gy: torch.Tensor
) -> torch.Tensor:
    """The softmax VJP as the float32 backward kernel's dw epilogue forms it:
    ``w * (dw - r)`` with the row dot ``r_o = sum_c w_oc dw_oc`` taken as
    ``sum_b g_bo`` over the rows whose ``gy`` (:func:`_gy`) is nonzero. Since
    ``sum_c w_oc e_bc = exp(out_bo - shift_b)``, ``gy_bo`` times it is
    ``g_bo``; where gy was zeroed, or g is 0, the row adds nothing."""
    r = torch.where(gy != 0, g, torch.zeros_like(g)).sum(dim=1)[..., None]
    return w * (dw - r)


def lse_matmul_bwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
    mode: str = "",
    *,
    round_w: bool = True,
    m: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of :func:`lse_matmul`: ``dx = e * (gy @ w)`` and
    ``dw = sum_b gy^T e`` with ``e = exp(x - m)``, ``m`` the clamped row max
    of ``x`` unless given; ``dw`` has the activations' type.
    ``round_w=False`` keeps the weights of ``gy @ w`` unrounded in a fast
    mode (the softmax weights, module docstring)."""
    m = _clamp_max(x) if m is None else m
    e = torch.exp(x - m)
    gy = _gy(g, out, m)
    w = w.to(x.dtype)
    if mode:
        gy_r = round_bf16(gy, mode, ROLE_GY)
        w = round_bf16(w, mode, ROLE_WB) if round_w else w
        dx = e * torch.bmm(gy_r, w) if needs[0] else None
        dw = torch.bmm(gy_r.transpose(1, 2), round_bf16(e, mode, ROLE_EB)) if needs[1] else None
        return dx, dw
    dx = e * torch.bmm(gy, w) if needs[0] else None
    dw = torch.bmm(gy.transpose(1, 2), e) if needs[1] else None
    return dx, dw


def _fast_softmax_weights(theta: torch.Tensor) -> torch.Tensor:
    """The fast backward's weights ``exp(theta - lse)``, formed from the
    row's log-normalizer as the backward kernel forms them."""
    return torch.exp(theta - torch.logsumexp(theta, dim=-1, keepdim=True))


def bf16_pair(w: torch.Tensor) -> torch.Tensor:
    """``w`` as the fast Tucker backward's ``t = gy @ w`` takes softmax
    weights (``csrc/tucker_bf16_bwd.cu``): the bf16 pair ``hi + lo``, ``hi``
    and ``lo = w - hi`` each rounded to the nearest bf16, exact in float32
    (within 2^-17 |w| of ``w``). A sum of signed terms that cancels would
    carry that difference far above its result, so the plain versions form
    ``t`` from the pair too."""
    hi = w.to(torch.bfloat16).to(w.dtype)
    return hi + (w - hi).to(torch.bfloat16).to(w.dtype)


def lse_matmul_softmax_bwd_ref(
    x: torch.Tensor,
    theta: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
    mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dtheta)`` of :func:`lse_matmul_softmax`."""
    theta = theta.to(x.dtype)
    if mode:
        w = _fast_softmax_weights(theta)
        dx, dw = lse_matmul_bwd_ref(x, w, out, g, needs, mode, round_w=False)
        if dw is not None:
            dw = softmax_vjp_from_g(w, dw, g, _gy(g, out, _clamp_max(x)))
        return dx, dw
    w = torch.softmax(theta, dim=-1)
    dx, dw = lse_matmul_bwd_ref(x, w, out, g, needs)
    return dx, None if dw is None else _softmax_vjp(w, dw)


def lse_matmul_blocked_bwd_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    m: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool] = (True, True),
    mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``(dx, dw)`` of the blocked :func:`lse_matmul` (the math of the JAX
    package's ``_blocked_bwd_kernel``, ``cirkit_tpu/ops/lse_einsum.py:572``),
    with the forward's row max ``m`` as the shift, rounded in ``mode`` as
    :func:`lse_matmul_bwd_ref` rounds; ``dw`` has the activations' type."""
    return lse_matmul_bwd_ref(x, w, out, g, needs, mode, m=m)


def lse_tucker2_bwd_ref(
    x1: torch.Tensor,
    x2: torch.Tensor,
    w: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
    mode: str = "",
    *,
    round_w: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dw)`` of :func:`lse_tucker2`, with ``s = gy @ w``:
    ``dx1[b,i] = e1[b,i] sum_j s[b,i*K2+j] e2[b,j]``,
    ``dx2[b,j] = e2[b,j] sum_i s[b,i*K2+j] e1[b,i]`` and ``dw = sum_b gy^T e``
    over the (F, B, K1*K2) outer product ``e``, which this materializes."""
    f, b, k1 = x1.shape
    k2 = x2.shape[2]
    m1 = _clamp_max(x1)
    m2 = _clamp_max(x2)
    e1 = torch.exp(x1 - m1)
    e2 = torch.exp(x2 - m2)
    gy = _gy(g, out, m1 + m2)
    w = w.to(x1.dtype)
    if mode:
        gy = round_bf16(gy, mode, ROLE_GY)
        w = round_bf16(w, mode, ROLE_WB) if round_w else w
    dx1 = dx2 = dw = None
    if needs[0] or needs[1]:
        s = torch.bmm(gy, w).reshape(f, b, k1, k2)
        if needs[0]:
            dx1 = e1 * (s @ e2[..., None])[..., 0]
        if needs[1]:
            dx2 = e2 * (e1[..., None, :] @ s)[..., 0, :]
    if needs[2]:
        e = (e1[..., :, None] * e2[..., None, :]).reshape(f, b, k1 * k2)
        if mode:
            e = round_bf16(e, mode, ROLE_EB)
        dw = torch.bmm(gy.transpose(1, 2), e)
    return dx1, dx2, dw


def lse_tucker2_softmax_bwd_ref(
    x1: torch.Tensor,
    x2: torch.Tensor,
    theta: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, bool, bool] = (True, True, True),
    mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``(dx1, dx2, dtheta)`` of :func:`lse_tucker2_softmax`."""
    theta = theta.to(x1.dtype)
    if mode:
        w = _fast_softmax_weights(theta)
        dx1, dx2, dw = lse_tucker2_bwd_ref(x1, x2, bf16_pair(w), out, g, needs, mode,
                                           round_w=False)
        if dw is not None:
            shift = _clamp_max(x1) + _clamp_max(x2)
            dw = softmax_vjp_from_g(w, dw, g, _gy(g, out, shift))
        return dx1, dx2, dw
    w = torch.softmax(theta, dim=-1)
    dx1, dx2, dw = lse_tucker2_bwd_ref(x1, x2, w, out, g, needs)
    return dx1, dx2, None if dw is None else _softmax_vjp(w, dw)


# --------------------------------------------------------------------------- #
# Kernel launches
# --------------------------------------------------------------------------- #


def _check_dense(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[2]:
        raise ValueError(f"Expected x (F, B, I) and w (F, O, I), found {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _check_tucker(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> None:
    if (
        x1.dim() != 3
        or x2.dim() != 3
        or w.dim() != 3
        or x1.shape[:2] != x2.shape[:2]
        or w.shape[0] != x1.shape[0]
        or w.shape[2] != x1.shape[2] * x2.shape[2]
    ):
        raise ValueError(
            f"Expected x1 (F, B, K1), x2 (F, B, K2) and w (F, O, K1*K2), found "
            f"{tuple(x1.shape)}, {tuple(x2.shape)} and {tuple(w.shape)}"
        )


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


_EAGER_TYPES = (torch.Tensor, torch.nn.Parameter)


def _traced(t: torch.Tensor) -> bool:
    """Whether a launch goes through its operator (:func:`launch_op`): only
    under a tracer, whose tensors (``torch.export``'s fake and functional
    ones) are subclasses, or under Dynamo. An eager tensor calls the launcher
    itself, which checks its device: the operator's dispatch costs every
    launch microseconds of host time, which the host-bound paths (the CP
    flagship, the SoS circuits) pay end to end."""
    return type(t) not in _EAGER_TYPES or torch.compiler.is_compiling()


def _no_graph_through_kernel(op: str, *ts: torch.Tensor) -> None:
    """Refuse a graph of the backward (``create_graph=True``, under which
    autograd runs ``backward`` with grad mode on) on CUDA tensors: the
    backward kernel's outputs carry no graph, so a second derivative through
    it would lose every term that passes through the kernel. The plain
    versions on the CPU stay differentiable; a caller that needs a second
    derivative on the card evaluates the circuit with ``plain=True``."""
    if torch.is_grad_enabled() and not _on_cpu(*ts):
        raise RuntimeError(
            f"{op}: the CUDA backward kernel is not differentiable; a second derivative "
            "(create_graph=True) needs the plain compositions (evaluate with plain=True)"
        )


def _check_cuda(
    op: str, ts: tuple[torch.Tensor, ...], dtypes: tuple[torch.dtype, ...] = (torch.float32,)
) -> torch.device:
    """The common device of a CUDA launch's operands, checked: one device,
    contiguous, each of a type in ``dtypes``."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: tensors on {dev}; the op runs on CPU or CUDA tensors")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{op}: operands on {dev} and {t.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{op}: the CUDA kernel takes {names} operands, found {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: the CUDA kernel takes contiguous operands")
    return dev


def _check_single_pass(op: str, ts: tuple[torch.Tensor, ...]) -> tuple[torch.device, str]:
    """The device of a launch's real operands and the suffix of its entries:
    the real kernels (single-pass, wide and routing) are built for float32
    (no suffix) and float64 (``_f64``), and every operand has the type of
    the first."""
    double = ts[0].dtype == torch.float64
    dev = _check_cuda(op, ts, (torch.float64 if double else torch.float32,))
    return dev, "_f64" if double else ""


def _call(lib, entry: str, op: str, args) -> None:
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.cirkit_cuda_error_string(err).decode()
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err} ({msg})")


def _sizes(ins: tuple[torch.Tensor, ...]) -> tuple[int, ...]:
    """(F, B, I, O) of the dense ops, (F, B, K1, K2, O) of the Tucker ones."""
    *xs, w = ins
    return (*xs[0].shape[:2], *(x.shape[2] for x in xs), w.shape[1])


def _check_weighted(
    op: str, acts: tuple[torch.Tensor, ...], w: torch.Tensor, mode: str
) -> tuple[torch.device, str, str]:
    """The device, the type suffix and the instance suffix (:data:`INSTANCES`)
    of a launch of a kernel with bf16 or fast instances (kernels 1-9): the
    activations all float32 or all float64, the weight of their type or,
    beside float32, bf16; float64 runs no fast mode."""
    dev, suffix = _check_single_pass(op, acts)
    if w.device != dev:
        raise ValueError(f"{op}: operands on {dev} and {w.device}")
    _check_cuda(op, (w,), (torch.float64,) if suffix else (torch.float32, torch.bfloat16))
    if suffix and mode:
        raise ValueError(f"{op}: float64 runs no fast mode, found {mode!r}")
    return dev, suffix, ("_w16" if w.dtype == torch.bfloat16 else "") + MODE_SUFFIX[mode]


def _launch_fwd(op: str, ins: tuple[torch.Tensor, ...], mode: str = "") -> torch.Tensor:
    """Check the operands, allocate the output and launch the forward entry
    of ``op`` (in ``mode``, on the weight's type) on the current stream."""
    entry = _ENTRIES[op][0]
    dev, suffix, inst = _check_weighted(op, ins[:-1], ins[-1], mode)
    if mode:  # kernels 1 and 5 run one fast-mode kernel, under kernel 1's entries
        entry = entry.replace("lse_fwd_ct", "lse_fwd_tucker")
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    width = ins[-1].shape[2]  # the kernels index a weight row with an int
    if max(*sizes, width) >= 2**31 or -(-o // _BN) > _MAX_GRID_YZ or -(-b // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"{op}: sizes {sizes} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=ins[0].dtype)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*(t.data_ptr() for t in ins), out.data_ptr(), *sizes, dev.index, stream)
    _call(lib, entry + suffix + inst, op, args)
    LAUNCHES[op + inst] += 1
    return out


_LIBRARY = torch.library.Library("cirkit_tpu_torch", "DEF")  # noqa: TOR901


def launch_op(name: str, schema: str, launch, fake):
    """``torch.ops.cirkit_tpu_torch.<name>``: a kernel launch as an operator
    that ``torch.export`` records as one node, ``launch`` on CUDA tensors
    and ``fake`` (the outputs' shapes and types) on the meta ones it traces
    with. The library API's operators, unlike ``torch.library.custom_op``'s,
    do not import ``torch._dynamo`` at their first call (seconds of every
    process's first forward)."""
    _LIBRARY.define(f"{name}{schema}")
    _LIBRARY.impl(name, launch, "CUDA")
    _LIBRARY.impl(name, fake, "Meta")
    return getattr(torch.ops.cirkit_tpu_torch, name).default


def _fwd_op_fake(op: str, mode: str, ins: list[torch.Tensor]) -> torch.Tensor:
    sizes = _sizes(tuple(ins))
    return ins[0].new_empty((sizes[0], sizes[1], sizes[-1]))


_fwd_op = launch_op("lse_fwd", "(str op, str mode, Tensor[] ins) -> Tensor",
                    lambda op, mode, ins: _launch_fwd(op, tuple(ins), mode), _fwd_op_fake)


def _bf16_tucker_bwd(op: str, mode: str, suffix: str) -> bool:
    """Whether the backward of ``op`` in ``mode`` on activations of entry
    suffix ``suffix`` runs ``tucker_bwd_bf16`` (``csrc/tucker_bf16_bwd.cu``):
    the float32 Tucker ops in a fast mode. It writes the weight's gradient in
    the weight's type (the round-to-nearest of its float32 sum, the cast that
    :func:`backward` makes of the other kernels' float32 gradient) and takes
    the scratch of :func:`_tucker_bf16_bwd_scratch`."""
    return bool(mode) and not suffix and op.startswith("lse_tucker2")


def _tucker_bf16_bwd_scratch(softmax: bool, f: int, b: int, k1: int, k2: int, o: int) -> int:
    """The float32 scratch of the fast Tucker backward: e1 and e2 transposed,
    (F, K1, Bp) and (F, K2, Bp), and the rounded gy in bf16, (F, B, Op), with
    Bp and Op the batch and the units rounded up to 8 (rows that TMA copies);
    for logits each weight row's lse and r_o, (F, O) each; the dx1 partials,
    one (F, B, K1) plane a unit group and column chunk where there are more
    than one; the dx2 partials, one (F, B, K2) plane a unit group where there
    are more than one."""
    n_ug, n_jc = -(-o // _BWD_UNIT_GROUP), -(-k2 // _TUCKER_JC)
    bp, op = -(-b // 8) * 8, -(-o // 8) * 8
    p1 = n_ug * n_jc
    return (f * (k1 + k2) * bp + f * b * op // 2 + (2 * f * o if softmax else 0)
            + (p1 * f * b * k1 if p1 > 1 else 0) + (n_ug * f * b * k2 if n_ug > 1 else 0))


_TC_TUCKER_TILE = (64, 16)
"""The tiles of the float32 Tucker dx kernel on the tensor cores, ``tc_dx::BN``
columns ``j`` and ``tc_tucker::I_PER`` rows ``i`` of ``csrc/lse_einsum_bwd.cu``
(a test reads them there): its dx1 sums are partial over the column tiles and
its dx2 sums over the row tiles (:func:`_tucker_tc_scratch`)."""


def _tucker_tc_scratch(softmax: bool, f: int, b: int, k1: int, k2: int, o: int) -> int:
    """The float32 scratch ``ws`` of the float32-grade Tucker backward on the
    tensor cores (``tc_scratch`` of ``csrc/lse_einsum_bwd.cu``, which the
    signed Tucker ops size here): for logits each weight row's lse and r_o,
    (F, O) each; the dx1 partials, a (F, B, K1) plane a column tile, then the
    dx2 partials, a (F, B, K2) plane a row tile."""
    bn, i_per = _TC_TUCKER_TILE
    return (2 * f * o if softmax else 0) + f * b * (-(-k2 // bn) * k1 + -(-k1 // i_per) * k2)


def _launch_bwd(
    op: str, ins: tuple[torch.Tensor, ...], out: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, ...], mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """Allocate the requested gradients and the scratch, and launch the
    backward entry of ``op`` (in ``mode``, on the weight's type) on the
    current stream. The weight's gradient has the activations' type, or the
    weight's where :func:`_bf16_tucker_bwd`."""
    dev, suffix, inst = _check_weighted(f"{op} backward", (*ins[:-1], out, g), ins[-1], mode)
    bf16_tucker = _bf16_tucker_bwd(op, mode, suffix)
    grads = tuple(
        torch.empty(t.shape, device=dev,
                    dtype=t.dtype if bf16_tucker and t is ins[-1] else ins[0].dtype)
        if need else None
        for t, need in zip(ins, needs)
    )
    if not any(needs):
        return grads
    if out.numel() == 0 or any(t.numel() == 0 for t in ins):
        return tuple(None if d is None else d.zero_() for d in grads)
    sizes = _sizes(ins)
    f, b, o = sizes[0], sizes[1], sizes[-1]
    i = ins[-1].shape[2]
    tucker = op.startswith("lse_tucker2")
    if max(-(-b // _BWD_ROWS), -(-o // _BWD_ROWS), -(-i // _BWD_DX_COLS)) > _MAX_GRID_YZ:
        raise ValueError(f"{op} backward: sizes {sizes} exceed the kernel's launch grid")
    lib = _build.library()
    softmax = op.endswith("softmax")
    # scratch: the row shifts and gy; in float64 gy's buffer also holds the
    # partial sums of a Tucker dx split over K1 (lse_bwd_gy_size), and for
    # softmax the (F, O, I) weights follow; in float32 what the tensor-core
    # path asks for (the softmax statistics, the Tucker dx partials)
    k1, k2 = sizes[2:4] if tucker else (i, 1)
    scratch = [torch.empty((f, b), device=dev, dtype=ins[0].dtype)
               for _ in range(2 if tucker else 1)]
    if suffix:
        n = lib.lse_bwd_gy_size_f64(0, int(tucker), f, b, k1, k2, o)
        scratch.append(torch.empty(n, device=dev, dtype=ins[0].dtype))
        if softmax:
            scratch.append(torch.empty_like(ins[-1]))
    else:
        scratch.append(torch.empty((f, b, o), device=dev, dtype=ins[0].dtype))
        n = (_tucker_bf16_bwd_scratch(softmax, f, b, k1, k2, o) if bf16_tucker
             else lib.lse_bwd_scratch(int(tucker), int(softmax), f, b, k1, k2, o))
        if n:
            scratch.append(torch.empty(n, device=dev, dtype=torch.float32))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (*ins, out, g)),
        *(None if d is None else d.data_ptr() for d in grads),
        *(t.data_ptr() for t in scratch),
        *sizes,
        dev.index,
        stream,
    )
    _call(lib, _ENTRIES[op][1] + suffix + inst, f"{op} backward", args)
    LAUNCHES[f"{op}{inst}_bwd"] += 1
    return grads


def _launch_blocked_fwd(
    x: torch.Tensor, w: torch.Tensor, mode: str = ""
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the blocked dense forward (in ``mode``, on the weight's type):
    the output and the (F, B, 1) row max."""
    op = "lse_matmul_blocked"
    dev, suffix, inst = _check_weighted(op, (x,), w, mode)
    f, b, i = x.shape
    o = w.shape[1]
    # one block per (fold, batch tile, unit tile), counted in one grid axis
    tile_b, tile_o = _BLOCKED_TILES[suffix]
    if max(f, b, i, o) >= 2**31 or f * -(-b // tile_b) * -(-o // tile_o) >= 2**31:
        raise ValueError(f"{op}: sizes {(f, b, i, o)} exceed the kernel's launch grid")
    out = torch.empty((f, b, o), device=dev, dtype=x.dtype)
    m = torch.empty((f, b, 1), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out, m
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m.data_ptr(), f, b, i, o, dev.index,
            stream)
    _call(_build.library(), "lse_fwd_blocked" + suffix + inst, op, args)
    LAUNCHES[op + inst] += 1
    return out, m


def _blocked_gy_shape(f: int, b: int, o: int, suffix: str, inst: str = "") -> tuple[int, ...]:
    """The shape of the blocked backward's gy scratch (of the type
    :func:`_blocked_gy_dtype` gives): (F, B, O) for the float64 kernel; for
    the float32 one, which keeps a plane of TF32 high parts and one of low
    parts, (F, B, O, 2); for the bf16-weight and fast-mode instances
    (``inst``, ``csrc/blocked_bf16.cu``) gy rounded to bf16, its rows padded
    to a multiple of 8 units, one plane, or for the f32-grade ``_w16`` its
    split hi, lo: two."""
    if suffix:
        return (f, b, o)
    if not inst:
        return (f, b, o, 2)
    return (2 if inst == "_w16" else 1, f, b, -(-o // 8) * 8)


def _blocked_gy_dtype(dtype: torch.dtype, inst: str) -> torch.dtype:
    """The type of the blocked backward's gy scratch beside activations of
    ``dtype``: bf16 for the bf16-weight and fast-mode instances."""
    return torch.bfloat16 if inst else dtype


def _blocked_dw_dtype(dtype: torch.dtype, inst: str) -> torch.dtype:
    """The type of the weight's gradient that the blocked backward writes
    beside activations of ``dtype``: the weight's own, bf16 for the ``_w16``
    instances (the nearest to the f32 sum), the activations' for the
    others, whose weight has the activations' type."""
    return torch.bfloat16 if inst.startswith("_w16") else dtype


def _launch_blocked_bwd(
    x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
    needs: tuple[bool, bool], mode: str = "",
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Allocate the requested gradients and the gy scratch, and launch the
    blocked dense backward (in ``mode``, on the weight's type). The weight's
    gradient has the weight's type (:func:`_blocked_dw_dtype`)."""
    op = "lse_matmul_blocked"
    dev, suffix, inst = _check_weighted(f"{op} backward", (x, out, m, g), w, mode)
    dx, dw = (torch.empty(t.shape, device=dev, dtype=dt) if need else None
              for t, dt, need in zip((x, w), (x.dtype, _blocked_dw_dtype(x.dtype, inst)), needs))
    if not any(needs):
        return dx, dw
    if out.numel() == 0 or x.numel() == 0:
        return tuple(None if d is None else d.zero_() for d in (dx, dw))
    f, b, i = x.shape
    o = w.shape[1]
    # gy: one block per (fold, 8 rows); the rest: one per (fold, 64 columns)
    if (max(f, b, i, o) >= 2**31 or -(-b // _BWD_ROWS) > _MAX_GRID_YZ
            or f * -(-i // _BWD_DX_COLS) >= 2**31):
        raise ValueError(f"{op} backward: sizes {(f, b, i, o)} exceed the kernel's launch grid")
    gy = torch.empty(_blocked_gy_shape(f, b, o, suffix, inst), device=dev,
                     dtype=_blocked_gy_dtype(x.dtype, inst))
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        *(t.data_ptr() for t in (x, w, out, m, g)),
        *(None if d is None else d.data_ptr() for d in (dx, dw)),
        gy.data_ptr(), f, b, i, o, dev.index, stream,
    )
    _call(_build.library(), "lse_bwd_blocked" + suffix + inst, f"{op} backward", args)
    LAUNCHES[f"{op}{inst}_bwd"] += 1
    return dx, dw


# op -> (forward entry, backward entry, forward plain version, backward plain
# version); the K1-chunked Tucker forwards share their op's backward
_ENTRIES = {
    "lse_matmul": ("lse_fwd_dense", "lse_bwd_dense", lse_matmul_ref, lse_matmul_bwd_ref),
    "lse_matmul_softmax": ("lse_fwd_dense_softmax", "lse_bwd_dense_softmax",
                           lse_matmul_softmax_ref, lse_matmul_softmax_bwd_ref),
    "lse_tucker2": ("lse_fwd_tucker", "lse_bwd_tucker", lse_tucker2_ref, lse_tucker2_bwd_ref),
    "lse_tucker2_softmax": ("lse_fwd_tucker_softmax", "lse_bwd_tucker_softmax",
                            lse_tucker2_softmax_ref, lse_tucker2_softmax_bwd_ref),
    "lse_tucker2_chunked": ("lse_fwd_ct", None, lse_tucker2_ref, None),
    "lse_tucker2_softmax_chunked": ("lse_fwd_ct_softmax", None, lse_tucker2_softmax_ref, None),
}


def _forward(ctx, op: str, mode: str, *ins: torch.Tensor) -> torch.Tensor:
    if _on_cpu(*ins):
        # the plain version takes a mode only where one is set
        out = _ENTRIES[op][2](*ins, mode=mode) if mode else _ENTRIES[op][2](*ins)
    else:
        out = _fwd_op(op, mode, list(ins)) if _traced(ins[0]) else _launch_fwd(op, ins, mode)
    ctx.save_for_backward(*ins, out)
    ctx.mode = mode
    return out


def backward(
    op: str,
    ins: tuple[torch.Tensor, ...],
    out: torch.Tensor,
    g: torch.Tensor,
    needs: tuple[bool, ...] | None = None,
    mode: str = "",
) -> tuple[torch.Tensor | None, ...]:
    """The gradients of ``op`` (one of :data:`OPS`) with respect to its
    arguments ``ins``, given its output ``out`` and the cotangent ``g``;
    ``needs`` (default: all) selects which, ``mode`` is the forward's speed
    mode. The plain version on CPU tensors, the backward kernel on CUDA
    tensors; the weight's gradient is accumulated in the activations' type
    and cast to the weight's (by the fast Tucker kernel itself)."""
    needs = (True,) * len(ins) if needs is None else tuple(needs)
    if _on_cpu(*ins, out, g):
        plain = _ENTRIES[op][3]
        grads = plain(*ins, out, g, needs, mode) if mode else plain(*ins, out, g, needs)
    else:
        grads = _launch_bwd(op, tuple(ins), out, g, needs, mode)
    dw = grads[-1]
    return (*grads[:-1], None if dw is None else dw.to(ins[-1].dtype))


def _backward(ctx, op: str, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    *ins, out = ctx.saved_tensors
    _no_graph_through_kernel(op, *ins)
    needs = ctx.needs_input_grad[: len(ins)]
    return (*backward(op, tuple(ins), out, g.contiguous(), needs, ctx.mode), None)


# --------------------------------------------------------------------------- #
# The differentiable ops
# --------------------------------------------------------------------------- #
# Each takes its speed mode as a last, non-tensor argument.


class LseMatmul(torch.autograd.Function):
    """:func:`lse_matmul` with its backward kernel."""

    @staticmethod
    def forward(ctx, x, w, mode):
        return _forward(ctx, "lse_matmul", mode, x, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_matmul", g)


class LseMatmulSoftmax(torch.autograd.Function):
    """:func:`lse_matmul_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, x, theta, mode):
        return _forward(ctx, "lse_matmul_softmax", mode, x, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_matmul_softmax", g)


class LseTucker2(torch.autograd.Function):
    """:func:`lse_tucker2` with its backward kernel."""

    @staticmethod
    def forward(ctx, x1, x2, w, mode):
        return _forward(ctx, "lse_tucker2", mode, x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2", g)


class LseTucker2Softmax(torch.autograd.Function):
    """:func:`lse_tucker2_softmax`; the backward returns the logits' gradient."""

    @staticmethod
    def forward(ctx, x1, x2, theta, mode):
        return _forward(ctx, "lse_tucker2_softmax", mode, x1, x2, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2_softmax", g)


class LseTucker2Chunked(torch.autograd.Function):
    """The wide :func:`lse_tucker2`: the K1-chunked forward kernel, the
    backward kernel of :class:`LseTucker2` (the same gradient as the JAX
    package's ``_ct_p_bwd``)."""

    @staticmethod
    def forward(ctx, x1, x2, w, mode):
        return _forward(ctx, "lse_tucker2_chunked", mode, x1, x2, w)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2", g)


class LseTucker2SoftmaxChunked(torch.autograd.Function):
    """The wide :func:`lse_tucker2_softmax`: the K1-chunked forward kernel
    with its online softmax, the backward kernel of :class:`LseTucker2Softmax`."""

    @staticmethod
    def forward(ctx, x1, x2, theta, mode):
        return _forward(ctx, "lse_tucker2_softmax_chunked", mode, x1, x2, theta)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, "lse_tucker2_softmax", g)


def _blocked_fwd_op_fake(
    x: torch.Tensor, w: torch.Tensor, mode: str = ""
) -> tuple[torch.Tensor, torch.Tensor]:
    f, b, _ = x.shape
    return x.new_empty((f, b, w.shape[1])), x.new_empty((f, b, 1))


_blocked_fwd_op = launch_op(
    "lse_fwd_blocked", "(Tensor x, Tensor w, str mode=\"\") -> (Tensor, Tensor)",
    lambda x, w, mode="": _launch_blocked_fwd(x, w, mode), _blocked_fwd_op_fake)


class LseMatmulBlocked(torch.autograd.Function):
    """The wide :func:`lse_matmul`: the blocked forward saves the row max it
    returns for the blocked backward; the weight's gradient has the weight's
    type (the kernels write it so; the plain version's is cast)."""

    @staticmethod
    def forward(ctx, x, w, mode):
        if _on_cpu(x, w):
            out, m = lse_matmul_blocked_ref(x, w, mode)
        else:
            out, m = (_blocked_fwd_op if _traced(x) else _launch_blocked_fwd)(x, w, mode)
        ctx.save_for_backward(x, w, out, m)
        ctx.mode = mode
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out, m = ctx.saved_tensors
        _no_graph_through_kernel("lse_matmul_blocked", x, w)
        g = g.contiguous()
        needs = tuple(ctx.needs_input_grad[:2])
        if _on_cpu(x, w, out, m, g):
            dx, dw = lse_matmul_blocked_bwd_ref(x, w, out, m, g, needs, ctx.mode)
        else:
            dx, dw = _launch_blocked_bwd(x, w, out, m, g, needs, ctx.mode)
        return dx, None if dw is None else dw.to(w.dtype), None


def _wide(width: int) -> bool:
    return width >= WIDE_WIDTH


def lse_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused ``log(exp(x - max) @ w^T) + max`` over the trailing axis.

    ``x``: (F, B, I) log-space values; ``w``: (F, O, I) linear-space weights
    (bf16 beside float32 ``x``: the serving store). Returns (F, B, O)
    log-space values. Wide I takes the blocked kernels, in the same modes
    and on the same weight types."""
    _check_dense(x, w)
    fn = LseMatmulBlocked if _wide(x.shape[2]) else LseMatmul
    return fn.apply(x, _weight_for(x, w), _op_mode(x))


def lse_matmul_softmax(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """:func:`lse_matmul` with ``w = softmax(theta, axis=-1)`` fused into the
    kernel: the normalized weights are never stored. At wide I the weights
    are normalized first (a bf16 theta widened, as the JAX package does) and
    go through the blocked kernels."""
    _check_dense(x, theta)
    if _wide(x.shape[2]):
        return lse_matmul(x, torch.softmax(widened(theta, x), dim=-1))
    return LseMatmulSoftmax.apply(x, _weight_for(x, theta), _op_mode(x))


def lse_tucker2(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Fused arity-2 Tucker contraction under the lse-sum semiring.

    ``x1``: (F, B, K1) and ``x2``: (F, B, K2) log-space inputs; ``w``:
    (F, O, K1*K2) linear-space core weight, flattened row-major over (K1, K2).
    Returns (F, B, O) log-space values."""
    _check_tucker(x1, x2, w)
    fn = LseTucker2Chunked if _wide(w.shape[2]) else LseTucker2
    return fn.apply(x1, x2, _weight_for(x1, w), _op_mode(x1))


def lse_tucker2_softmax(
    x1: torch.Tensor, x2: torch.Tensor, theta: torch.Tensor
) -> torch.Tensor:
    """:func:`lse_tucker2` with ``w = softmax(theta, axis=-1)`` fused into
    the kernel (see :func:`lse_matmul_softmax`)."""
    _check_tucker(x1, x2, theta)
    fn = LseTucker2SoftmaxChunked if _wide(theta.shape[2]) else LseTucker2Softmax
    return fn.apply(x1, x2, _weight_for(x1, theta), _op_mode(x1))
