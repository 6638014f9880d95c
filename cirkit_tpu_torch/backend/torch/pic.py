"""Probabilistic Integral Circuits (PIC) and quadrature PCs (QPC).

The counterpart of ``cirkit_tpu/backend/jax/pic.py``: :func:`pc2qpc` returns
a new circuit plus a :class:`QuadratureParameterization`, an ``nn.Module``
holding one small "integral network" per generated store slot (its
``parameters()`` are what an optimizer trains) and the frozen remainder of
the store. :meth:`~QuadratureParameterization.materialize` computes the
converted circuit's full store from the networks, differentiably, so a
QPC trains by back-propagating the loss through ``materialize`` into the
networks.

The integral networks are random Fourier features of the quadrature points
followed by grouped 1x1-convolution MLPs:

- :class:`PICInputNet` generates input-layer parameter tensors (e.g. the
  (F, K, C) categorical logits) by evaluating a per-variable function at
  the K quadrature points.
- :class:`PICInnerNet` generates sum/Tucker/CPT weight tensors by
  evaluating a positive function on the quadrature mesh and normalizing it
  with the quadrature weights, so every generated weight tensor sums to
  one over its input axes.

Sharing modes: ``"none"`` (one head per variable/fold), ``"f"`` (fully
shared), ``"c"`` (composite: shared trunk, per-group heads initialized
equal). The networks' parameters carry the JAX package's names and shapes
(``ff``, ``w1``, ``b1``, ``w2``, ``b2``, and ``w3``, ``b3`` for the inner
net), so :func:`load_net_params` carries a JAX ``net_params`` dict across.
Initialization draws from a ``torch.Generator``; the draws differ from
``jax.random``'s.

The grouped linears are plain matrix products. A trunk shared by every
head (G_in = 1) meets the G heads in one ``(G P, D) @ (D, N)`` product: it
is never broadcast to (G, N, D), which at the K=64 flagship's largest
Tucker entry would be 784 x 64^3 x 64 floats.
"""

from __future__ import annotations

import copy
import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from cirkit_tpu_torch.backend.torch.circuit import TorchCircuit
from cirkit_tpu_torch.backend.torch.layers import (
    TorchCategoricalLayer,
    TorchGaussianLayer,
    TorchHadamardLayer,
    TorchInputLayer,
    TorchKroneckerLayer,
    TorchSumLayer,
)
from cirkit_tpu_torch.backend.torch.optimized import TorchCPTLayer, TorchTuckerLayer
from cirkit_tpu_torch.backend.torch.parameters import (
    Store,
    TorchMixingWeightParameter,
    TorchParameter,
    TorchSoftmaxParameter,
    TorchTensorSlot,
)
from cirkit_tpu_torch.backend.torch.utils import softplus

__all__ = [
    "PICInnerNet",
    "PICInputNet",
    "QuadratureParameterization",
    "fourier_features",
    "load_net_params",
    "pc2qpc",
    "zw_quadrature",
]


def zw_quadrature(
    integration_method: str,
    nip: int,
    a: float = -1.0,
    b: float = 1.0,
    *,
    return_log_weight: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature nodes and weights on [a, b] (ref: ``pic.py:25-60``).

    Supported: ``leggauss``, ``midpoint``, ``trapezoidal``, ``simpson``
    (odd ``nip``) and ``hermgauss`` (Gauss-Hermite on the real line).
    """
    if integration_method == "leggauss":
        z, w = np.polynomial.legendre.leggauss(nip)
        z = (b - a) * (z + 1.0) / 2.0 + a
        w = w * (b - a) / 2.0
    elif integration_method == "midpoint":
        edges = np.linspace(a, b, num=nip + 1)
        z = (edges[:-1] + edges[1:]) / 2.0
        w = np.full_like(z, (b - a) / nip)
    elif integration_method == "trapezoidal":
        z = np.linspace(a, b, num=nip)
        w = np.full((nip,), (b - a) / (nip - 1))
        w[0] = w[-1] = 0.5 * (b - a) / (nip - 1)
    elif integration_method == "simpson":
        if nip % 2 != 1:
            raise ValueError("Simpson's rule requires an odd number of points")
        z = np.linspace(a, b, num=nip)
        w = np.concatenate([[1.0], np.tile([4.0, 2.0], nip // 2 - 1), [4.0, 1.0]])
        w = (b - a) / (nip - 1) / 3.0 * w
    elif integration_method == "hermgauss":
        z, w = np.polynomial.hermite.hermgauss(nip)
    else:
        raise ValueError(f"Unknown integration method '{integration_method}'")
    if return_log_weight:
        w = np.log(w)
    return z.astype(np.float64), w.astype(np.float64)


def fourier_features(z: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """Random Fourier features: z (N, D), coeff (D, ff/2) -> (N, ff)
    (ref: ``FourierLayer``, ``pic.py:63-88``)."""
    proj = 2.0 * math.pi * (z @ coeff)
    return torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)


def _grouped_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x (G_in, N, D), w (G, D, P) -> (G, N, P), with G_in = G or 1. A
    shared x takes one (G P, D) @ (D, N) product: x is not broadcast. The
    bias is added by the product itself (``addmm``, ``baddbmm``), not by a
    broadcasting pass over the output."""
    g, d, p = w.shape
    if x.shape[0] == g:
        return torch.bmm(x, w) if b is None else torch.baddbmm(b[:, None, :], x, w)
    wt = w.transpose(1, 2).reshape(g * p, d)
    y = wt @ x[0].T if b is None else torch.addmm(b.reshape(g * p, 1), wt, x[0].T)
    return y.reshape(g, p, -1).transpose(1, 2)


class _Init:
    """The draws of a network's initialization, in the JAX package's order
    and distributions: ``normal`` for the Fourier coefficients, ``uniform``
    on +-1/sqrt(fan_in) for weights and biases."""

    def __init__(self, generator, dtype, device):
        self.kw = dict(generator=generator, dtype=dtype, device=device)

    def normal(self, shape, scale):
        return scale * torch.randn(shape, **self.kw)

    def uniform(self, shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, **self.kw) * 2.0 - 1.0) * bound


def _check_sharing(sharing: str, net_dim: int, ff_dim: int | None) -> int:
    if sharing not in ("none", "f", "c"):
        raise ValueError(f"Unknown sharing mode '{sharing}'")
    ff_dim = net_dim if ff_dim is None else ff_dim
    if ff_dim % 2 != 0:
        raise ValueError("The Fourier feature dimension must be even")
    return ff_dim


def _head(t: torch.Tensor, sharing: str) -> nn.Parameter:
    """A per-group head; under ``"c"`` every group starts as group 0's, each
    in its own storage (an expanded view would let an in-place optimizer
    step update every head at once)."""
    if sharing == "c":
        t = t[:1].expand(t.shape).clone()
    return nn.Parameter(t)


class PICInputNet(nn.Module):
    """Generates an input layer's (V, nip, P) parameter tensor by evaluating
    per-variable functions at the quadrature points."""

    def __init__(
        self,
        num_variables: int,
        num_param: int,
        sharing: str = "f",
        *,
        net_dim: int = 128,
        ff_dim: int | None = None,
        ff_sigma: float = 1.0,
        bias: bool = True,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        ff_dim = _check_sharing(sharing, net_dim, ff_dim)
        self.num_variables, self.num_param, self.sharing = num_variables, num_param, sharing
        g1 = 1 if sharing in ("f", "c") else num_variables
        g2 = 1 if sharing == "f" else num_variables
        draw = _Init(generator, dtype or torch.get_default_dtype(), device)
        self.ff = nn.Parameter(draw.normal((1, ff_dim // 2), ff_sigma))
        self.w1 = nn.Parameter(draw.uniform((g1, ff_dim, net_dim), ff_dim))
        self.w2 = _head(draw.uniform((g2, net_dim, num_param), net_dim), sharing)
        if bias:
            self.b1 = nn.Parameter(draw.uniform((g1, net_dim), ff_dim))
            self.b2 = _head(draw.uniform((g2, num_param), net_dim), sharing)
        else:
            self.register_parameter("b1", None)
            self.register_parameter("b2", None)

    def forward(self, z_quad: torch.Tensor) -> torch.Tensor:
        """z_quad (nip,) -> (num_variables, nip, num_param)."""
        phi = fourier_features(z_quad[:, None], self.ff)[None]  # (1, nip, ff)
        h = torch.tanh(_grouped_linear(phi, self.w1, self.b1))
        out = _grouped_linear(h, self.w2, self.b2)  # (G2, nip, P)
        return out.expand(self.num_variables, *out.shape[1:])


class PICInnerNet(nn.Module):
    """Generates a (num_funcs, nip, ..., nip) weight tensor over ``num_dim``
    quadrature axes, softplus-positive and normalized with the quadrature
    weights over ``norm_dim`` so the result sums to one per output unit."""

    def __init__(
        self,
        num_dim: int,
        num_funcs: int,
        norm_dim: tuple[int, ...],  # 1-based axes of the per-func mesh
        sharing: str = "c",
        *,
        net_dim: int = 128,
        ff_dim: int | None = None,
        ff_sigma: float = 1.0,
        bias: bool = True,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        ff_dim = _check_sharing(sharing, net_dim, ff_dim)
        self.num_dim, self.num_funcs = num_dim, num_funcs
        self.norm_dim, self.sharing = tuple(norm_dim), sharing
        g1 = 1 if sharing in ("f", "c") else num_funcs
        g2 = 1 if sharing == "f" else num_funcs
        draw = _Init(generator, dtype or torch.get_default_dtype(), device)
        self.ff = nn.Parameter(draw.normal((num_dim, ff_dim // 2), ff_sigma))
        self.w1 = nn.Parameter(draw.uniform((g1, ff_dim, net_dim), ff_dim))
        self.w2 = nn.Parameter(draw.uniform((g1, net_dim, net_dim), net_dim))
        self.w3 = _head(draw.uniform((g2, net_dim, 1), net_dim), sharing)
        if bias:
            self.b1 = nn.Parameter(draw.uniform((g1, net_dim), ff_dim))
            self.b2 = nn.Parameter(draw.uniform((g1, net_dim), net_dim))
            self.b3 = _head(draw.uniform((g2, 1), net_dim), sharing)
        else:
            for name in ("b1", "b2", "b3"):
                self.register_parameter(name, None)

    def forward(self, z_quad: torch.Tensor, w_quad: torch.Tensor) -> torch.Tensor:
        """-> (num_funcs, nip, ..., nip) with sum over norm_dim equal to 1."""
        nip, d = z_quad.shape[0], self.num_dim
        mesh = torch.stack(torch.meshgrid(*([z_quad] * d), indexing="ij"), dim=0)
        mesh = mesh.reshape(d, -1).T  # (nip^D, D)
        phi = fourier_features(mesh, self.ff)[None]
        h = torch.tanh(_grouped_linear(phi, self.w1, self.b1))
        h = torch.tanh(_grouped_linear(h, self.w2, self.b2))
        out = _grouped_linear(h, self.w3, self.b3)[..., 0]  # (G2, nip^D)
        eps = math.sqrt(torch.finfo(out.dtype).tiny)
        logits = (softplus(out) + eps).reshape(out.shape[0], *([nip] * d))
        logits = logits.expand(self.num_funcs, *logits.shape[1:])
        w_shape = [nip if i in self.norm_dim else 1 for i in range(d + 1)]
        w_mesh = torch.stack(
            torch.meshgrid(*([w_quad] * len(self.norm_dim)), indexing="ij"), dim=0
        ).prod(dim=0).reshape(w_shape)
        weighted = logits * w_mesh
        return weighted / weighted.sum(dim=self.norm_dim, keepdim=True)


class QuadratureParameterization(nn.Module):
    """The trainable state of a QPC: per-slot generator networks plus the
    frozen remainder of the original parameter store.

    ``nets`` maps each generated slot to its network, so ``parameters()``
    is what an optimizer trains. ``materialize()`` evaluates every network
    at its quadrature grid and returns a full store for the converted
    circuit, differentiable into the networks; ``materialize(net_params)``
    evaluates them with the tensors of a nested dict ``{slot: {name:
    tensor}}`` in place of their own (the JAX package's signature).
    """

    def __init__(
        self,
        nets: Mapping[str, nn.Module],
        grids: Mapping[str, tuple[tuple[torch.Tensor, ...], tuple[int, ...]]],
        frozen: Mapping[str, torch.Tensor],
    ):
        super().__init__()
        self.nets = nn.ModuleDict(nets)
        # slot -> (the network's quadrature inputs, the slot's (F, ...) shape)
        self.grids = dict(grids)
        self.frozen = {k: v.detach() for k, v in frozen.items()}

    @property
    def net_params(self) -> dict[str, dict[str, torch.Tensor]]:
        """The networks' parameters as ``{slot: {name: tensor}}``."""
        return {s: dict(net.named_parameters()) for s, net in self.nets.items()}

    def materialize(self, net_params: Mapping[str, Mapping[str, torch.Tensor]] | None = None
                    ) -> dict[str, torch.Tensor]:
        store = dict(self.frozen)
        for slot, net in self.nets.items():
            inputs, shape = self.grids[slot]
            if net_params is None:
                out = net(*inputs)
            else:
                out = functional_call(net, dict(net_params[slot]), inputs)
            store[slot] = out.reshape(shape)
        return store


def load_net_params(qp: QuadratureParameterization,
                    net_params: Mapping[str, Mapping[str, np.ndarray]]) -> None:
    """Copy ``net_params`` (``{slot: {name: array}}``, e.g. a JAX
    ``QuadratureParameterization.net_params`` as numpy) into ``qp``'s
    networks by slot and parameter name, in each parameter's dtype. Raises
    ``ValueError`` on a missing or extra slot or name, or a wrong shape."""
    if set(net_params) != set(qp.nets):
        raise ValueError(
            f"net_params slots {sorted(net_params)} do not match the networks' "
            f"{sorted(qp.nets)}"
        )
    for slot, net in qp.nets.items():
        own = dict(net.named_parameters())
        given = net_params[slot]
        if set(given) != set(own):
            raise ValueError(
                f"net_params[{slot!r}] names {sorted(given)} do not match the network's "
                f"{sorted(own)}"
            )
        for name, p in own.items():
            shape = np.shape(given[name])
            if tuple(shape) != tuple(p.shape):
                raise ValueError(
                    f"net_params[{slot!r}][{name!r}] has shape {tuple(shape)}, the "
                    f"network's is {tuple(p.shape)}"
                )
    with torch.no_grad():
        for slot, net in qp.nets.items():
            for name, p in net.named_parameters():
                p.copy_(torch.from_numpy(np.array(net_params[slot][name])))


def _integral_dims(shape: tuple[int, ...], *, is_tucker: bool) -> tuple[int, int]:
    """Infer (nip, num_dim) from a per-fold weight shape, following the
    reference's convention (``pic.py:461-475``): nip is the (square root of
    the) largest axis, and every axis must be an integer power of nip."""
    dims = [d for d in shape if d > 1]
    if not dims:
        return 1, 1
    nip = round(max(dims) ** (0.5 if is_tucker else 1.0))
    num_dim = 0
    for d in dims:
        e = round(math.log(d, nip)) if nip > 1 else 1
        if nip**e != d:
            raise ValueError(
                f"Weight shape {shape} is not a power of the quadrature size {nip}; "
                "pc2qpc supports square sum/CPT weights and Tucker cores"
            )
        num_dim += e
    return nip, max(num_dim, 1)


def _zeros(generator, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _bare_slot_parameter(slot: TorchTensorSlot, name: str) -> TorchParameter:
    """An identity parameter graph reading a fresh non-learnable slot."""
    node = TorchTensorSlot(
        name,
        slot.shape,
        dtype=slot.dtype,
        learnable=False,
        inits=[_zeros] * slot.num_folds,
        origins=list(slot.origins),
        num_folds=slot.num_folds,
    )
    return TorchParameter([node], {}, [node])


def _circuit_device(circuit: TorchCircuit, store: Store) -> torch.device:
    """The device of the circuit's plan buffers (the store's if it has none)."""
    for b in circuit.buffers():
        return b.device
    return next(iter(store.values())).device


def pc2qpc(
    circuit: TorchCircuit,
    store: Store,
    *,
    integration_method: str,
    seed: int = 0,
    generator: torch.Generator | None = None,
    net_dim: int = 128,
    bias: bool = True,
    input_sharing: str = "f",
    inner_sharing: str = "c",
    ff_dim: int | None = None,
    ff_sigma: float = 1.0,
) -> tuple[TorchCircuit, QuadratureParameterization]:
    """Convert a compiled PC into a quadrature PC (ref: ``pic.py:336-509``).

    Input layers (Categorical, Gaussian) get :class:`PICInputNet` generators
    producing their raw parameter slots (reparameterization graphs are kept
    intact). Sum/Tucker/CPT weights get :class:`PICInnerNet` generators
    whose outputs are quadrature-normalized; their reparameterization graphs
    are replaced by bare slots so the normalization is not distorted (the
    layers then take the plain-weight kernels). Mixing weights are frozen to
    uniform. The networks draw their initial values from ``generator``, or
    from a generator on the store's device seeded with ``seed``; they and
    the quadrature grids live on the store's device in its dtype, and the
    converted circuit on ``circuit``'s device. Returns the converted circuit
    and the trainable :class:`QuadratureParameterization`; ``circuit`` is
    left unchanged.
    """
    ref = next(iter(store.values()))
    dtype, device = ref.dtype, ref.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    net_kw = dict(net_dim=net_dim, ff_dim=ff_dim, ff_sigma=ff_sigma, bias=bias, dtype=dtype,
                  device=device, generator=generator)
    nets: dict[str, nn.Module] = {}
    grids: dict[str, tuple[tuple[torch.Tensor, ...], tuple[int, ...]]] = {}
    frozen: dict[str, torch.Tensor] = dict(store)
    new_layers = []

    def grid(nip: int) -> tuple[torch.Tensor, torch.Tensor]:
        z, w = zw_quadrature(integration_method, nip)
        return (torch.as_tensor(z, dtype=dtype, device=device),
                torch.as_tensor(w, dtype=dtype, device=device))

    def make_input_generator(slot: TorchTensorSlot, num_param: int, nip: int):
        z_quad, _ = grid(nip)
        nets[slot.slot] = PICInputNet(slot.num_folds, num_param, input_sharing, **net_kw)
        grids[slot.slot] = ((z_quad,), (slot.num_folds, *slot.shape))
        frozen.pop(slot.slot, None)

    for layer in circuit.layers:
        new_layer = layer
        if isinstance(layer, TorchCategoricalLayer):
            param = layer.probs if layer.logits is None else layer.logits
            (slot,) = param.tensor_slots()
            make_input_generator(slot, layer.num_categories, layer.num_output_units)
        elif isinstance(layer, TorchGaussianLayer):
            for param in (layer.mean, layer.stddev):
                (slot,) = param.tensor_slots()
                make_input_generator(slot, 1, layer.num_output_units)
        elif isinstance(layer, (TorchSumLayer, TorchTuckerLayer, TorchCPTLayer)):
            weight = layer.weight
            # an UNOPTIMIZED plan expresses a Tucker block as Kronecker ->
            # Sum with a (K, K^2) weight: same latent-variable semantics
            # (one output + two input quadrature dims), so detect it by
            # shape signature and normalize over both input dims
            is_tucker = isinstance(layer, TorchTuckerLayer) or (
                isinstance(layer, TorchSumLayer)
                and layer.num_output_units > 1
                and layer.num_input_units == layer.num_output_units**2
            )
            graph_nodes = list(weight.topological_ordering())
            simple = len(graph_nodes) <= 2
            has_mixing = any(isinstance(n, TorchMixingWeightParameter) for n in graph_nodes)
            has_softmax = any(isinstance(n, TorchSoftmaxParameter) for n in graph_nodes)
            for slot in weight.tensor_slots():
                if has_mixing:
                    # mixing weights freeze to uniform (ref: pic.py:453-458);
                    # with a softmax downstream any constant yields uniform
                    value = 0.0 if has_softmax else 1.0 / slot.shape[-1]
                    frozen[slot.slot] = torch.full(
                        (slot.num_folds, *slot.shape), value, dtype=dtype, device=device
                    )
                    continue
                nip, num_dim = _integral_dims(slot.shape, is_tucker=is_tucker)
                norm = tuple(range(1, num_dim + 1))[-(2 if is_tucker else 1):]
                net = PICInnerNet(num_dim, slot.num_folds, norm, inner_sharing, **net_kw)
                if not simple:
                    raise NotImplementedError(
                        "pc2qpc supports sum weights whose parameter graph is a "
                        "(reparameterized) tensor slot; found a composite graph"
                    )
                name = f"{slot.slot}_qpc"
                nets[name] = net
                grids[name] = (grid(nip), (slot.num_folds, *slot.shape))
                frozen.pop(slot.slot, None)
                # replace the reparameterized graph with the bare QPC slot, on
                # a copy with its own module dicts (a shallow copy of an
                # nn.Module shares them with the original)
                new_layer = copy.copy(layer)
                for attr in ("_parameters", "_buffers", "_modules"):
                    new_layer.__dict__[attr] = dict(layer.__dict__[attr])
                new_layer.weight = _bare_slot_parameter(slot, name)
                if hasattr(new_layer, "_logits_slot"):
                    new_layer._logits_slot = None
        elif isinstance(layer, (TorchHadamardLayer, TorchKroneckerLayer, TorchInputLayer)):
            pass
        else:
            raise NotImplementedError(
                f"pc2qpc does not handle layers of type {type(layer).__name__}"
            )
        new_layers.append(new_layer)

    qpc = TorchCircuit(
        circuit.scope,
        circuit.num_variables,
        new_layers,
        circuit._fold_inputs,
        circuit._fold_outputs,
        properties=circuit.properties,
        semiring=circuit.semiring,
        device=_circuit_device(circuit, store),
    )
    return qpc, QuadratureParameterization(nets, grids, frozen)
