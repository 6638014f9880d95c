"""Low-memory Adam: moments stored in bfloat16 with stochastic rounding.

The counterpart of ``cirkit_tpu/parallel/optimizers.py:52-154``. The
flagship circuit's Adam update streams about 28 bytes of parameter,
gradient and moments per parameter per step; storing the two moments in
bfloat16 cuts that to about 20 bytes and halves the optimizer state, while
every update is computed in float32.

Plain round-to-nearest bf16 moments would stall the second-moment EMA:
``(1 - b2) = 1e-3`` relative increments fall below bf16's ~2^-8 relative
resolution, so ``nu`` stops moving once it is warm. Both moments are
instead written back with stochastic rounding, which is unbiased: add 16
random bits below the bf16 mantissa cut of the float32 bit pattern and
truncate. One 16-bit draw per element serves both moments; ``nu`` takes a
multiplicative-hash scramble of it (a bijection on 16-bit values, so both
streams stay uniform and each cast unbiased).

The draws come from a ``torch.Generator`` seeded from ``(seed, leaf,
step)``, so the state needs no generator and a resumed run replays them.
Philox bits are not the TPU's rbg bits: the rounding matches the JAX
package's in distribution, not bit for bit.
"""

from __future__ import annotations

import hashlib
from collections.abc import Callable, Iterable

import torch

_LOW16 = 0xFFFF
_HIGH16 = -0x10000  # 0xFFFF0000 as an int32 mask


def _sr_to_bf16(x: torch.Tensor, rnd16: torch.Tensor) -> torch.Tensor:
    """Stochastically round a float32 tensor to bfloat16 with the given
    random values (int32, only the low 16 bits are used).

    Adds the random bits below the bf16 mantissa cut of the f32 bit pattern
    and truncates: a value rounds up with probability equal to the discarded
    fraction, so the cast is unbiased. A carry into the exponent when
    rounding up crosses a binade is the right result, and the sign-magnitude
    layout makes the same add valid for negative values (the rounding is in
    magnitude). The int32 add wraps as the uint32 add would."""
    bits = x.float().view(torch.int32)
    bits = (bits + (rnd16 & _LOW16)) & _HIGH16
    return bits.view(torch.float32).to(torch.bfloat16)


def _scramble16(rnd16: torch.Tensor) -> torch.Tensor:
    """An odd-multiplier hash: a bijection on 16-bit values, so a uniform
    input stays uniform; the second moment's rounding stream."""
    return ((rnd16.long() * 0x9E37) & _LOW16).int()  # int64: no signed overflow


def _bits16(seed: int, leaf: int, step: int, like: torch.Tensor) -> torch.Tensor:
    """One 16-bit draw per element of ``like`` (as int32), from a generator
    seeded from ``(seed, leaf, step)`` on ``like``'s device."""
    digest = hashlib.blake2b(f"{seed},{leaf},{step}".encode(), digest_size=8).digest()
    gen = torch.Generator(device=like.device).manual_seed(int.from_bytes(digest, "little"))
    return torch.randint(0, 1 << 16, like.shape, generator=gen, device=like.device,
                         dtype=torch.int32)


class AdamLowMem(torch.optim.Optimizer):
    """Adam with moments stored in ``state_dtype`` via stochastic rounding.

    Math is float32: moments are widened on read, the update is the
    bias-corrected Adam step of ``torch.optim.Adam`` (eps outside the square
    root of the bias-corrected second moment), and the fresh moments are
    stochastically rounded on write. With ``state_dtype=torch.float32`` the
    rounding is skipped and a step equals ``torch.optim.Adam``'s.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: float = 1e-3,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        *,
        state_dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
    ):
        if state_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"state_dtype must be bfloat16 or float32, got {state_dtype}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        self.state_dtype = state_dtype
        self.seed = seed

    @torch.no_grad()
    def step(self, closure: Callable[[], torch.Tensor] | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        leaf = 0
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            b1, b2 = group["betas"]
            for p in group["params"]:
                leaf += 1
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.int64)
                    state["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
                state["step"] += 1
                t = int(state["step"])
                g = p.grad.float()
                mu = state["exp_avg"].float().lerp_(g, 1 - b1)
                nu = state["exp_avg_sq"].float().mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1 = 1 - b1**t
                bc2_sqrt = (1 - b2**t) ** 0.5
                denom = (nu.sqrt() / bc2_sqrt).add_(eps)
                p.addcdiv_(mu.to(p.dtype), denom.to(p.dtype), value=-lr / bc1)
                if self.state_dtype == torch.bfloat16:
                    rnd = _bits16(self.seed, leaf - 1, t, g)
                    state["exp_avg"] = _sr_to_bf16(mu, rnd)
                    state["exp_avg_sq"] = _sr_to_bf16(nu, _scramble16(rnd))
                else:
                    state["exp_avg"] = mu
                    state["exp_avg_sq"] = nu
        return loss

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state, keeping the moments in ``state_dtype`` (the base
        class casts them to each parameter's dtype)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in state:
                    state[key] = state[key].to(self.state_dtype)


def adam_lowmem(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    *,
    state_dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> Callable[[Iterable[torch.Tensor]], AdamLowMem]:
    """The optimizer factory (parameters -> :class:`AdamLowMem`) to pass to
    ``fit``, with the JAX package's signature."""
    return lambda params: AdamLowMem(
        params, lr=learning_rate, betas=(b1, b2), eps=eps, state_dtype=state_dtype, seed=seed
    )
