"""Adam with the big-leaf update fused into one CUDA pass.

Counterpart of ``fused_adam`` (virus_nerf_tpu/ops/fused_adam.py:96), whose
TPU kernel is ``_adam_kernel`` (:37).  The CUDA kernel that replaces it is
``csrc/fused_adam.cu``; ``adam_update_plain_`` is the plain PyTorch version
(the formula of ``_adam_leaf_jnp``, :88).

Semantics are ``optax.adam(lr, eps=eps)``: b1/b2 defaults, bias correction,
eps outside the sqrt — the update rule of the reference's
``torch.optim.Adam`` (training/trainer.py:49-57).  Leaves of at least
``_MIN_KERNEL_SIZE`` elements go through :func:`adam_update_`; the TPU
package gated its kernel to 1-D leaves because of XLA's column-major layout
for narrow tables (fused_adam.py:135-139), a layout PyTorch does not have,
so here the 2-D hash table takes the kernel too.  Smaller leaves use the
plain version, where a launch would cost more than the update.

A bf16 leaf (the ``bfloat16`` compute mode's hash table) keeps float32
moments; the gradient is taken in float32, the update is computed in
float32 and ``p = bf16(float32(p) + d)``, which is what
``optax.apply_updates`` does to a bf16 leaf (fused_adam.py:133-142).
"""

from __future__ import annotations

import numpy as np
import torch

from virus_nerf_tpu_torch.ops import _build

# leaves below this size take the plain version (``min_pallas_size``,
# fused_adam.py:101)
_MIN_KERNEL_SIZE = 1 << 20


def adam_scalars(lr: float, b1: float, b2: float, count: int):
    """(lr, bc1, bc2) as float32 values, computed on the host in float32
    the way the JAX package computes them (fused_adam.py:123-131)."""
    t = np.float32(count)
    one = np.float32(1.0)
    bc1 = one - np.float32(b1) ** t
    bc2 = one - np.float32(b2) ** t
    return float(np.float32(lr)), float(bc1), float(bc2)


def adam_update_plain_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps):
    """Plain PyTorch version; updates p, mu and nu in place (a bf16 p as
    ``p = bf16(float32(p) + d)``)."""
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    d = -lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    mu.copy_(mu2)
    nu.copy_(nu2)
    if p.dtype == torch.float32:
        p.add_(d)
    else:
        p.copy_(p.float() + d)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _adam_update_cuda_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps):
    for t in (g, mu, nu):
        if t.device != p.device or t.shape != p.shape:
            raise ValueError("adam_update_: p, g, mu, nu must share device and shape")
    lib = _build.library()
    entry = "vn_fused_adam" if p.dtype == torch.float32 else "vn_fused_adam_bf16"
    err = getattr(lib, entry)(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.numel(),
        lr, bc1, bc2, _f32(b1), _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2),
        _f32(eps), torch.cuda.current_stream(p.device).cuda_stream,
    )
    _build.check(err, entry)
    adam_update_.launches += 1


def adam_update_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps):
    """One Adam step of one leaf, in place (p += d; mu, nu updated).

    A CUDA tensor launches ``csrc/fused_adam.cu`` (or raises); a CPU tensor
    takes :func:`adam_update_plain_`.  ``.launches`` counts kernel launches.
    p is float32 or bf16; g, mu and nu are float32.
    """
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adam_update_: want a float32 or bf16 p, got {p.dtype}")
    for t in (p, g, mu, nu):
        if not t.is_contiguous():
            raise ValueError("adam_update_: want contiguous tensors")
    for t in (g, mu, nu):
        if t.dtype != torch.float32:
            raise ValueError("adam_update_: want float32 g, mu and nu")
    if p.is_cuda:
        return _adam_update_cuda_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps)
    if p.device.type == "cpu":
        return adam_update_plain_(p, g, mu, nu, lr, bc1, bc2, b1, b2, eps)
    raise ValueError(f"adam_update_: unsupported device {p.device}")


adam_update_.launches = 0


class FusedAdam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps)`` with one shared step count, big
    leaves updated by the fused kernel (see module doc)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.count = 0

    def _moments(self, p):
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=torch.float32)
            st["nu"] = torch.zeros_like(p, dtype=torch.float32)
        return st["mu"], st["nu"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdam.step takes no closure")
        self.count += 1
        for group in self.param_groups:
            lr, bc1, bc2 = adam_scalars(
                group["lr"], group["b1"], group["b2"], self.count
            )
            args = (lr, bc1, bc2, group["b1"], group["b2"], group["eps"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                mu, nu = self._moments(p)
                g = p.grad.float()
                if p.numel() >= _MIN_KERNEL_SIZE:
                    adam_update_(p, g.contiguous(), mu, nu, *args)
                else:
                    adam_update_plain_(p, g, mu, nu, *args)

    def load_moments(self, named_params, count: int, mu: dict, nu: dict):
        """Set the step count and the moments from dicts keyed like
        ``named_params`` (see ``convert.adam_state_from_jax``)."""
        self.count = int(count)
        for name, p in named_params:
            m, v = self._moments(p)
            m.copy_(mu[name])
            v.copy_(nu[name])
