"""Adam with every leaf of a parameter group updated by one CUDA launch.

Counterpart of ``fused_adam`` (virus_nerf_tpu/ops/fused_adam.py:96), whose
TPU kernel is ``_adam_kernel`` (:37).  The CUDA kernel that replaces it is
``csrc/fused_adam.cu``; ``adam_update_plain_`` is the plain PyTorch version
(the formula of ``_adam_leaf_jnp``, :88).

Semantics are ``optax.adam(lr, eps=eps)``: b1/b2 defaults, bias correction,
eps outside the sqrt — the update rule of the reference's
``torch.optim.Adam`` (training/trainer.py:49-57).  The step count is an
int32 tensor on the device and the kernel reads ``scal = [lr, 1 - b1^t,
1 - b2^t]`` from device memory, as the TPU kernel reads its ``scal_ref``
(fused_adam.py:37, :118-131): :func:`adam_scal` forms it on the device
each step, so eager steps and the replays of a CUDA graph that holds the
step (``Trainer.make_train_chunk``) take one route.  On the card
:class:`FusedAdam` updates all leaves of a group (the hash table and the
MLP weights) with one launch of the kernel through
:func:`adam_update_leaves_`, up to ``ADAM_MAX_LEAVES`` leaves a launch.
The TPU package gated its kernel to 1-D leaves of at least 2^20 elements
(XLA's column-major layout for narrow tables and the cost of a launch,
fused_adam.py:101, 135-139); neither applies here.  On the CPU every leaf
takes the plain version.

A bf16 leaf (the ``bfloat16`` compute mode's hash table) keeps float32
moments; the gradient is taken in float32, the update is computed in
float32 and ``p = bf16(float32(p) + d)``, which is what
``optax.apply_updates`` does to a bf16 leaf (fused_adam.py:133-142).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from virus_nerf_tpu_torch.ops import _build
from virus_nerf_tpu_torch.ops.launch_counts import register

# constants of csrc/fused_adam.cu (a card test compares them with the
# library's): leaves of one launch, elements of one CTA's chunk
ADAM_MAX_LEAVES = 16
ADAM_CHUNK = 2048


def adam_hyper(lr: float, b1: float, b2: float, device) -> torch.Tensor:
    """(3,) float32 [lr, b1, b2] on ``device``: the constants
    :func:`adam_scal` reads (made once, outside any graph capture)."""
    return torch.tensor([lr, b1, b2], dtype=torch.float32, device=device)


def adam_scal(count: torch.Tensor, hyper: torch.Tensor) -> torch.Tensor:
    """(3,) float32 ``[lr, 1 - b1**t, 1 - b2**t]`` at the step count t (an
    int32 0-dim tensor) on its device, with ``hyper`` from
    :func:`adam_hyper`: JAX's ``scal`` (fused_adam.py:123-131), formed
    from device memory alone, so a captured step replays with the count
    of each replay."""
    t = count.float()
    return torch.cat([hyper[:1], 1.0 - torch.pow(hyper[1:], t)])


def adam_update_plain_(p, g, mu, nu, scal, b1, b2, eps):
    """Plain PyTorch version; updates p, mu and nu in place (a bf16 p as
    ``p = bf16(float32(p) + d)``) with lr, bc1 and bc2 read from the (3,)
    float32 ``scal`` on the leaves' device."""
    lr, bc1, bc2 = scal.unbind()
    mu2 = b1 * mu + (1.0 - b1) * g
    nu2 = b2 * nu + (1.0 - b2) * g * g
    d = -lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
    mu.copy_(mu2)
    nu.copy_(nu2)
    if p.dtype == torch.float32:
        p.add_(d)
    else:
        p.copy_(p.float() + d)


def adam_update_leaves_plain_(leaves, scal, b1, b2, eps):
    """The plain version over a list of (p, g, mu, nu) leaves."""
    for p, g, mu, nu in leaves:
        adam_update_plain_(p, g, mu, nu, scal, b1, b2, eps)


def _f32(x: float) -> float:
    return float(np.float32(x))


def adam_leaf_plan(p_ptr: int, g_ptr: int, mu_ptr: int, nu_ptr: int, n: int,
                   bf16: bool):
    """How the kernel splits a leaf of n elements at these addresses:
    ``(head, body, vec)``.  With ``vec``, elements [0, head) and
    [head + body, n) are scalar (fewer than 4 each) and [head, head + body)
    go in 16-byte vectors (8-byte ones for a bf16 p), which needs the four
    arrays to share their phase in 4-element units; else the whole leaf is
    the body, in scalar chunks.  The body is cut into ``ADAM_CHUNK``-element
    chunks (at least one for a leaf that is not empty)."""
    phase = (g_ptr // 4) % 4
    p_phase = (p_ptr // 2 if bf16 else p_ptr // 4) % 4
    if p_phase == phase and (mu_ptr // 4) % 4 == phase and (nu_ptr // 4) % 4 == phase:
        head = min((4 - phase) % 4, n)
        return head, (n - head) // 4 * 4, True
    return 0, n, False


def _check_leaf(p, g, mu, nu):
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"adam_update_: want a float32 or bf16 p, got {p.dtype}")
    for t in (p, g, mu, nu):
        if not t.is_contiguous():
            raise ValueError("adam_update_: want contiguous tensors")
    for t in (g, mu, nu):
        if t.dtype != torch.float32:
            raise ValueError("adam_update_: want float32 g, mu and nu")
        if t.device != p.device or t.shape != p.shape:
            raise ValueError("adam_update_: p, g, mu, nu must share device and shape")


def _check_scal(scal, device):
    if (not torch.is_tensor(scal) or scal.dtype != torch.float32
            or tuple(scal.shape) != (3,) or not scal.is_contiguous()):
        raise ValueError("adam_update_: want scal as a contiguous (3,) "
                         "float32 tensor (adam_scal)")
    if scal.device != device:
        raise ValueError(f"adam_update_: scal on {scal.device}, leaves on {device}")


def _adam_launch_(leaves, scal, b1, b2, eps):
    """One launch of the kernel for at most ``ADAM_MAX_LEAVES`` leaves."""
    k = len(leaves)
    ptrs, plan, flags = [], [], []
    for p, g, mu, nu in leaves:
        addrs = [t.data_ptr() for t in (p, g, mu, nu)]
        bf16 = p.dtype == torch.bfloat16
        head, body, vec = adam_leaf_plan(*addrs, p.numel(), bf16)
        ptrs += addrs
        plan += [p.numel(), head, body]
        flags += [int(bf16), int(vec)]
    err = _build.library().vn_fused_adam(
        (ctypes.c_void_p * (4 * k))(*ptrs), (ctypes.c_longlong * (3 * k))(*plan),
        (ctypes.c_int * (2 * k))(*flags), k, scal.data_ptr(), _f32(b1),
        _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2), _f32(eps),
        torch.cuda.current_stream(leaves[0][0].device).cuda_stream,
    )
    _build.check(err, "vn_fused_adam")
    adam_update_leaves_.launches += 1


def adam_update_leaves_(leaves, scal, b1, b2, eps):
    """One Adam step of every (p, g, mu, nu) leaf, in place (p += d; mu, nu
    updated), all with the same scalars: lr, bc1 and bc2 from ``scal``, a
    (3,) float32 tensor on the leaves' device (:func:`adam_scal`), which
    the kernel reads from device memory.

    On the card one launch of ``csrc/fused_adam.cu`` updates them all (one
    more for every further ``ADAM_MAX_LEAVES``), or raises; on the CPU each
    leaf takes :func:`adam_update_plain_`.  ``.launches`` counts kernel
    launches.  p is float32 or bf16; g, mu and nu are float32; all leaves
    lie on one device.
    """
    leaves = [tuple(leaf) for leaf in leaves]
    for leaf in leaves:
        _check_leaf(*leaf)
    devices = {leaf[0].device for leaf in leaves}
    if len(devices) > 1:
        raise ValueError(f"adam_update_: leaves on several devices {devices}")
    if not leaves:
        return
    device = leaves[0][0].device
    _check_scal(scal, device)
    if device.type == "cuda":
        for i in range(0, len(leaves), ADAM_MAX_LEAVES):
            _adam_launch_(leaves[i:i + ADAM_MAX_LEAVES], scal, b1, b2, eps)
    elif device.type == "cpu":
        adam_update_leaves_plain_(leaves, scal, b1, b2, eps)
    else:
        raise ValueError(f"adam_update_: unsupported device {device}")


adam_update_leaves_.launches = 0
register(adam_update_leaves_)


def adam_update_(p, g, mu, nu, scal, b1, b2, eps):
    """One Adam step of one leaf, in place: :func:`adam_update_leaves_` on
    ``[(p, g, mu, nu)]`` (its ``.launches`` counts the launch)."""
    adam_update_leaves_([(p, g, mu, nu)], scal, b1, b2, eps)


class FusedAdam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps)`` with one shared step count
    ``count``, an int32 0-dim tensor on the parameters' device; on the card
    one kernel launch a step updates every leaf of a group (see module
    doc).  A step reads and writes device memory only, so a CUDA graph may
    hold it."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        device = self.param_groups[0]["params"][0].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self._hyper = [adam_hyper(g["lr"], g["b1"], g["b2"], device)
                       for g in self.param_groups]

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
        self.count.add_(1)
        for group, hyper in zip(self.param_groups, self._hyper):
            leaves = [(p, p.grad.float().contiguous(), *self._moments(p))
                      for p in group["params"] if p.grad is not None]
            adam_update_leaves_(leaves, adam_scal(self.count, hyper),
                                group["b1"], group["b2"], group["eps"])

    def load_moments(self, named_params, count: int, mu: dict, nu: dict):
        """Set the step count and the moments from dicts keyed like
        ``named_params`` (see ``convert.adam_state_from_jax``)."""
        self.count.fill_(int(count))
        for name, p in named_params:
            m, v = self._moments(p)
            m.copy_(mu[name])
            v.copy_(nu[name])
