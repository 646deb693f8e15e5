"""AdamW with f32 master weights/moments (params may be bf16), global-norm
clipping, and WSD / cosine / constant schedules (``repro.train.optimizer``).

The reference's arithmetic, written out on tensors, not ``torch.optim.AdamW``
(which orders its bias correction and decay differently and decays 1-D
parameters): clip by the global norm; ``mu/bc1 / (sqrt(nu/bc2) + eps)``;
decoupled weight decay only where the master has ``ndim >= 2`` (the stacked
norm scales of the layer stack have 2 and are decayed, as in the
reference); the f32 master cast back to the parameter's dtype. The step
counter, the learning rate and the norm stay on the parameters' device, so
an update costs no host sync. Trees are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    # WSD (MiniCPM): warmup -> stable -> decay over the last `decay_frac`
    schedule: str = "cosine"            # cosine | wsd | constant
    decay_frac: float = 0.1
    min_lr_frac: float = 0.1


def schedule_fn(oc: OptimizerConfig) -> Callable:
    """step (an integer tensor) -> the learning rate, an f32 tensor."""
    def fn(step):
        step = step.float()
        warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
        if oc.schedule == "constant":
            frac = 1.0
        elif oc.schedule == "wsd":
            decay_steps = max(int(oc.total_steps * oc.decay_frac), 1)
            decay_start = oc.total_steps - decay_steps
            t = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
            frac = 1.0 - (1.0 - oc.min_lr_frac) * t
        else:  # cosine
            t = torch.clamp(step / max(oc.total_steps, 1), 0.0, 1.0)
            frac = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * t))
        return oc.learning_rate * warm * frac
    return fn


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: Any                    # f32 tree like params
    nu: Any                    # f32 tree like params
    master: Any                # f32 tree like params


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
        master=tree_map(lambda p: p.detach().float().clone(), params),
    )


def opt_state_axes(params_axes) -> OptState:
    """Logical axes tree for the optimizer state (mirrors params)."""
    return OptState(step=(), mu=params_axes, nu=params_axes,
                    master=params_axes)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(oc: OptimizerConfig, grads, params, state: OptState):
    """Returns (new_params, new_state, metrics). grads in any dtype."""
    gnorm = global_norm(grads)
    clip = torch.clamp(oc.grad_clip / gnorm.clamp_min(1e-12), max=1.0)
    step = state.step + 1
    lr = schedule_fn(oc)(step)
    b1, b2 = oc.beta1, oc.beta2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(g, mu, nu, master, p):
        g = g.float() * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mu_hat = mu / bc1
        nu_hat = nu / bc2
        delta = mu_hat / (torch.sqrt(nu_hat) + oc.eps)
        wd = oc.weight_decay if master.ndim >= 2 else 0.0
        master = master - lr * (delta + wd * master)
        return mu, nu, master, master.to(p.dtype)

    flat = tree_map(upd, grads, state.mu, state.nu, state.master, params)
    mu, nu, master, new_params = (tree_map(lambda t, i=i: t[i], flat)
                                  for i in range(4))
    new_state = OptState(step=step, mu=mu, nu=nu, master=master)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
