"""The training step: gradient accumulation over microbatches, f32 gradient
sums, the AdamW update and optional gradient compression
(``repro.train.train_step``).

``make_train_step(model, oc, microbatches)`` returns
  train_step(state, batch) -> (state, metrics)
with state = TrainState(params, opt, rng, error). The global batch arrives
whole (e.g. (16, 2049) tokens) and is split into ``microbatches`` on its
leading axis inside the step, so the launcher's data path does not depend on
the accumulation factor.

Each microbatch's gradients come from ``torch.autograd.grad`` in the
parameters' type and are added into f32 sums, in microbatch order, as the
reference's unrolled scan adds them (``.grad`` accumulation would sum bf16
gradients in bf16). Nothing is traced: the step runs eagerly.

Randomness is a draw and an apply: ``rng`` is the state of a host
``torch.Generator`` (no device sync to draw from it). A step draws one seed
from it, the reference's ``split``, and every microbatch's loss gets a
generator on the device seeded with it (the reference hands every
microbatch the same ``step_rng``). The models draw from it only for the
MoE's router jitter, which every config leaves off.

``train_state_axes`` is the state's logical-axes tree, which
``runtime.sharding.tree_shardings`` maps onto placements over a mesh (the
reference's ``init_train_state`` returns it beside the state).
``make_train_step(..., param_shardings=)`` takes the params' placements: on
``DTensor`` params each microbatch's gradients are redistributed onto
them, as the reference pins its accumulator; on plain tensors it does
nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.runtime.device import make_generator
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state,
                                         opt_state_axes)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    rng: torch.Tensor          # a host torch.Generator's state (uint8)
    error: Any = None          # gradient-compression error feedback


def init_train_state(model, generator: torch.Generator,
                     use_compression=False, rng_seed: int = 0) -> TrainState:
    """The parameters drawn from ``generator`` (on the model's device), zero
    moments, the f32 master copy, and the step generator's state seeded
    with ``rng_seed``."""
    params, _ = model.init(generator)
    return TrainState(
        params=params,
        opt=init_opt_state(params),
        rng=torch.Generator().manual_seed(rng_seed).get_state(),
        error=(compression.init_error_buffers(params) if use_compression
               else None),
    )


def abstract_train_state(model, use_compression=False) -> TrainState:
    """``init_train_state``'s tree with every tensor on the meta device (no
    allocation): what ``checkpoint.restore`` reads the structure from."""
    params, _ = model.abstract_init()
    meta = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                 device="meta")
    return TrainState(
        params=params,
        opt=OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                     mu=tree_map(meta, params), nu=tree_map(meta, params),
                     master=tree_map(meta, params)),
        rng=torch.Generator().get_state(),
        error=tree_map(meta, params) if use_compression else None,
    )


def train_state_axes(model, use_compression=False) -> TrainState:
    """The logical axes of ``init_train_state``'s tree (mirrors the state:
    the params' axes for params, moments, masters and error buffers; ()
    for the step and the generator state), from the model's abstract
    init."""
    _, axes = model.abstract_init()
    return TrainState(params=axes, opt=opt_state_axes(axes), rng=(),
                      error=axes if use_compression else None)


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    def sp(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def _draw_step_seed(rng: torch.Tensor):
    """(the next rng state, this step's seed): one 63-bit draw on the
    host."""
    gen = torch.Generator()
    gen.set_state(rng.cpu())
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return gen.get_state(), seed


def _placed(grads, placements):
    """Each ``DTensor`` gradient redistributed onto its param's placements
    (None: left as it is); plain tensors unchanged."""
    from torch.distributed.tensor import DTensor
    return [g.redistribute(g.device_mesh, pl)
            if pl is not None and isinstance(g, DTensor) else g
            for g, pl in zip(grads, placements)]


def make_train_step(model, oc: OptimizerConfig, microbatches: int = 1,
                    use_compression: bool = False,
                    param_shardings: Any = None) -> Callable:
    """``param_shardings``: the params' placements tree
    (``runtime.sharding.tree_shardings``), or None."""
    placements = (None if param_shardings is None
                  else tree_leaves(param_shardings))

    def train_step(state: TrainState, batch):
        rng, step_seed = _draw_step_seed(state.rng)
        mb = _split_microbatches(batch, microbatches)
        leaves = tree_leaves(state.params)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        device = leaves[0].device
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        msum: Optional[dict] = None
        for i in range(microbatches):
            micro = {k: v[i] for k, v in mb.items()}
            live = [p.detach().requires_grad_() for p in leaves]
            params = _rebuild(state.params, live)
            loss, metrics = model.loss(params, micro,
                                       make_generator(step_seed, device))
            grads = torch.autograd.grad(loss, live)
            if placements is not None:
                grads = _placed(grads, placements)
            torch._foreach_add_(gsum, [g.float() for g in grads])
            lsum = lsum + loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            msum = metrics if msum is None else {
                k: msum[k] + metrics[k] for k in msum}
            del loss, grads, live, params
        torch._foreach_div_(gsum, microbatches)
        grads = _rebuild(state.params, gsum)

        error = state.error
        if use_compression:
            grads, error = compression.compress_grads_ef(grads, error)

        new_params, new_opt, opt_metrics = adamw_update(
            oc, grads, state.params, state.opt)
        metrics = {"loss": lsum / microbatches,
                   **{k: v / microbatches for k, v in msum.items()},
                   **opt_metrics}
        return TrainState(new_params, new_opt, rng, error), metrics

    return train_step


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
