"""``Model.loss``, its gradients and one train step against the JAX
package, at REDUCED in f32, for five archs: GQA (smollm-135m), MoE
(granite-moe), SSM (mamba2), MLA + MoE (deepseek-v2-lite) and the
encoder-decoder (whisper-base). One jitted reference call per arch (its
init from key(0), the loss and grads on step 0's batch of the token stream,
and one step of two microbatches) is shared by both tests; the port runs
on the same weights (``params_from_arrays``) and batch. Split from
test_torch_train.py so that the two files run on different workers.

Tolerances, measured with margin over what the two packages give:
- ``Model.loss``: rtol 1e-6 on the loss and the metrics; each gradient leaf
  within 1e-5 of its largest magnitude (measured: <= 2e-6);
- one train step: its metrics rtol 1e-6; each stepped weight within
  0.1 * lr of the reference's (Adam's first step moves a weight by about
  lr * g / (|g| + eps), so where a gradient is near eps the two packages'
  gradient rounding shows at a fraction of lr; measured <= 1.4e-5 at lr
  4.9e-4).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import build as jbuild  # noqa: E402
from repro.train import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.train import TrainState as JTrainState  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.models.model import params_from_arrays  # noqa: E402
from repro_torch.train import (OptimizerConfig, TrainState,  # noqa: E402
                               init_opt_state, make_train_step)
from test_torch_train import (MB, _batches, _cfgs, _flat,  # noqa: E402
                              _np, _oc)

ARCHS = ("smollm-135m", "granite-moe-1b-a400m", "mamba2-2.7b",
         "deepseek-v2-lite-16b", "whisper-base")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """One jitted reference call: init from key(0), the loss and its
    grads on step 0's batch, and one train step of MB microbatches."""
    jcfg, _ = _cfgs(arch)
    jmodel = jbuild(jcfg)
    jbatch, _ = _batches(jcfg)
    step = j_make_train_step(jmodel, _oc(JOptimizerConfig), MB)

    @jax.jit
    def run(key, batch):
        params = jmodel.init(key)[0]
        state = JTrainState(params, jopt.init_opt_state(params),
                            jax.random.key(1))
        (loss, metrics), grads = jax.value_and_grad(
            jmodel.loss, has_aux=True)(params, batch, None)
        new_state, step_metrics = step(state, batch)
        return (params, loss, metrics, grads,
                new_state._replace(rng=None, error=None), step_metrics)

    out = run(jax.random.key(0), jbatch)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def reference():
    return _reference


def _port(arch, jparams):
    _, cfg = _cfgs(arch)
    return (build(cfg, "cpu"),
            params_from_arrays(cfg, jparams, device="cpu"),
            _batches(cfg)[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, reference):
    jparams, jloss, jmetrics, jgrads, _, _ = reference(arch)
    model, params, batch = _port(arch, jparams)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-6, err_msg=k)
    want, got = _flat(jgrads), dict(zip(_flat(params), grads))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, reference):
    jparams, _, _, _, jstate, jmetrics = reference(arch)
    model, params, batch = _port(arch, jparams)
    state = TrainState(params, init_opt_state(params),
                       torch.Generator().manual_seed(1).get_state())
    new, metrics = make_train_step(model, _oc(OptimizerConfig), MB)(
        state, batch)
    assert metrics.keys() == jmetrics.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-6, err_msg=k)
    assert int(new.opt.step) == int(jstate.opt.step) == 1
    lr = float(jmetrics["lr"])
    for tree, jtree in ((new.params, jstate.params),
                        (new.opt.master, jstate.opt.master)):
        got, want = _flat(tree), _flat(jtree)
        for path in want:
            np.testing.assert_allclose(_np(got[path]), want[path], rtol=0,
                                       atol=0.1 * lr, err_msg=path)
