"""``model.depth_net.remat`` (True and ``'conv'``): activation recomputation
in the port's PackNet-SAN (``ops/remat.py``, ``models/packnet.py``).

* Against the step without it, on the CPU: with dropout 0.5 and
  ``flip_lr_prob`` 0.5 on, from one generator seed, one ``train_step``
  gives the same loss, the same gradients, the same running statistics and
  ``num_batches_tracked``, the same parameters after Adam and the same
  generator state, bit for bit, in fp32 and in bf16, for the paper's task
  and for a task whose loss reads the RGBD pass (so its backward reruns the
  SAN ladder and its batch norms).  The recompute would otherwise redraw
  the dropout masks from the explicit generator, which
  ``torch.utils.checkpoint`` does not restore, and update the running
  statistics a second time; in bf16 it would run on the fp32 masters,
  which ``functional_call`` has put back by then.
* Against the JAX package's ``nn.remat`` step (``remat`` True and
  ``'conv'``), one ``train_loss`` and its gradients at the tolerances of
  tests/test_torch_train_step.py (dropout and flip off).

64x96, channels (16,)*6, batch 2.
"""

import numpy as np
import jax
import pytest
import torch

from mindtheedge_tpu.models import tasks as jtasks
from tests.test_torch_train_cuda import remat_config, step_outcome, synthetic_batch
from tests.test_torch_train_step import (
    assert_grads_close, grads_by_name, make_batch, port_task, to_torch, train_config, weights)

torch.set_num_threads(1)


def assert_same_step(got, want):
    """Two ``step_outcome``s equal bit for bit."""
    assert got[0] == want[0], 'loss'
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), f'gradient {name}'
    for name, v in want[2].items():
        assert torch.equal(got[2][name], v), name
    assert torch.equal(got[3], want[3]), 'generator state'


@pytest.mark.parametrize('task', ['SemiSupEdgeModel', 'SemiSupEdgeCompletionModel'])
@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('remat', [True, 'conv'], ids=['remat', 'conv'])
def test_remat_step_equals_plain_step(remat, precision, task):
    batch = synthetic_batch(np.random.RandomState(0), 2, 64, 96)

    def outcome(mode):
        cfg = remat_config(mode, task=task)
        cfg.arch.precision = precision
        return step_outcome(cfg, batch, 'cpu')

    want = outcome(False)
    assert_same_step(outcome(remat), want)
    # the step did draw masks and update the SAN's statistics
    assert any(k.endswith('num_batches_tracked') and int(v) == 1 for k, v in want[2].items())


@pytest.mark.parametrize('remat', [True, 'conv'], ids=['remat', 'conv'])
def test_remat_train_loss_matches_jax(weights, remat):
    """``train_loss`` and every gradient against the JAX package's remat
    step: loss rtol 1e-4, gradients as tests/test_torch_train_step.py."""
    jcfg = train_config()
    jcfg.model.depth_net.remat = remat
    jtask = jtasks.build_task(jcfg)
    batch = make_batch(3)

    def loss_fn(params):
        variables = {'depth': {'params': params, 'batch_stats': weights['batch_stats']}}
        return jtask.train_loss(variables, batch, jax.random.PRNGKey(5))[0]

    want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(weights['params'])
    task = port_task(jcfg, weights)
    assert task.depth_net.remat == remat
    loss, _ = task.train_loss(to_torch(batch), torch.Generator().manual_seed(5))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    assert_grads_close(grads_by_name(task.depth_net), want_grads)
