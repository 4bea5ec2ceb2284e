"""``arch.precision: bfloat16`` in the port against the JAX package's bf16.

The JAX package runs the depth network in bf16 by casting its fp32
parameters, running statistics and float inputs at each call and casting
the outputs back to fp32 (``mindtheedge_tpu/models/tasks.py:183-239``); the
port does the same (``models/tasks.BaseTask._depth_forward``).  Two bf16
networks that sum their conv taps in different orders round differently at
every layer, so the port's bf16 cannot match JAX's bf16 more closely than
either matches fp32.  Each check is therefore held to a band measured on the
same input from JAX's own gap: the port's bf16 against JAX's bf16 may differ
by at most ``BAND`` (2) times what JAX's bf16 differs from JAX's fp32, in
the median and in the worst case.

64x96, channels (16,)*6, batch 2, perturbed weights, LiDAR 95 % sparse (the
fixtures of tests/test_torch_tasks.py and tests/test_torch_train_step.py).
Measured on the CPU, JAX bf16 vs JAX fp32, then the port's bf16 vs JAX's
bf16 (relative errors, median / max):

* eval forward, ``inv_depths`` at scales 0-3: 3.3e-3 / 3.5e-2, 3.8e-3 /
  6.0e-2, 5.0e-3 / 7.1e-2, 5.7e-3 / 4.3e-2; then 4.5e-3 / 3.5e-2, 4.9e-3 /
  6.9e-2, 5.7e-3 / 5.6e-2, 6.5e-3 / 6.3e-2;
* one ``train_loss`` of ``SemiSupEdgeModel`` (dropout and flip off): the
  loss 2.4e-3, then 2.3e-3; the gradients, each tensor's worst error over
  its largest |gradient|, 0.27 / 0.79, then 0.27 / 0.98; the SAN's running
  statistics after the step 5.1e-4 / 88 (an element near 0), then 2.0e-4
  / 0.58.

The same file holds the masked pool's sentinel in bf16 (the JAX pool's
rounds to -inf, the port's is finite; the maps are equal) and the master
dtypes after a bf16 step.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.ops import sparse as jsparse
from mindtheedge_tpu_torch.models import tasks
from mindtheedge_tpu_torch.ops import sparse
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_blocks import nchw, nhwc
from tests.test_torch_tasks import inputs, write_jax_checkpoint
from tests.test_torch_train_step import (
    grads_by_name, make_batch, port_config, port_task, to_torch, train_config, vanishing,
    weights)

torch.set_num_threads(1)

BAND = 2.0


def rel_err(got, want):
    """Per-element |got - want| / |want| -> (median, max)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) / np.abs(want)
    return float(np.median(err)), float(err.max())


def within_band(name, port, jax_gap):
    """``port`` (median, max) within ``BAND`` times ``jax_gap``'s."""
    for what, p, j in zip(('median', 'max'), port, jax_gap):
        assert p <= BAND * j, f'{name} {what}: port vs JAX bf16 {p:.3e} > {BAND} x {j:.3e}'


def bf16_config(jcfg):
    cfg = jcfg.clone()
    cfg.arch.precision = 'bfloat16'
    return cfg


@pytest.fixture(scope='module')
def eval_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp('ckpt') / 'jax.ckpt'
    jtask, variables, jcfg = write_jax_checkpoint(path, 'SemiSupEdgeModel')
    from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint
    task = tasks.build_task(bf16_config(port_config(jcfg)), device='cpu',
                            ckpt=load_checkpoint(str(path)))
    return jtasks.build_task(bf16_config(jcfg)), jtask, variables, task


def test_bf16_eval_forward_matches_jax_within_band(eval_pair):
    jtask_bf16, jtask, variables, task = eval_pair
    rgb, lidar = inputs()
    batch = {'rgb': rgb, 'input_depth': lidar}
    run = lambda t: jax.jit(lambda v, b: t.infer(v, b))(variables, batch)['inv_depths']
    want16, want32 = run(jtask_bf16), run(jtask)
    got = task.infer({k: torch.from_numpy(v) for k, v in batch.items()})['inv_depths']
    for s in range(4):
        assert got[s].dtype == torch.float32 and want16[s].dtype == jnp.float32
        jax_gap, port = rel_err(want16[s], want32[s]), rel_err(got[s].numpy(), want16[s])
        print(f'scale {s}: JAX bf16 vs fp32 {jax_gap}, port vs JAX bf16 {port}')
        within_band(f'inv_depths[{s}]', port, jax_gap)


def jax_step(jcfg, weights, batch):
    """``train_loss`` and its gradients in the JAX package -> (loss,
    gradients as port names, running statistics as port names)."""
    jtask = jtasks.build_task(jcfg)

    def loss_fn(params):
        variables = {'depth': {'params': params, 'batch_stats': weights['batch_stats']}}
        loss, (_, _, stats) = jtask.train_loss(variables, batch, jax.random.PRNGKey(5))
        return loss, stats

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        weights['params'])
    return (float(loss), state_dict_from_jax(grads),
            {k: v for k, v in state_dict_from_jax(weights['params'], stats).items()
             if k.endswith(('running_mean', 'running_var'))})


def grad_errs(got, want, fp32):
    """Each gradient tensor's largest |got - want| over its largest
    |want| -> (median, max) over the tensors whose fp32 gradient ``fp32``
    does not vanish (a conv bias in front of a one-channel GroupNorm group
    gets an analytic zero, and in bf16 holds rounding noise far above
    ``vanishing``'s threshold)."""
    top = max(float(w.abs().max()) for w in fp32.values())
    errs = [float((got[n] - w).abs().max()) / float(w.abs().max())
            for n, w in want.items() if not vanishing(fp32[n], top)]
    return float(np.median(errs)), max(errs)


@pytest.fixture(scope='module')
def bf16_step(weights):
    """One bf16 ``train_loss`` + backward of the port, and the JAX
    package's in bf16 and in fp32, on the same weights and batch."""
    jcfg = train_config()
    batch = make_batch(3)
    task = port_task(bf16_config(jcfg), weights)
    loss, _ = task.train_loss(to_torch(batch), torch.Generator().manual_seed(5))
    loss.backward()
    stats = {k: v for k, v in task.depth_net.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    return {'port': (float(loss.detach()), grads_by_name(task.depth_net), stats),
            'jax16': jax_step(bf16_config(jcfg), weights, batch),
            'jax32': jax_step(jcfg, weights, batch)}


def test_bf16_train_step_loss_matches_jax_within_band(bf16_step):
    port, j16, j32 = bf16_step['port'][0], bf16_step['jax16'][0], bf16_step['jax32'][0]
    gap, err = abs(j16 - j32) / abs(j32), abs(port - j16) / abs(j16)
    print(f'loss: JAX bf16 {j16}, fp32 {j32}, port bf16 {port}; gap {gap:.3e}, port {err:.3e}')
    assert err <= BAND * gap


def test_bf16_train_step_gradients_match_jax_within_band(bf16_step):
    port, j16, j32 = (bf16_step[k][1] for k in ('port', 'jax16', 'jax32'))
    assert set(port) == set(j16)
    jax_gap, got = grad_errs(j16, j32, j32), grad_errs(port, j16, j32)
    print(f'gradients: JAX bf16 vs fp32 {jax_gap}, port vs JAX bf16 {got}')
    within_band('gradients', got, jax_gap)


def test_bf16_train_step_running_stats_match_jax_within_band(bf16_step):
    port, j16, j32 = (bf16_step[k][2] for k in ('port', 'jax16', 'jax32'))
    cat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in sorted(d)])
    jax_gap, got = rel_err(cat(j16), cat(j32)), rel_err(cat(port), cat(j16))
    print(f'running stats: JAX bf16 vs fp32 {jax_gap}, port vs JAX bf16 {got}')
    within_band('running statistics', got, jax_gap)


def test_bf16_step_keeps_fp32_masters(weights):
    """After a bf16 ``train_step`` the master parameters, their gradients,
    Adam's moments and the running statistics are fp32, and the step moved
    the parameters and the statistics."""
    jcfg = train_config()
    task = port_task(bf16_config(jcfg), weights)
    assert task.compute_dtype == torch.bfloat16
    state = create_train_state(port_config(bf16_config(jcfg)), task.depth_net)
    before = {k: v.clone() for k, v in task.depth_net.state_dict().items()}
    make_train_step(task)(state, to_torch(make_batch(4)), torch.Generator().manual_seed(0))
    after = task.depth_net.state_dict()
    for name, p in task.depth_net.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
    for k, v in after.items():
        assert v.dtype == (torch.int64 if k.endswith('num_batches_tracked') else torch.float32), k
    for s in state.optimizer.state.values():
        assert s['exp_avg'].dtype == s['exp_avg_sq'].dtype == torch.float32
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert any(k.endswith('running_var') for k in moved)
    assert any(k.endswith('conv_base.weight') for k in moved)


def test_bf16_pool_sentinel_gives_equal_maps():
    """The JAX pool's sentinel, float32's minimum cast to bf16, is -inf; the
    port's, bf16's own minimum, is finite.  The pooled maps and masks are
    equal all the same, on values of either sign."""
    assert jnp.asarray(jnp.finfo(jnp.float32).min, jnp.bfloat16) == -jnp.inf
    assert torch.isfinite(torch.tensor(torch.finfo(torch.bfloat16).min))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 17, 26, 8).astype(np.float32) * 4
    mask = (rng.rand(2, 17, 26, 1) < 0.2).astype(np.float32)
    xb, mb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x * mask, mask))
    want, want_mask = jsparse.masked_max_pool_3x3_s2(xb, mb)
    got, got_mask = sparse.masked_max_pool_3x3_s2(
        nchw(x * mask).bfloat16(), nchw(mask).bfloat16())
    assert got.dtype == got_mask.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(nhwc(got_mask.float()),
                                  np.asarray(want_mask.astype(jnp.float32)))
    assert 0 < float(got_mask.mean()) < 1 and bool((got < 0).any())
