"""The port's spatially sharded training step
(``parallel/mesh.make_spatial_train_step``) on the CPU against the JAX
package's plain step, as ``tests/test_spatial_sharding.py`` and
``tests/test_spatial_selfsup.py`` hold the JAX spatial step: ranks over
gloo spawned by ``tests/test_torch_dp_cuda.start_ranks`` with the JAX-free
jobs of ``tests/test_torch_spatial_cuda.py``; the JAX oracle
(``jax.value_and_grad`` of the task's ``train_loss``) runs here while they
work.

* ``SemiSupEdgeModel`` (channels (16,)*6, LiDAR, dropout 0, flip 0, the
  JAX weights carried over), global batch [2,128,64], on 4 ranks: H over
  4, and data x space 2 x 2 (each replica one frame, H over 2) against
  the mean of JAX's per-replica steps (``_train_step_parity``'s oracle,
  the reference's Horovod semantics).  The loss rtol 1e-5, every gradient
  rtol 1e-3 / atol 1e-4 and within 3e-4 of its tensor's largest (the
  port's training tolerance, ``tests/test_torch_train_step.py``),
  ``grad_norm`` rtol 1e-3, the SAN's running statistics rtol 1e-4; every
  rank holds the same gradients.  With ``remat`` True and ``'conv'`` the
  H-over-4 step's gradients equal the step's without (the recompute
  reruns the halo exchanges and reductions in one order on every rank).
* ``SemiSupModel`` at ``supervised_loss_weight`` 0.5 with ``PoseNet``
  (the photometric loss over two contexts beside the supervised term) and
  PackNet-SAN 1A, [2,64,96],
  on 2 ranks, H over 2: the loss rtol 1e-5; the parameters after an SGD
  step of lr 0.01 rtol 1e-4 / atol 1e-5 (``test_spatial_selfsup.py``'s),
  and the gradients of both networks as ``tests/test_torch_train_selfsup.py``
  holds them; the pose network's gradients are not zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.parallel import spatial as jspatial
from mindtheedge_tpu.training.train_step import create_train_state as jcreate_state
from mindtheedge_tpu_torch.utils.weights import pose_state_dict_from_jax, state_dict_from_jax
from tests.test_torch_blocks import perturb
from tests.test_torch_dp_cuda import start_ranks
from tests.test_torch_spatial_cuda import train_job
from tests.test_torch_train_cuda import synthetic_batch
from tests.test_torch_bf16 import BAND, bf16_config, grad_errs, rel_err, within_band
from tests.test_torch_dp import keep_gradient
from tests.test_torch_train_step import GRAD_RTOL, port_config, port_task, to_torch, train_config
from tests.test_torch_train_tasks import jax_variables, selfsup_batch, task_config

torch.set_num_threads(1)

B, H, W = 2, 128, 64
SGD_LR = 0.01


def save_batch(batch, path):
    """A numpy batch as ``train_job`` reads it (lists as ``key.i``)."""
    flat = {}
    for k, v in batch.items():
        if isinstance(v, list):
            flat.update({f'{k}.{i}': x for i, x in enumerate(v)})
        else:
            flat[k] = v
    np.savez(path, **flat)


def jax_grads(jcfg, variables, batch):
    """``jax.value_and_grad`` of the JAX task's ``train_loss`` -> (loss,
    metrics, {net: gradient tree}, new running statistics)."""
    jtask = jtasks.build_task(jcfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(params):
        v = {net: dict(variables[net], params=p) for net, p in params.items()}
        loss, (metrics, _, stats) = jtask.train_loss(v, jbatch, jax.random.PRNGKey(0))
        return loss, (metrics, stats)

    params = {net: v['params'] for net, v in variables.items()}
    (loss, (metrics, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return float(loss), {k: float(v) for k, v in metrics.items()}, tree(grads), tree(stats)


def grads_as_port(grads):
    """{net: JAX gradient tree} -> {'depth.<name>' / 'pose.<name>': tensor}."""
    out = {f'depth.{k}': v for k, v in state_dict_from_jax(grads['depth']).items()}
    if 'pose' in grads:
        out.update({f'pose.{k}': v for k, v in pose_state_dict_from_jax(grads['pose']).items()})
    return out


def assert_grads_match(got, want):
    """Each gradient rtol 1e-3 / atol 1e-4, and within ``GRAD_RTOL`` of its
    tensor's largest |gradient| (a tensor below 1e-5 of its network's
    largest vanishes analytically: within 1e-5 of that)."""
    assert set(got) == set(want)
    for net in ('depth', 'pose'):
        names = [k for k in want if k.startswith(net + '.')]
        if not names:
            continue
        top = max(float(want[k].abs().max()) for k in names)
        for k in names:
            torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4,
                                       msg=lambda m, k=k: f'{k}: {m}')
            scale = float(want[k].abs().max())
            tol = 1e-5 * top if scale < 1e-5 * top else GRAD_RTOL * scale
            assert float((got[k] - want[k]).abs().max()) <= tol, k


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both spawns' jobs, started first; meanwhile JAX's oracles."""
    tmp = tmp_path_factory.mktemp('spatial_train')
    jcfg = train_config()
    batch = {k: v.numpy() for k, v in synthetic_batch(np.random.RandomState(0), B, H, W).items()}
    jtask = jtasks.build_task(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init)(
        jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()}))
    depth = {'params': perturb(variables['depth']['params'], np.random.RandomState(1)),
             'batch_stats': variables['depth']['batch_stats']}
    port_config(jcfg).save_yaml(str(tmp / 'edge.yaml'))
    torch.save(state_dict_from_jax(depth['params'], depth['batch_stats']), tmp / 'edge.pt')
    save_batch(batch, tmp / 'edge.npz')
    edge = {'config': str(tmp / 'edge.yaml'), 'batch': str(tmp / 'edge.npz'),
            'depth_weights': str(tmp / 'edge.pt')}

    scfg = task_config('SemiSupModel', weight=0.5, pose_net='PoseNet')
    sbatch = selfsup_batch(3)
    svars = jax_variables(scfg, sbatch)
    port_config(scfg).save_yaml(str(tmp / 'selfsup.yaml'))
    torch.save(state_dict_from_jax(svars['depth']['params'], svars['depth']['batch_stats']),
               tmp / 'selfsup_depth.pt')
    torch.save(pose_state_dict_from_jax(svars['pose']['params']), tmp / 'selfsup_pose.pt')
    save_batch(sbatch, tmp / 'selfsup.npz')

    quad = start_ranks([(train_job, dict(edge, grid=(4,), remat=(True, 'conv'))),
                        (train_job, dict(edge, grid=(2,))),
                        (train_job, dict(edge, grid=(4,), precision='bfloat16'))],
                       4, str(tmp / 'quad'))
    pair = start_ranks([(train_job, {'config': str(tmp / 'selfsup.yaml'),
                                     'batch': str(tmp / 'selfsup.npz'), 'grid': (2,),
                                     'depth_weights': str(tmp / 'selfsup_depth.pt'),
                                     'pose_weights': str(tmp / 'selfsup_pose.pt')})],
                       2, str(tmp / 'pair'))
    try:
        full = jax_grads(jcfg, {'depth': depth}, batch)
        halves = [jax_grads(jcfg, {'depth': depth}, {k: v[i:i + 1] for k, v in batch.items()})
                  for i in range(B)]
        selfsup = jax_grads(scfg, svars, sbatch)
        jax16 = jax_space_step(bf16_config(jcfg), depth, batch)
        plain16 = port_bf16_step(jcfg, depth, batch)
        quad.join()
        pair.join()
    except BaseException:
        quad.join()
        pair.join()
        raise
    return {'quad': quad, 'pair': pair, 'full': full, 'halves': halves, 'selfsup': selfsup,
            'depth': depth, 'svars': svars, 'jax16': jax16, 'plain16': plain16}


def jax_space_step(jcfg, depth, batch):
    """The JAX package's ``make_spatial_train_step``, H over 4 of the
    virtual CPU devices -> (loss, gradients as port names, running
    statistics as port names); the gradients are read from an optax
    transformation that keeps them as its state."""
    jtask, opt = jtasks.build_task(jcfg), keep_gradient()
    state = jcreate_state(jtask, opt, jax.random.PRNGKey(0), batch, variables={'depth': depth})
    step = jspatial.make_spatial_train_step(jtask, opt, Mesh(np.asarray(jax.devices()[:4]),
                                                             ('space',)))
    new_state, metrics = step(state, batch, jax.random.PRNGKey(0))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return (float(metrics['loss']), grads_as_port({'depth': tree(new_state.opt_state['depth'])}),
            stats_of(depth['params'], tree(new_state.batch_stats['depth'])))


def port_bf16_step(jcfg, depth, batch):
    """The port's unsharded bf16 ``train_loss`` and backward -> (loss,
    gradients as port names, running statistics)."""
    task = port_task(bf16_config(jcfg), depth)
    loss, _ = task.train_loss(to_torch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    return (float(loss.detach()),
            {f'depth.{n}': p.grad for n, p in task.depth_net.named_parameters()},
            {k: v for k, v in task.depth_net.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))})


def stats_of(params, stats):
    """The running statistics of a JAX ``batch_stats`` tree, as port names."""
    return {k: v for k, v in state_dict_from_jax(params, stats).items()
            if k.endswith(('running_mean', 'running_var'))}


def mean_outcome(outcomes):
    """The mean loss, metrics and gradients of per-replica JAX outcomes."""
    n = len(outcomes)
    grads = [grads_as_port(o[2]) for o in outcomes]
    return (sum(o[0] for o in outcomes) / n,
            {k: sum(o[1][k] for o in outcomes) / n for k in outcomes[0][1]},
            {k: sum(g[k] for g in grads) / n for k in grads[0]},
            [o[3] for o in outcomes])


def check_step(results, loss, metrics, grads):
    first = results[0]
    for res in results[1:]:
        for k, v in first['grads'].items():
            assert torch.equal(res['grads'][k], v), k
    np.testing.assert_allclose(first['metrics']['loss'], loss, rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(first['metrics'][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert_grads_match(first['grads'], grads)
    norm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())))
    np.testing.assert_allclose(first['metrics']['grad_norm'], norm, rtol=1e-3)


def check_stats(state, params, stats):
    want = state_dict_from_jax(params, stats)
    keys = [k for k in want if k.endswith(('running_mean', 'running_var'))]
    assert keys
    for k in keys:
        torch.testing.assert_close(state[k], want[k], rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: f'{k}: {m}')


def test_space_step_matches_jax(runs):
    loss, metrics, grads, stats = runs['full']
    results = runs['quad'].result(0)
    check_step(results, loss, metrics, grads_as_port(grads))
    check_stats(results[0]['state'], runs['depth']['params'], stats)


def test_data_by_space_step_matches_jax_per_replica_mean(runs):
    loss, metrics, grads, stats = mean_outcome(runs['halves'])
    results = runs['quad'].result(1)
    check_step(results, loss, metrics, grads)
    mean_stats = jax.tree_util.tree_map(lambda *s: sum(s) / len(s), *stats)
    check_stats(results[0]['state'], runs['depth']['params'], mean_stats)


@pytest.mark.parametrize('remat', [True, 'conv'])
def test_remat_with_space_equals_space(runs, remat):
    for res in runs['quad'].result(0):
        metrics, grads = res['remat'][remat]
        assert metrics == res['metrics']
        for k, v in res['grads'].items():
            torch.testing.assert_close(grads[k], v, rtol=0, atol=0, msg=k)


def test_selfsup_space_step_matches_jax(runs):
    loss, metrics, grads, _ = runs['selfsup']
    want = grads_as_port(grads)
    results = runs['pair'].result(0)
    check_step(results, loss, metrics, want)
    assert float(results[0]['grads']['pose.pose_pred.weight'].abs().max()) > 0
    svars = runs['svars']
    params = {f'depth.{k}': v for k, v in state_dict_from_jax(svars['depth']['params']).items()}
    params.update({f'pose.{k}': v for k, v in
                   pose_state_dict_from_jax(svars['pose']['params']).items()})
    for k, g in results[0]['grads'].items():
        torch.testing.assert_close(params[k] - SGD_LR * g, params[k] - SGD_LR * want[k],
                                   rtol=1e-4, atol=1e-5, msg=lambda m, k=k: f'{k}: {m}')


def test_space_bf16_step_within_band(runs):
    """bf16 through the spatial seams in training: the H-over-4 step at
    ``arch.precision: bfloat16`` against the JAX package's sharded bf16
    step and against the port's unsharded bf16 step, each within ``BAND``
    times JAX's sharded bf16 gap to its fp32 step (tests/test_torch_bf16.py's
    band): the loss, and the gradients and the running statistics by each
    tensor's worst error over its largest |value|, median and max over the
    tensors (an element's own relative error is unbounded where a running
    mean lies near 0)."""
    results = runs['quad'].result(2)
    port = results[0]
    for res in results[1:]:
        for k, v in port['grads'].items():
            assert torch.equal(res['grads'][k], v), k
    loss32, _, grads32, stats32 = runs['full']
    grads32 = grads_as_port(grads32)
    stats32 = stats_of(runs['depth']['params'], stats32)
    stats = {k: v for k, v in port['state'].items() if k in stats32}
    loss16, grads16, jstats16 = runs['jax16']
    gap = (abs(loss16 - loss32) / abs(loss32), grad_errs(grads16, grads32, grads32),
           grad_errs(jstats16, stats32, stats32))
    print(f'JAX sharded bf16 vs fp32: loss {gap[0]:.3e}, gradients {gap[1]}, '
          f'statistics {gap[2]}')
    for what, (loss, grads, jstats) in (('JAX sharded bf16', runs['jax16']),
                                         ('the port\'s unsharded bf16', runs['plain16'])):
        got = (abs(port['metrics']['loss'] - loss) / abs(loss),
               grad_errs(port['grads'], grads, grads32), grad_errs(stats, jstats, stats32))
        print(f'port sharded bf16 vs {what}: loss {got[0]:.3e}, gradients {got[1]}, '
              f'statistics {got[2]}')
        assert got[0] <= BAND * gap[0], (what, got[0], gap[0])
        within_band(f'gradients against {what}', got[1], gap[1])
        within_band(f'statistics against {what}', got[2], gap[2])
