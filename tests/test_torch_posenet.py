"""The port's pose and ResNet networks (mindtheedge_tpu_torch/models/posenet.py,
resnet.py) against the JAX package's, with the JAX weights carried over by
``utils/weights.pose_state_dict_from_jax`` / ``resnet_state_dict_from_jax``.

PoseNet, PoseResNet-18 and DepthResNet-18 at 64x96, batch 2, two context
images, perturbed biases, norm scales and running statistics: the eval
forwards, DepthResNet's training forward (batch statistics) and the running
statistics one training step leaves (flax momentum 0.9, biased variance).
Tolerances: outputs rtol 1e-4, atol 1e-6 (pose vectors, ~1e-3 in size, atol
1e-7); running statistics rtol 1e-4, atol 1e-6.
"""

import numpy as np
import jax
import pytest
import torch

from mindtheedge_tpu.models import posenet as jposenet
from mindtheedge_tpu.models import resnet as jresnet
from mindtheedge_tpu_torch.models import posenet, resnet
from mindtheedge_tpu_torch.utils.weights import (
    pose_state_dict_from_jax, resnet_state_dict_from_jax)
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

B, H, W = 2, 64, 96


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(B, H, W, 3).astype(np.float32) for _ in range(3)]


def jax_variables(module, *args, seed=0):
    variables = jax.jit(lambda k, *a: module.init(k, *a))(jax.random.PRNGKey(seed), *args)
    return perturb(jax.tree_util.tree_map(np.asarray, variables), np.random.RandomState(seed))


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize('name', ['PoseNet', 'PoseResNet'])
def test_pose_net_matches_jax(name):
    image, *context = inputs(1)
    if name == 'PoseNet':
        jnet, net = jposenet.PoseNet(), posenet.PoseNet()
    else:
        jnet, net = jresnet.PoseResNet(version='18'), resnet.PoseResNet('18')
    variables = jax_variables(jnet, image, context)
    want = jax.jit(lambda v, i, c: jnet.apply(v, i, c))(variables, image, context)
    net.load_state_dict(pose_state_dict_from_jax(
        variables['params'], variables.get('batch_stats')), strict=True)
    with torch.no_grad():
        got = net.eval()(t(image), [t(c) for c in context])
    assert tuple(got.shape) == (B, 2, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)


@pytest.fixture(scope='module')
def depth_resnet():
    image = inputs(2)[0]
    jnet = jresnet.DepthResNet(version='18')
    variables = jax_variables(jnet, image)
    net = resnet.DepthResNet('18')
    net.load_state_dict(resnet_state_dict_from_jax(
        variables['params'], variables['batch_stats']), strict=True)
    return jnet, variables, net, image


def test_depth_resnet_eval_matches_jax(depth_resnet):
    jnet, variables, net, image = depth_resnet
    want = jax.jit(lambda v, r: jnet.apply(v, r, train=False))(variables, image)
    with torch.no_grad():
        got = net.eval()(t(image))
    assert len(got['inv_depths']) == len(want['inv_depths']) == 1
    np.testing.assert_allclose(got['inv_depths'][0].numpy(), np.asarray(want['inv_depths'][0]),
                               rtol=1e-4, atol=1e-6)


def test_depth_resnet_train_step_batch_norm_matches_jax(depth_resnet):
    """Training mode: 4 inverse depths normalised by batch statistics, and
    the running statistics after the step: JAX's mutated ``batch_stats``."""
    jnet, variables, net, image = depth_resnet
    want, mutated = jax.jit(lambda v, r: jnet.apply(
        v, r, train=True, mutable=['batch_stats']))(variables, image)
    fresh = resnet.DepthResNet('18')
    fresh.load_state_dict(net.state_dict())
    with torch.no_grad():
        got = fresh.train()(t(image))
    assert len(got['inv_depths']) == 4
    for s, (g, w) in enumerate(zip(got['inv_depths'], want['inv_depths'])):
        assert tuple(g.shape) == (B, H >> s, W >> s, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=f'scale {s}')
    want_sd = resnet_state_dict_from_jax(variables['params'], mutated['batch_stats'])
    own = fresh.state_dict()
    n = 0
    for name, w in want_sd.items():
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(own[name], w, rtol=1e-4, atol=1e-6,
                                       msg=lambda m, name=name: f'{name}: {m}')
            assert not torch.equal(own[name], net.state_dict()[name]), name
            n += 1
    assert n == 2 * 20      # 20 batch norms in ResNet-18 with its downsamples


def test_resnet_key_names_are_the_reference():
    """torchvision's encoder names and monodepth2's decoder lists."""
    keys = set(resnet.DepthResNet('18').state_dict())
    assert {'encoder.encoder.conv1.weight', 'encoder.encoder.bn1.running_var',
            'encoder.encoder.layer2.0.downsample.0.weight',
            'encoder.encoder.layer4.1.bn2.weight', 'decoder.decoder.0.conv.conv.weight',
            'decoder.decoder.13.conv.bias'} <= keys
    pose_keys = set(resnet.PoseResNet('18').state_dict())
    assert {'encoder.encoder.conv1.weight', 'decoder.net.3.weight'} <= pose_keys
    assert resnet.PoseResNet('18').encoder.encoder.conv1.in_channels == 6
    assert {'conv1.0.weight', 'conv1.1.weight', 'conv7.1.bias',
            'pose_pred.weight'} <= set(posenet.PoseNet().state_dict())
    assert len(resnet.DepthResNet('50').encoder.encoder.layer3) == 6
