"""The port's photometric loss (mindtheedge_tpu_torch/losses/photometric.py)
against the JAX package's (mindtheedge_tpu/losses/photometric.py): values
and input gradients from ``torch.autograd`` against ``jax.value_and_grad``
on the same numpy inputs.

``ssim`` and ``calc_smoothness`` alone; ``multiview_photometric_loss`` at 4
scales with two context images, the gradients taken with respect to the 4
inverse-depth maps and the two 6-DoF pose vectors, for the min and mean
reductions, automasking on and off, ``clip_loss`` > 0, SSIM off, border
padding, and two kinds of exact ties in the minimum: two identical context
images under one pose (the two warped losses tie everywhere, and the
gradient splits evenly between the poses, as JAX's ``min`` splits it), and
a context image equal to the target (its automask term is the minimum).
Poses move pixels by up to a few pixels, so sample coordinates lie off the
integers, where the two samplers' derivatives agree
(tests/test_torch_geometry.py).  Tolerances: values rtol 1e-5; gradients
within 1e-4 of each tensor's largest |gradient|.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.geometry.pose import pose_vec2mat as jpose_vec2mat
from mindtheedge_tpu.losses import photometric as jphoto
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from mindtheedge_tpu_torch.losses import photometric as photo
from tests.test_torch_geometry import intrinsics

torch.set_num_threads(1)

B, H, W = 2, 32, 48
GRAD_REL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def grads_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GRAD_REL * float(np.abs(want).max()))


def test_ssim_matches_jax():
    rng = np.random.RandomState(0)
    x, y = (rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2))
    probe = rng.randn(B, H, W, 3).astype(np.float32)
    (want, got_map), g = jax.value_and_grad(
        lambda a: (jnp.sum(jphoto.ssim(a, y) * probe), jphoto.ssim(a, y)),
        has_aux=True)(x)
    xt = t(x).requires_grad_()
    out = photo.ssim(xt, t(y))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(got_map), rtol=1e-5, atol=1e-6)
    (out * t(probe)).sum().backward()
    grads_close(xt.grad, g)


def test_smoothness_matches_jax():
    rng = np.random.RandomState(1)
    inv = [rng.uniform(0.05, 0.5, (B, H >> s, W >> s, 1)).astype(np.float32) for s in range(4)]
    imgs = [rng.rand(B, H >> s, W >> s, 3).astype(np.float32) for s in range(4)]
    sx, sy = photo.calc_smoothness([t(d) for d in inv], [t(i) for i in imgs], 4)
    jx, jy = jphoto.calc_smoothness(inv, imgs, 4)
    for got, want in zip(sx + sy, list(jx) + list(jy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def loss_inputs(seed, tie=None):
    """Target, 2 contexts, 4 inverse-depth scales (depth 2-20 m), K and two
    pose vectors; ``tie`` 'duplicate' makes the contexts and poses equal,
    'target' makes context 0 the target."""
    rng = np.random.RandomState(seed)
    image = rng.rand(B, H, W, 3).astype(np.float32)
    context = [rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2)]
    inv = [rng.uniform(0.05, 0.5, (B, H >> s, W >> s, 1)).astype(np.float32)
           for s in range(4)]
    vecs = np.concatenate([rng.uniform(-0.3, 0.3, (B, 2, 3)),
                           rng.uniform(-0.03, 0.03, (B, 2, 3))], -1).astype(np.float32)
    if tie == 'duplicate':
        context[1] = context[0]
        vecs[:, 1] = vecs[:, 0]
    elif tie == 'target':
        context[0] = image
    return image, context, inv, intrinsics(B, H, W), vecs


CASES = {
    'min': {},
    'min-no-automask': dict(automask_loss=False),
    'mean': dict(photometric_reduce_op='mean'),
    'mean-no-automask': dict(photometric_reduce_op='mean', automask_loss=False),
    'clip': dict(clip_loss=0.5),
    'l1-only': dict(ssim_loss_weight=0.0),
    'border': dict(padding_mode='border'),
    'no-smoothness': dict(smooth_loss_weight=0.0),
}


@pytest.mark.parametrize('case,tie', [(c, None) for c in CASES] + [
    ('min', 'duplicate'), ('min', 'target'), ('min-no-automask', 'duplicate'),
    ('mean', 'duplicate')])
def test_photometric_loss_matches_jax(case, tie):
    kwargs = CASES[case]
    image, context, inv, K, vecs = loss_inputs(3, tie)

    def jloss(inv_depths, v):
        poses = [jpose_vec2mat(v[:, i]) for i in range(2)]
        return jphoto.multiview_photometric_loss(
            jnp.asarray(image), [jnp.asarray(c) for c in context], inv_depths,
            jnp.asarray(K), jnp.asarray(K), poses, **kwargs)

    (want, want_metrics), (g_inv, g_vec) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(inv, vecs)
    inv_t = [t(d).requires_grad_() for d in inv]
    vec_t = t(vecs).requires_grad_()
    poses = [pose_vec2mat(vec_t[:, i]) for i in range(2)]
    loss, metrics = photo.multiview_photometric_loss(
        t(image), [t(c) for c in context], inv_t, t(K), t(K), poses, **kwargs)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(want_metrics[k]), rtol=1e-5,
                                   err_msg=k)
    for s, (got, w) in enumerate(zip(inv_t, g_inv)):
        grads_close(got.grad, w)
    grads_close(vec_t.grad, g_vec)
    if tie == 'duplicate' and kwargs.get('photometric_reduce_op', 'min') == 'min':
        # the two poses tie everywhere: each takes half of the gradient
        torch.testing.assert_close(vec_t.grad[:, 0], vec_t.grad[:, 1])


def test_unknown_reduce_op_raises():
    image, context, inv, K, vecs = loss_inputs(4)
    poses = [pose_vec2mat(t(vecs)[:, i]) for i in range(2)]
    with pytest.raises(NotImplementedError, match='median'):
        photo.multiview_photometric_loss(
            t(image), [t(c) for c in context], [t(d) for d in inv], t(K), t(K), poses,
            photometric_reduce_op='median')
