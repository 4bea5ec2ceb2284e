"""The port's training losses (mindtheedge_tpu_torch/losses) against the JAX
package's (mindtheedge_tpu/losses): values and input gradients from
``torch.autograd`` against ``jax.value_and_grad`` on the same numpy inputs.

``supervised_loss`` for all five methods over 4 scales; ``grad_loss`` for
each loss type, without and with normals, with no mask, a binary mask, a
continuous mask and an all-ones mask (the data-dependent branch of
``class_balanced_bce``), and with a prediction at half the GT resolution
(the bilinear resize).  At W = 96 the JAX side runs its W-packed Sobel
bank (``_sobel_bank_packed``), which the JAX tests hold equal to the plain
math.  Tolerance: rtol 1e-4 on values; on gradients rtol 1e-4 with an atol
of 1e-4 of the largest |gradient| of the tensor: an input's gradient sums
signed Sobel taps of its neighbours' terms, and where those cancel, fp32
rounding in a different summation order is a large share of the small
remainder: the port is within 4.2e-5 of the largest |gradient| of JAX's
packed form here, and JAX's own packed and plain forms differ by up to
3.9e-5 of it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.losses import grad_loss as jgrad
from mindtheedge_tpu.losses import supervised as jsup
from mindtheedge_tpu.utils import depth as jdepth
from mindtheedge_tpu_torch.losses import grad_loss as grad
from mindtheedge_tpu_torch.losses import supervised as sup
from mindtheedge_tpu_torch.losses.loss_base import ProgressiveScaling
from mindtheedge_tpu_torch.utils import depth

torch.set_num_threads(1)

B, H, W = 2, 64, 96
RTOL = 1e-4


def blocky_depth(rng, b, h, w):
    """Piecewise-constant depth in metres plus noise: sparse, strong Sobel
    responses.  Depths stay under 4 m so that ``sigmoid(mag - 4)`` stays
    below 1 in fp32 even at the zero-padded border, where the magnitude is
    about 4x the depth: at 1 the attention losses' ``log(1 - p)`` is -inf
    and their value NaN, in the JAX package as here."""
    d = np.full((b, h, w, 1), 3.0, np.float32)
    for i in range(b):
        for _ in range(4):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            d[i, y:y + rng.randint(8, h // 2), x:x + rng.randint(8, w // 2)] = \
                rng.uniform(1.0, 2.5)
    return d + rng.rand(b, h, w, 1).astype(np.float32) * 0.2


def assert_value_and_grad(got_value, got_grads, want_value, want_grads):
    np.testing.assert_allclose(float(got_value), float(want_value), rtol=RTOL)
    for g, w in zip(got_grads, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=1e-4 * float(np.abs(w).max()))


def torch_value_and_grad(fn, *arrays):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    value = fn(*xs)
    value.backward()
    return value.detach(), [x.grad for x in xs]


@pytest.mark.parametrize('method', ['sparse-l1', 'sparse-mse', 'sparse-berhu',
                                    'sparse-silog', 'sparse-abs_rel'])
def test_supervised_loss_matches_jax(method):
    rng = np.random.RandomState(0)
    inv = [rng.uniform(0.05, 1.5, (B, H >> s, W >> s, 1)).astype(np.float32)
           for s in range(4)]
    gt = blocky_depth(rng, B, H, W)
    gt[rng.rand(B, H, W, 1) < 0.9] = 0.0                  # sparse GT

    def jfn(*scales):
        return jsup.supervised_loss(list(scales), jdepth.depth2inv(gt),
                                    supervised_method=method, num_scales=4)

    want, want_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3))(*inv)
    got, got_grads = torch_value_and_grad(
        lambda *s: sup.supervised_loss(list(s), depth.depth2inv(torch.from_numpy(gt)),
                                       supervised_method=method, num_scales=4), *inv)
    assert_value_and_grad(got, got_grads, want, want_grads)


def test_silog_without_valid_pixels_has_zero_gradient():
    """GT with no valid pixel: silog is 0 and every gradient is 0, not NaN
    (the sqrt at 0 is masked out), as in JAX."""
    pred = [np.full((1, 8, 8, 1), 0.5, np.float32)]
    gt = np.zeros((1, 8, 8, 1), np.float32)
    got, (g,) = torch_value_and_grad(
        lambda p: sup.supervised_loss([p], torch.from_numpy(gt), 'sparse-silog', 1),
        *pred)
    want, (wg,) = jax.value_and_grad(
        lambda p: jsup.supervised_loss([p], gt, 'sparse-silog', 1), argnums=(0,))(*pred)
    assert float(got) == float(want) == 0.0
    assert torch.equal(g, torch.zeros_like(g)) and not np.asarray(wg).any()


def loss_inputs(seed, mask_kind, with_normals, out_scale=1):
    rng = np.random.RandomState(seed)
    out = blocky_depth(rng, B, H // out_scale, W // out_scale)
    edge = (rng.rand(B, H, W, 1) < 0.1).astype(np.float32)
    normals = ((rng.rand(B, H, W, 1) * 2 - 1) * np.pi).astype(np.float32) \
        if with_normals else None
    mask = {'none': None,
            'binary': (rng.rand(B, H, W, 1) < 0.7).astype(np.float32),
            'continuous': rng.rand(B, H, W, 1).astype(np.float32),
            'ones': np.ones((B, H, W, 1), np.float32)}[mask_kind]
    return out, edge, normals, mask


@pytest.mark.parametrize('mask_kind', ['none', 'binary', 'continuous', 'ones'])
@pytest.mark.parametrize('with_normals', [False, True], ids=['mag', 'normals'])
@pytest.mark.parametrize('loss_type', ['cross_entropy', 'attention_loss',
                                       'spatially_adaptive', 'cross_entropy_dice'])
def test_grad_loss_matches_jax(loss_type, with_normals, mask_kind):
    out, edge, normals, mask = loss_inputs(1, mask_kind, with_normals)
    kwargs = dict(is_grad=True, is_sigmoid=True, sigmoid_thresh=4.0,
                  edge_loss_type=loss_type, weight=10.0, pos_to_neg_weight=1.5)

    want, (want_grad,) = jax.value_and_grad(lambda o: jgrad.grad_loss(
        o, edge, gt_mask=mask, gt_normals=normals, **kwargs)[0], argnums=(0,))(out)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got, got_grads = torch_value_and_grad(lambda o: grad.grad_loss(
        o, t(edge), gt_mask=t(mask), gt_normals=t(normals), **kwargs)[0], out)
    assert_value_and_grad(got, got_grads, want, [want_grad])


@pytest.mark.parametrize('is_grad,is_sigmoid', [(True, True), (False, False)],
                         ids=['depth', 'probability'])
def test_grad_loss_resized_prediction_matches_jax(is_grad, is_sigmoid):
    """A prediction at half the GT resolution goes through the bilinear
    resize (align_corners False); with ``is_grad`` False it is a
    probability, as the DEE loss feeds it."""
    out, edge, normals, mask = loss_inputs(2, 'binary', True, out_scale=2)
    if not is_grad:
        out = (out - out.min()) / (out.max() - out.min()) * 0.98 + 0.01
    kwargs = dict(is_grad=is_grad, is_sigmoid=is_sigmoid, gt_mask=None)
    want, (want_grad,) = jax.value_and_grad(lambda o: jgrad.grad_loss(
        o, edge, gt_normals=normals, **kwargs)[0], argnums=(0,))(out)
    got, got_grads = torch_value_and_grad(lambda o: grad.grad_loss(
        o, torch.from_numpy(edge), gt_normals=torch.from_numpy(normals),
        **kwargs)[0], out)
    assert_value_and_grad(got, got_grads, want, [want_grad])


def test_grad_layer_buckets_are_half_open():
    """Each normal-angle bucket includes its lower bound and excludes its
    upper one: at exactly 3*pi/8 the vertical derivative is taken, just
    below it the right-left diagonal, as in JAX."""
    rng = np.random.RandomState(3)
    x = rng.rand(1, 16, 16, 1).astype(np.float32)
    lo = np.float32(3 * np.pi / 8)
    for angle in (lo, np.nextafter(lo, np.float32(0)), np.float32(-np.pi),
                  np.float32(7 * np.pi / 8)):
        n = np.full((1, 16, 16, 1), angle, np.float32)
        want = np.asarray(jgrad.grad_layer(jnp.asarray(x), jnp.asarray(n))[0])
        got = grad.grad_layer(torch.from_numpy(x), torch.from_numpy(n))[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('progressive', [0.0, 0.5])
def test_progressive_scaling_matches_jax(progressive):
    from mindtheedge_tpu.losses.loss_base import ProgressiveScaling as JaxScaling
    ours, theirs = ProgressiveScaling(progressive, 4), JaxScaling(progressive, 4)
    for progress in np.linspace(0.0, 1.0, 21):
        assert ours(progress) == theirs(progress)
