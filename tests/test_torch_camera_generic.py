"""The port's generic (ray-surface) camera
(mindtheedge_tpu_torch/geometry/camera_generic.py) against the JAX
package's (mindtheedge_tpu/geometry/camera_generic.py).

``_patch_coords`` must equal JAX's integers exactly, borders and patches
larger than half the image included.  The other functions run on a
pinhole camera's unit rays (``pinhole_rays``): neighbouring pixels' rays
differ by ~1/f rad, so the logits of a patch are separated by far more
than fp32 rounding (~6e-8) over the temperature (1e-4 at progress 0,
9.5e-5 at 0.5).  Depths and images are smooth texture, the pose moves a
point by a few pixels, 32x48, batch 2, patch radius 4 (the task's rule
``min(20, max(2, h // 8))`` at this size).

Tolerances.  The soft argmax is nearly hard: a point that lands between
two rays' directions has two near-equal logits, where a rounding of 6e-8
moves the weight between them by ~6e-8 / T, so the coordinate moves by up
to ~3e-4 px (measured 2.4e-4 px, 2.8e-5 in grid units); coordinates are
held within 1e-4 in grid units and warped images within 1e-4.  The
gradients carry the same 1/T: over 6 seeds the port's fp32 gradients lay
up to 2.5e-4 of their tensor's largest from the fp64 ones, and JAX's up to
5.6e-4 (measured), so each gradient is held within 1e-3 of its tensor's
largest, both against JAX and against the port in fp64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.geometry import camera_generic as jcg
from mindtheedge_tpu_torch.geometry import camera_generic as tcg
from tests.test_torch_train_cuda import smooth_images
from tests.test_torch_variants_cuda import pinhole_rays

torch.set_num_threads(1)

B, H, W = 2, 32, 48
RADIUS = 4
COORD_ATOL = 1e-4
IMAGE_ATOL = 1e-4
GRAD_BOUND = 1e-3


def scene(seed=0):
    """(depth [B,H,W,1] 5-20 m, image [B,H,W,3], ray surface, pose
    [B,4,4] with a translation of up to 0.3 m, loss weights)."""
    rng = np.random.RandomState(seed)
    depth, image = smooth_images(rng, 2, B, H, W)
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, :3, 3] = rng.uniform(-0.3, 0.3, (B, 3))
    weights = rng.randn(B, H, W, 3).astype(np.float32)
    return (5 + 15 * depth[..., :1]).astype(np.float32), image, pinhole_rays(B, H, W), \
        pose, weights


@pytest.mark.parametrize('h,w,radius', [(8, 12, 2), (24, 40, 5), (16, 24, 4), (5, 9, 2),
                                        (9, 9, 4), (48, 80, 20)])
def test_patch_coords_exact(h, w, radius):
    want = jcg._patch_coords(h, w, radius)
    got = tcg._patch_coords(h, w, radius).numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('frame', ['c', 'w'])
def test_reconstruct_generic_matches_jax(frame):
    depth, _, rays, pose, _ = scene()
    want = jcg.reconstruct_generic(jnp.asarray(depth), jnp.asarray(rays),
                                   jnp.asarray(pose), frame=frame)
    got = tcg.reconstruct_generic(torch.from_numpy(depth), torch.from_numpy(rays),
                                  torch.from_numpy(pose), frame=frame)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def warped_points(depth, rays, pose):
    """The scene's points in the reference camera, numpy."""
    X = rays * depth
    return (np.einsum('bij,bhwj->bhwi', pose[:, :3, :3], X)
            + pose[:, None, None, :3, 3]).astype(np.float32)


@pytest.mark.parametrize('progress', [0.0, 0.5])
def test_project_generic_matches_jax(progress):
    depth, _, rays, pose, _ = scene()
    X = warped_points(depth, rays, pose)
    want = jcg.project_generic(jnp.asarray(X), jnp.asarray(rays), progress,
                               patch_radius=RADIUS)
    got = tcg.project_generic(torch.from_numpy(X), torch.from_numpy(rays), progress,
                              patch_radius=RADIUS)
    assert tuple(got.shape) == want.shape == (B, H, W, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=COORD_ATOL)
    # on its own ray surface each point comes back near its own pixel (the
    # neighbours' weights, e^-6 at this focal length, pull it by < 0.25 px)
    own = tcg.project_generic(torch.from_numpy(rays * depth), torch.from_numpy(rays),
                              progress, patch_radius=RADIUS, downsample=False).numpy()
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    assert np.abs((own[..., 0] + 1) / 2 * (W - 1) - xs).max() < 0.25
    assert np.abs((own[..., 1] + 1) / 2 * (H - 1) - ys).max() < 0.25


def _warp_loss(lib, depth, rays, ref_rays, image, pose, weights, progress, padding):
    """sum(weights * view_synthesis_generic(...)) -> (loss, warped image)."""
    out = lib.view_synthesis_generic(image, depth, rays, ref_rays, pose, progress,
                                     padding, RADIUS)
    return (out * weights).sum(), out


@pytest.mark.parametrize('padding', ['zeros', 'border'])
@pytest.mark.parametrize('progress', [0.0, 0.5])
def test_view_synthesis_generic_and_gradients_match_jax(padding, progress):
    """The warped image and the gradients of a weighted sum of it with
    respect to the depth, the target's ray surface and the reference's."""
    depth, image, rays, pose, weights = scene()
    (_, want), want_grads = jax.value_and_grad(
        lambda d, r, rr: _warp_loss(jcg, d, r, rr, jnp.asarray(image), jnp.asarray(pose),
                                    weights, progress, padding),
        argnums=(0, 1, 2), has_aux=True)(jnp.asarray(depth), jnp.asarray(rays),
                                          jnp.asarray(rays))
    sides = {}
    for dtype in (torch.float32, torch.float64):
        t = lambda a: torch.from_numpy(np.array(a)).to(dtype)
        leaves = [t(a).requires_grad_() for a in (depth, rays, rays)]
        loss, out = _warp_loss(tcg, *leaves, t(image), t(pose), t(weights), progress,
                               padding)
        loss.backward()
        sides[dtype] = out.detach(), [x.grad.double().numpy() for x in leaves]
    got, grads = sides[torch.float32]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=IMAGE_ATOL)
    for name, g, w, g64 in zip(('depth', 'ray_surface', 'ref_ray_surface'), grads,
                               want_grads, sides[torch.float64][1]):
        w = np.asarray(w)
        top = np.abs(w).max()
        assert top > 0, name
        assert np.abs(g - w).max() <= GRAD_BOUND * top, (name, np.abs(g - w).max() / top)
        assert np.abs(g - g64).max() <= GRAD_BOUND * top, (name, np.abs(g - g64).max() / top)


def test_patch_larger_than_the_image_is_refused():
    X = torch.ones(1, 8, 8, 3)
    with pytest.raises(ValueError, match='does not fit'):
        tcg.project_generic(X, X, patch_radius=2)
