"""The port's geometry (mindtheedge_tpu_torch/geometry) against the JAX
package's (mindtheedge_tpu/geometry) on the same numpy inputs.

Poses, intrinsics, the reconstruct/project round trip, bilinear grid
sampling (zeros and border padding) and view synthesis, values and
gradients.  Tolerances: rotation and pose algebra rtol 1e-5 (atol 1e-6);
sampled values rtol 1e-5 (atol 1e-6), warped ones rtol 1e-4 (atol 1e-5:
their coordinates pass through K^-1, the pose and K, each side rounding in
its own order); gradients within 1e-4 of each tensor's largest |gradient|.

The JAX sampler is floor + gather, the port's ``F.grid_sample``: both are
piecewise linear in the coordinates, and at an integer coordinate the two
one-sided derivatives differ, so either side may take either.  The
gradient tests draw coordinates whose fractional parts lie in [0.05,
0.95], away from integers (and view synthesis a pose and a depth that
move every pixel by a fraction of one).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.geometry import camera as jcamera
from mindtheedge_tpu.geometry import pose as jpose
from mindtheedge_tpu_torch.geometry import camera, pose

torch.set_num_threads(1)

B, H, W = 2, 24, 40


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def intrinsics(b=B, h=H, w=W):
    """Pinhole K [b,3,3] in the KITTI proportions (fx ~ 0.58 w)."""
    k = np.array([[0.58 * w, 0.0, 0.5 * w - 0.3],
                  [0.0, 1.92 * h, 0.5 * h + 0.2],
                  [0.0, 0.0, 1.0]], np.float32)
    return np.stack([k * np.array([[1 + 0.05 * i], [1], [1]], np.float32)
                     for i in range(b)])


def pose_vecs(rng, b=B, trans=0.3, rot=0.05):
    return np.concatenate([rng.uniform(-trans, trans, (b, 3)),
                           rng.uniform(-rot, rot, (b, 3))], 1).astype(np.float32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def grads_close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def test_pose_algebra_matches_jax():
    """euler2mat (R = X Y Z), pose_vec2mat, invert_pose, transform_points."""
    rng = np.random.RandomState(0)
    vec = pose_vecs(rng, rot=1.0)
    close(pose.euler2mat(t(vec[:, 3:])), jpose.euler2mat(vec[:, 3:]))
    T = pose.pose_vec2mat(t(vec))
    close(T, jpose.pose_vec2mat(vec))
    close(pose.invert_pose(T), jpose.invert_pose(jnp.asarray(T)))
    close(pose.invert_pose(T) @ T, np.tile(np.eye(4), (B, 1, 1)), atol=1e-6)
    pts = rng.randn(B, 5, 7, 3).astype(np.float32)
    close(pose.transform_points(T, t(pts)), jpose.transform_points(jnp.asarray(T), pts))
    close(pose.identity_pose(3), jpose.identity_pose(3))
    assert pose.pose_vec2mat(t(vec), None) is not None


def test_intrinsics_match_jax():
    """scale_intrinsics with the +0.5 pixel-centre convention and the
    closed-form inverse."""
    K = intrinsics()
    for xs, ys in ((0.5, 0.5), (0.25, 0.125), (2.0, 1.5)):
        close(camera.scale_intrinsics(t(K), xs, ys),
              jcamera.scale_intrinsics(jnp.asarray(K), xs, ys))
    Kinv = camera.invert_intrinsics(t(K))
    close(Kinv, jcamera.invert_intrinsics(jnp.asarray(K)))
    close(Kinv @ t(K), np.tile(np.eye(3), (B, 1, 1)), atol=1e-6)


def test_reconstruct_project_round_trip():
    """project(reconstruct(depth, K), K) is the pixel grid, normalised by
    (W-1)/(H-1); with a pose both match JAX."""
    rng = np.random.RandomState(1)
    K = jnp.asarray(intrinsics())
    depth = rng.uniform(2.0, 50.0, (B, H, W, 1)).astype(np.float32)
    X = camera.reconstruct(t(depth), t(K))
    close(X, jcamera.reconstruct(depth, K), rtol=1e-5, atol=1e-5)
    coords = camera.project(X, t(K))
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    want = np.stack([2 * xs / (W - 1) - 1, 2 * ys / (H - 1) - 1], -1)
    close(coords, np.broadcast_to(want, coords.shape), atol=2e-6)
    T = pose.pose_vec2mat(t(pose_vecs(rng)))
    Tj = jnp.asarray(T)
    close(camera.reconstruct(t(depth), t(K), Tcw=T),
          jcamera.reconstruct(depth, K, Tcw=Tj), rtol=1e-5, atol=1e-5)
    close(camera.project(X, t(K), Tcw=T), jcamera.project(jnp.asarray(X), K, Tcw=Tj),
          rtol=1e-5, atol=1e-5)


def off_integer_coords(rng, b, h, w, out_h, out_w, margin=3):
    """[b,out_h,out_w,2] coordinates in [-1, 1] units whose pixel positions
    reach ``margin`` pixels past every border, fractional parts in [0.05, 0.95]."""
    def axis(size):
        whole = rng.randint(-margin, size + margin, (b, out_h, out_w))
        return whole + rng.uniform(0.05, 0.95, whole.shape)
    x, y = axis(w), axis(h)
    return np.stack([2 * x / (w - 1) - 1, 2 * y / (h - 1) - 1], -1).astype(np.float32)


@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
def test_grid_sample_matches_jax(padding_mode):
    """Values at random coordinates (in and out of the image, and exact
    pixel centres), and the gradients with respect to the image and the
    coordinates (away from integers)."""
    rng = np.random.RandomState(2)
    image = rng.rand(B, H, W, 3).astype(np.float32)
    coords = off_integer_coords(rng, B, H, W, 16, 20)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    centres = np.broadcast_to(np.stack([2 * xs / (W - 1) - 1, 2 * ys / (H - 1) - 1], -1),
                              (B, H, W, 2)).astype(np.float32)
    close(camera.grid_sample(t(image), t(centres), padding_mode), image, atol=2e-6)
    probe = rng.randn(B, 16, 20, 3).astype(np.float32)

    def jloss(img, crd):
        return jnp.sum(jcamera.grid_sample(img, crd, padding_mode) * probe)

    want, (g_img, g_crd) = jax.value_and_grad(jloss, argnums=(0, 1))(image, coords)
    img_t, crd_t = t(image).requires_grad_(), t(coords).requires_grad_()
    out = camera.grid_sample(img_t, crd_t, padding_mode)
    close(out, jcamera.grid_sample(image, coords, padding_mode))
    loss = (out * t(probe)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads_close(img_t.grad, g_img)
    grads_close(crd_t.grad, g_crd)


@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
def test_view_synthesis_matches_jax(padding_mode):
    """The warp of a reference image by depth and pose: values, and the
    gradients with respect to the depth and the pose vector."""
    rng = np.random.RandomState(3)
    ref = rng.rand(B, H, W, 3).astype(np.float32)
    depth = rng.uniform(3.0, 30.0, (B, H, W, 1)).astype(np.float32)
    K = jnp.asarray(intrinsics())
    vec = pose_vecs(rng, trans=0.5, rot=0.03)
    probe = rng.randn(B, H, W, 3).astype(np.float32)

    def jloss(d, v):
        warped = jcamera.view_synthesis(ref, d, K, K, jpose.pose_vec2mat(v), padding_mode)
        return jnp.sum(warped * probe), warped

    (want, warped), (g_d, g_v) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        depth, vec)
    d_t, v_t = t(depth).requires_grad_(), t(vec).requires_grad_()
    out = camera.view_synthesis(t(ref), d_t, t(K), t(K), pose.pose_vec2mat(v_t), padding_mode)
    close(out, warped, rtol=1e-4, atol=1e-5)
    loss = (out * t(probe)).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    grads_close(d_t.grad, g_d)
    grads_close(v_t.grad, g_v)
