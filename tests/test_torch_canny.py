"""The port's batched Canny (``ops/canny.py``) on the CPU against the JAX
package's ``ops/canny.canny`` and ``canny_sweep``, and against
``cv2.Canny`` as ``tests/test_canny.py`` holds the JAX op.

Seeded uint8-range images: ``tests/test_canny.py``'s ramp with two steps,
and a noisy blocky scene as the evaluation renders depth (blocks, 5 grey
levels of noise).  Maps equal to the JAX op's on >= 99.99 % of pixels (the
``atan2`` buckets may part at a boundary by an ulp), for scalar and vector
thresholds, 2-D and 3-D images; >= 0.97 agreement with cv2; the sweep's
edge counts fall with the threshold.

Scalar thresholds give [B,H,W] maps ([H,W] for a 2-D image), as the JAX
docstring says; the JAX op returns them with a leading axis of 1, since it
tests ``np.ndim(low)`` after making ``low`` a vector (``canny.py:72-94``,
ROADMAP "Kept on purpose"), so the scalar cases compare with its map 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import canny as jcanny
from mindtheedge_tpu_torch.ops import canny
from tests.test_canny import synthetic_depth_image
from tests.test_torch_spatial_cuda import blocky_frames

torch.set_num_threads(1)

AGREE = 0.9999
SWEEP = list(range(20, 241, 20))        # the edge-AUC protocol's thresholds


def noisy_scenes(b=3, h=96, w=128, seed=0):
    """[b,h,w] uint8-range float32 images of a blocky scene with noise."""
    return (blocky_frames(np.random.RandomState(seed), b, h, w)[..., 0] * 255.0
            ).round().astype(np.float32)


def assert_agree(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    agree = (got == want).mean()
    assert agree >= AGREE, f'{agree:.6f} of pixels agree with the JAX op'
    assert set(np.unique(got)) <= {0.0, 1.0} and got.sum() > 0


@pytest.mark.parametrize('image', ['ramp', 'scenes'])
@pytest.mark.parametrize('thresholds', ['scalar', 'vector'])
def test_canny_matches_jax(image, thresholds):
    img = synthetic_depth_image().astype(np.float32) if image == 'ramp' else noisy_scenes()
    low, high = (20.0, 40.0) if thresholds == 'scalar' else ([10.0, 20.0, 60.0],
                                                              [20.0, 40.0, 120.0])
    want = jcanny.canny(jnp.asarray(img), low, high)
    if thresholds == 'scalar':
        assert want.shape == (1,) + img.shape
        want = want[0]
    got, steps, checks = canny.canny_counted(torch.from_numpy(img), low, high)
    assert_agree(got, want)
    assert steps >= 1 and checks >= 1


def test_canny_sweep_matches_jax_and_falls():
    img = noisy_scenes(seed=1)
    want = jcanny.canny_sweep(jnp.asarray(img), SWEEP)
    got = canny.canny_sweep(torch.from_numpy(img), SWEEP)
    assert got.shape == (len(SWEEP),) + img.shape
    assert_agree(got, want)
    counts = got.reshape(len(SWEEP), -1).sum(1)
    assert (counts[1:] <= counts[:-1]).all()


def test_canny_close_to_cv2():
    import cv2
    img = synthetic_depth_image()
    ref = (cv2.Canny(img, 20, 40) > 0).astype(np.float32)
    got = canny.canny(torch.from_numpy(img.astype(np.float32)), 20.0, 40.0).numpy()
    assert got.shape == ref.shape
    agree = (got == ref).mean()
    assert agree > 0.97, f'only {agree:.3f} pixel agreement with cv2'
    assert ref.sum() > 50 and got.sum() > 50
