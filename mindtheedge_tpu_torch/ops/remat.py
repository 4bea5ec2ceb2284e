"""Activation recomputation (``model.depth_net.remat``): counterpart of the
``nn.remat`` wrappers of ``mindtheedge_tpu/models/packnet.py:199-228``.

``checkpoint(fn, *args, policy=...)`` runs ``fn`` under
``torch.utils.checkpoint.checkpoint`` (non-reentrant).  With ``policy``
True the backward keeps only the region's inputs and runs ``fn`` again for
the rest; with ``'conv'`` it also keeps the output of every convolution
and recomputes only what lies between them: norms, activations, masks,
pooling.  (The JAX package's ``save_only_these_names('conv_out')`` keeps
the outputs it tags: its ConvBlock and SAN convolutions; here the 1x1
shortcuts and the heads are kept too, and the pack layers' 3-D
convolutions where they are ``F.conv3d``; on the card their kernel,
``ops/cuda/conv3d_kernel``, is no ATen convolution and runs again.)

What a recompute must not do a second time, and how it is kept out:

* draw random numbers: ``torch.utils.checkpoint`` restores only the
  default generators, not an explicit ``torch.Generator``, so the network
  draws its dropout masks before it enters a region and passes them in
  (``PackNetSAN.run_network``); nothing inside a region draws;
* update state: :func:`recomputing` is true while the backward reruns a
  region, and ``MaskedBatchNorm`` then leaves its running statistics and
  ``num_batches_tracked`` alone.
"""

import contextlib
import functools

import torch
from torch.utils import checkpoint as tc

_recomputes = 0     # regions being rerun by the backward, on any thread


def recomputing():
    """Whether the backward is rerunning a checkpointed region."""
    return _recomputes > 0


@contextlib.contextmanager
def _recompute_scope(inner):
    global _recomputes
    _recomputes += 1
    try:
        with inner:
            yield
    finally:
        _recomputes -= 1


def _keep_convs(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.convolution.default:
        return tc.CheckpointPolicy.MUST_SAVE
    return tc.CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(policy):
    if policy == 'conv':
        forward, recompute = tc.create_selective_checkpoint_contexts(_keep_convs)
    else:
        forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
    return forward, _recompute_scope(recompute)


def checkpoint(fn, *args, policy=True):
    """``fn(*args)``, its activations recomputed in the backward as
    ``policy`` (True or ``'conv'``) says."""
    return tc.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                         context_fn=functools.partial(_contexts, policy))
