"""Spatial sharding with halo exchange: counterpart of
``mindtheedge_tpu/parallel/spatial.py``.

Where one card cannot hold a frame's activations (DDAD-DE at its native
1216x1936, ``configs/eval_ddad_de.yaml``), the frame is cut into equal
row (H) and column (W) blocks, one block a process, and every stride-1
SAME convolution first takes ``k//2`` rows and columns from its
neighbours.  The JAX package runs one ``shard_map`` over a
``('space',)``, ``('space', 'space_w')`` or ``('data', 'space')`` mesh;
here it is ``torch.distributed`` with one process per GPU, as
``parallel/mesh.py``, NCCL on the card and gloo on the CPU.

The ranks are laid out data-major, space-minor, H before W, as
``make_dp_space_mesh`` / ``make_space_mesh_hw`` lay out devices
(``spatial.py:157-176``): rank ``((d * n_h) + h) * n_w + w`` holds row
block ``h`` and column block ``w`` of data replica ``d``.  :class:`Space`
makes one process subgroup per column (the H exchange), per row (the W
exchange) and per replica (the statistics); every rank makes every group,
in one order.

* :func:`halo_exchange` receives the neighbours' ``p`` boundary slices;
  at the grid's edges the slices are zeros, which is exactly the global
  SAME zero padding.  H first, then W on the H-extended tensor, so the
  corner blocks arrive by the second exchange.  A dimension split over one
  process is zero-padded: the sharded code path with nothing to exchange.
  Each exchange is one ``all_gather`` of the two boundary slices in the
  row or column group (NCCL and gloo both take it for CUDA tensors, so
  the CPU tests and the card run one code path); its backward is the
  reverse exchange, whose received cotangents are added onto this rank's
  boundary slices.
* :func:`space_all_reduce` sums (or averages) over the replica's blocks;
  its backward is the same reduction of the cotangent.  The SAN's masked
  batch-norm sums go through it (``ops/sparse.py``); :func:`group_norm`
  gathers each block's channel means and variances instead
  (``ops/blocks.py``).
* :func:`gather_spatial` assembles the full frame, a tiled all-gather
  whose backward is a *sum* reduce-scatter: every rank computes the same
  loss on the gathered pyramid, so each block's gradient carries a factor
  ``n``, as JAX's transpose of a tiled ``all_gather`` gives; one mean over
  all ranks then yields the exact gradient of the sharded depth net, of
  the replicated pose net, and the data-parallel average at once
  (``parallel/mesh.make_spatial_train_step``).

Which modules exchange: every conv with ``k > 1`` (ConvBlock, InvDepthHead,
the pack layers' 3-D convs and the convs behind them, the SAN convs) and
the SAN's masked pool (``x`` and ``mask`` apart, so the edge halo has mask
0).  ``pack2d``, ``unpack2d``, the nearest upsample and 1x1 convs stay
within a block, provided every local extent stays even through the 5 pack
levels: ``(H / n) % 32 == 0`` (:func:`legal_space_sizes`).  The parameters
do not change: any checkpoint loads into a sharded network.

Under ``arch.precision: bfloat16`` the exchanges and gathers move the
activations in their own dtype (gloo and NCCL both take bf16), while the
statistics are reduced in fp32 and each normalised output is rounded to
bf16 once, as the unsharded bf16 path computes them (``ops/blocks.py``,
``ops/sparse.py``).
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mindtheedge_tpu_torch.parallel.distributed import rank, world_size

H_DIM, W_DIM = -2, -1       # of an NCHW (or NCDHW) activation


def legal_space_sizes(height, n_levels=5, limit=8):
    """Every n <= ``limit`` that divides ``height`` with a local height that
    stays even through ``n_levels`` halvings (``spatial.py:111-117``)."""
    div = 2 ** n_levels
    return [n for n in range(1, limit + 1)
            if height % n == 0 and (height // n) % div == 0]


def max_space_devices(height, n_levels=5, limit=8):
    """The largest power of two n <= ``limit`` whose local height stays even
    through ``n_levels`` halvings, else 1 (``spatial.py:120-137``)."""
    best = 1
    n = 2
    while n <= limit:
        h = height
        ok = h % n == 0
        h //= n
        for _ in range(n_levels):
            if h % 2 != 0:
                ok = False
                break
            h //= 2
        if ok:
            best = n
        n *= 2
    return best


def legal_space_grids(height, width, n_levels=5, limit=8):
    """Every (n_h, n_w) of legal sizes with ``n_h * n_w <= limit``
    (``spatial.py:147-155``)."""
    hs = legal_space_sizes(height, n_levels, limit)
    ws = legal_space_sizes(width, n_levels, limit)
    return [(nh, nw) for nh in hs for nw in ws if nh * nw <= limit]


class Line:
    """One row or column of the grid this rank lies on: its process group
    (None for a line of one), this rank's index along it, its length."""

    def __init__(self, group, index, size):
        self.group, self.index, self.size = group, index, size


class Space:
    """The rank layout of a spatially sharded run over the process group
    (or one process without one): ``n_h`` row blocks and ``n_w`` column
    blocks a data replica, ``world / (n_h * n_w)`` replicas.

    ``n_h`` (``n_w``) None leaves H (W) whole, its convs zero-padded as in
    the plain network; a number, 1 included, cuts it into that many
    blocks, halo-exchanged.  Every rank must construct it with the same
    arguments at the same point: it makes the subgroups.  ``counts`` holds
    the collectives launched in forward passes since it was last cleared:
    ``'exchange'`` a halo exchange of one dimension (padding-only ones
    included), ``'statistics'`` a GroupNorm or batch-norm reduction over the
    replica's blocks, ``'gather'`` the assembly of a frame along one
    dimension.
    """

    def __init__(self, n_h=1, n_w=None):
        if n_h is None and n_w is None:
            raise ValueError('a Space shards H, W or both: give n_h or n_w')
        nh, nw = n_h or 1, n_w or 1
        world, me = world_size(), rank()
        if world % (nh * nw):
            raise ValueError(f'{nh} x {nw} blocks do not divide {world} process(es): '
                             f'launch a multiple of {nh * nw}')
        self.n_h, self.n_w = n_h, n_w
        self.n_space = nh * nw
        self.n_data = world // self.n_space
        self.data, block = divmod(me, self.n_space)
        self.h, self.w = divmod(block, nw)
        ranks = lambda d, hs, ws: [(d * nh + h) * nw + w for h in hs for w in ws]
        columns = {(d, w): ranks(d, range(nh), [w]) for d in range(self.n_data)
                   for w in range(nw)}
        rows = {(d, h): ranks(d, [h], range(nw)) for d in range(self.n_data)
                for h in range(nh)}
        replicas = {d: ranks(d, range(nh), range(nw)) for d in range(self.n_data)}
        mine = lambda groups, key: groups.get(key) if groups else None
        self.h_line = Line(mine(self._groups(columns), (self.data, self.w)), self.h, nh)
        self.w_line = Line(mine(self._groups(rows), (self.data, self.h)), self.w, nw)
        self.space_group = mine(self._groups(replicas), self.data)
        self.block_line = Line(self.space_group, block, self.n_space)
        self.counts = {'exchange': 0, 'statistics': 0, 'gather': 0}

    @staticmethod
    def _groups(members):
        """{key: process group} of ``members`` ({key: ranks}) of more than
        one rank: every rank calls ``new_group`` for every one, in order."""
        if world_size() == 1:
            return {}
        return {key: dist.new_group(ranks) for key, ranks in members.items()
                if len(ranks) > 1}

    def lines(self):
        """(tensor dim, line) of each sharded dimension, H first."""
        return [(dim, line) for dim, n, line in ((H_DIM, self.n_h, self.h_line),
                                                 (W_DIM, self.n_w, self.w_line))
                if n is not None]

    def __repr__(self):
        return (f'Space({self.n_data} data x {self.n_h} h x {self.n_w} w; this rank: '
                f'data {self.data}, h {self.h}, w {self.w})')


def _all_gather(x, line):
    """[line.size, *x.shape]: ``x`` of every rank along ``line``."""
    out = torch.empty((line.size * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=line.group)
    return out.view((line.size,) + x.shape)


def _swap(a, b, line):
    """Along ``line``: (the previous rank's ``b``, the next rank's ``a``),
    zeros where there is no such rank."""
    if line.size == 1:
        return torch.zeros_like(b), torch.zeros_like(a)
    out = _all_gather(torch.stack([a, b]), line)
    i = line.index
    prev_b = out[i - 1, 1] if i > 0 else torch.zeros_like(b)
    next_a = out[i + 1, 0] if i + 1 < line.size else torch.zeros_like(a)
    return prev_b, next_a


class _Exchange(torch.autograd.Function):
    """[.., n, ..] -> [.., p + n + p, ..] along ``dim``: the previous
    rank's last ``p`` slices, this block, the next rank's first ``p``."""

    @staticmethod
    def forward(ctx, x, p, dim, line):
        if x.shape[dim] < p:
            raise ValueError(f'halo {p} exceeds the local extent {x.shape[dim]} (dim {dim})')
        ctx.p, ctx.dim, ctx.line, ctx.n = p, dim, line, x.shape[dim]
        top, bottom = _swap(x.narrow(dim, 0, p), x.narrow(dim, x.shape[dim] - p, p), line)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        p, dim, n = ctx.p, ctx.dim, ctx.n
        # the halo slices' cotangents belong to the neighbours' boundaries
        to_first, to_last = _swap(grad.narrow(dim, 0, p), grad.narrow(dim, p + n, p),
                                  ctx.line)
        out = grad.narrow(dim, p, n).clone()
        out.narrow(dim, 0, p).add_(to_first)
        out.narrow(dim, n - p, p).add_(to_last)
        return out, None, None, None


def halo_exchange(x, p, space):
    """The local block ``x`` (NCHW, or NCDHW with H, W last) with ``p``
    rows and columns of its neighbours around each sharded dimension,
    zeros at the grid's edges; ``x`` itself where ``p`` is 0 or ``space``
    None (``spatial.py:69-107``)."""
    if p == 0 or space is None:
        return x
    for dim, line in space.lines():
        space.counts['exchange'] += 1
        x = _Exchange.apply(x, p, x.dim() + dim, line)
    return x


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def space_all_reduce(x, space, mean=False):
    """The sum (or, with ``mean``, the mean) of ``x`` over the blocks of
    this rank's data replica, differentiable (``lax.psum`` / ``pmean``)."""
    if space.n_space == 1:
        return x
    space.counts['statistics'] += 1
    out = _AllReduce.apply(x, space.space_group)
    return out / space.n_space if mean else out


class _Gather(torch.autograd.Function):
    """The blocks of ``line`` concatenated along ``dim``; the backward sums
    the cotangents of every rank and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, line):
        ctx.dim, ctx.line = dim, line
        return torch.cat(_all_gather(x, line).unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        parts = grad.chunk(ctx.line.size, ctx.dim)
        out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
        dist.reduce_scatter_tensor(out, torch.cat(parts, 0), group=ctx.line.group)
        return out, None, None


def gather_spatial(x, space):
    """The full frame of the local blocks ``x`` [B,h,w,C] (NHWC), on every
    rank of the replica; differentiable (``lax.all_gather(tiled=True)``)."""
    for dim, line in reversed(space.lines()):   # W first, then whole rows in H
        if line.size > 1:
            space.counts['gather'] += 1
            x = _Gather.apply(x, x.dim() + dim - 1, line)
    return x


def shard_spatial(x, space):
    """This rank's block of the full frame ``x`` [B,H,W,C] (NHWC; None
    stays None) (``spatial.py:203-207``, the slicing ``shard_map`` does)."""
    if x is None:
        return None
    for dim, line in space.lines():
        dim = x.dim() + dim - 1
        if x.shape[dim] % line.size:
            raise ValueError(f'extent {x.shape[dim]} (dim {dim}) does not split into '
                             f'{line.size} blocks')
        x = x.chunk(line.size, dim)[line.index]
    return x


def sharded_conv(x, weight, bias, space=None, stride=1):
    """A SAME conv (2-D, or 3-D for a 5-D ``weight``) of ``x``, zero padding
    ``k//2``; under ``space`` the stride-1 conv of the local block: ``k//2``
    halo in the sharded dimensions and no padding there, zero padding in
    the others (``blocks.py:232-255``)."""
    p = weight.shape[-1] // 2
    pad = [p] * (weight.dim() - 2)
    if space is not None:
        if stride != 1:
            raise ValueError(f'spatial sharding takes stride-1 convs, not stride {stride}')
        for dim, _ in space.lines():
            pad[dim] = 0
        x = halo_exchange(x, p, space)
    conv = F.conv3d if weight.dim() == 5 else F.conv2d
    return conv(x, weight, bias, stride, tuple(pad))


def group_norm(x, num_groups, weight, bias, eps, space):
    """GroupNorm of the local block with the statistics of the whole frame:
    each block's per-channel fp32 mean and (two-pass) variance over its
    (H, W) are gathered over the replica's blocks and combined, then each
    group's channels, by the parallel-variance rule (the mean of the
    variances plus the variance of the means: equal blocks, equal
    channels), so no ``E[x^2] - E[x]^2`` cancels where a channel's mean
    dwarfs its spread.  The JAX package averages ``E[x]`` and ``E[x^2]``
    (``blocks.py:112-131``), one pass, as its unsharded GroupNorm does;
    the port's unsharded ``F.group_norm`` is two-pass, and so is this.
    The output is computed in fp32 and rounded to ``x``'s dtype once, as
    ``F.group_norm`` rounds a bf16 activation's."""
    b, c = x.shape[:2]
    xf = x.float()
    blocks = torch.stack([xf.mean((2, 3)), xf.var((2, 3), unbiased=False)])[None]
    if space.n_space > 1:
        space.counts['statistics'] += 1
        blocks = _Gather.apply(blocks, 0, space.block_line)
    mean_i, var_i = blocks.unbind(1)                                    # [n,B,C] each
    mean_c = mean_i.mean(0)
    var_c = (var_i + (mean_i - mean_c) ** 2).mean(0)
    mean_gc, var_gc = (t.reshape(b, num_groups, -1) for t in (mean_c, var_c))
    mean_g = mean_gc.mean(-1)
    var_g = (var_gc + (mean_gc - mean_g[..., None]) ** 2).mean(-1)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(c // num_groups, 1) * weight
    off_c = bias - mean_g.repeat_interleave(c // num_groups, 1) * inv_c
    return (xf * inv_c[:, :, None, None] + off_c[:, :, None, None]).to(x.dtype)


def shard_network(net, space):
    """Set ``space`` on every block of ``net`` that takes one (None: the
    plain network again) -> ``net``.  Parameters and buffers keep their
    values; the 4-D conv weights take the layout of the network's
    activations (``ops/blocks.lay_out_weights``: NCHW under a ``space``),
    and ``net.space`` records ``space`` for the training step's casts.
    The PackNet networks (PackNet-SAN, ``PackNet01``, ``PackNetSlim01``)
    are built of such blocks; a network without any (the ResNets, as in
    the JAX package) raises (``spatial.py:260-261``).  The ResNets'
    ``BatchNorm2d`` takes a ``space`` too, but only the batch-sharded step
    sets it (``parallel/mesh.make_sharded_train_step``): their convs do not
    exchange halos."""
    from mindtheedge_tpu_torch.models.resnet import BatchNorm2d
    from mindtheedge_tpu_torch.ops.blocks import lay_out_weights
    blocks = [m for m in net.modules() if hasattr(m, 'space') and not isinstance(m, BatchNorm2d)]
    if not blocks:
        raise ValueError(f'{type(net).__name__} has no spatial support')
    for m in blocks:
        m.space = space
    net.space = space
    return lay_out_weights(net, space)


def make_spatial_infer(net, space, with_depth=False):
    """The sharded eval forward of a PackNet network (``spatial.py:179-200``):
    ``net`` is switched to ``space`` here (:func:`shard_network`).  Returns
    ``fn(rgb[, input_depth][, rgb_edge]) -> inv_depths``, this rank's blocks
    in (:func:`shard_spatial`) and out, NHWC; a 4-channel network's scale 0
    is multiplied by the block's ``rgb_edge`` rows."""
    shard_network(net, space)

    @torch.no_grad()
    def infer(rgb, input_depth=None, rgb_edge=None):
        if (input_depth is not None) != with_depth:
            raise ValueError(f'made with with_depth={with_depth}')
        return net.eval()(rgb, input_depth, rgb_edge=rgb_edge)['inv_depths']

    return infer
