"""JAX parameter trees -> the port's ``state_dict``.

The counterpart of ``mindtheedge_tpu/utils/torch_port.py``, running the
other way: ``state_dict_from_jax(params, batch_stats)`` takes the JAX
package's PackNetSAN, PackNet01 or PackNetSlim01 ``params`` and
``batch_stats`` trees (nested dicts of numpy arrays) and returns the port's
``state_dict`` with the reference PackNetSAN01 names.  Every width comes
from the tree's kernels: a 4-channel ``pre_calc`` and version B's
narrower iconvs need nothing of their own.  Layouts:

* conv kernel [kh,kw,I,O]  -> weight [O,I,kh,kw]
* conv3d kernel [3,3,3,1,d] -> weight [d,1,3,3,3]
* GroupNorm scale/bias     -> weight/bias
* MaskedBatchNorm          -> bn.weight/bias/running_mean/running_var
* SAN kernel [kh,kw,I,O]   -> [K^2,I,O], first (row) coordinate fastest

``pose_state_dict_from_jax``, ``resnet_state_dict_from_jax`` and
``raysurface_state_dict_from_jax`` do the same for ``PoseNet``,
``PoseResNet``, ``DepthResNet`` and ``RaySurfaceResNet``, whose flax
BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_mean/
running_var``.  ``depth_state_dict_from_jax`` picks the converter of a
depth network's tree.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv2d(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv3d(k):
    return _t(np.transpose(np.asarray(k), (4, 3, 0, 1, 2)))


def _mink(k):
    k = np.asarray(k)
    kh, kw, i, o = k.shape
    return _t(np.transpose(k, (1, 0, 2, 3)).reshape(kh * kw, i, o))


def conv_block(sd, name, p):
    """ConvBlock {conv, norm} -> ``{name}.conv_base`` / ``{name}.normalize``."""
    sd[f'{name}.conv_base.weight'] = _conv2d(p['conv']['kernel'])
    sd[f'{name}.conv_base.bias'] = _t(p['conv']['bias'])
    group_norm(sd, f'{name}.normalize', p['norm'])


def group_norm(sd, name, p):
    sd[f'{name}.weight'] = _t(p['scale'])
    sd[f'{name}.bias'] = _t(p['bias'])


def conv(sd, name, p):
    """Plain conv {kernel, bias} -> ``{name}.weight`` / ``{name}.bias``."""
    sd[f'{name}.weight'] = _conv2d(p['kernel'])
    sd[f'{name}.bias'] = _t(p['bias'])


def conv3d(sd, name, p):
    sd[f'{name}.weight'] = _conv3d(p['kernel'])
    sd[f'{name}.bias'] = _t(p['bias'])


def residual_block(sd, name, p):
    """ResidualBlock {block0, block1, ...} -> ``{name}.{i}.*``."""
    for i in range(len(p)):
        b = p[f'block{i}']
        conv_block(sd, f'{name}.{i}.conv1', b['conv1'])
        conv_block(sd, f'{name}.{i}.conv2', b['conv2'])
        conv(sd, f'{name}.{i}.conv3', b['conv3'])
        group_norm(sd, f'{name}.{i}.normalize', b['norm'])


def pack_layer(sd, name, p):
    """PackLayerConv3d or UnpackLayerConv3d {conv3d, conv}."""
    conv3d(sd, f'{name}.conv3d', p['conv3d'])
    conv_block(sd, f'{name}.conv', p['conv'])


def batch_norm(sd, name, p, stats):
    """MaskedBatchNorm {scale, bias} + batch_stats {mean, var} -> ``{name}.bn``;
    ``stats`` None leaves the running statistics out."""
    sd[f'{name}.bn.weight'] = _t(p['scale'])
    sd[f'{name}.bn.bias'] = _t(p['bias'])
    if stats is None:
        return
    sd[f'{name}.bn.running_mean'] = _t(stats['mean'])
    sd[f'{name}.bn.running_var'] = _t(stats['var'])
    sd[f'{name}.bn.num_batches_tracked'] = torch.tensor(0)


def sparse_encoder(sd, name, p, stats):
    """SparseDepthEncoder {mconv0, ...} -> ``{name}.mconvs.{lvl}.*``."""
    for lvl in range(len(p)):
        pl = p[f'mconv{lvl}']
        sl = None if stats is None else stats[f'mconv{lvl}']
        base = f'{name}.mconvs.{lvl}'
        # nn.Sequential slots: conv at 3j, batch norm at 3j+1 (ReLU at 3j+2)
        for layer, n_convs in (('layer1', 1), ('layer2', 2), ('layer3', 3)):
            for j in range(n_convs):
                sd[f'{base}.{layer}.{3 * j}.kernel'] = \
                    _mink(pl[f'{layer}_{j}']['conv']['kernel'])
                if j < n_convs - 1:
                    batch_norm(sd, f'{base}.{layer}.{3 * j + 1}',
                               pl[f'{layer}_bn{j}'],
                               None if sl is None else sl[f'{layer}_bn{j}'])
        batch_norm(sd, f'{base}.layer_final.0', pl['final_bn'],
                   None if sl is None else sl['final_bn'])


def state_dict_from_jax(params, batch_stats=None):
    """JAX PackNetSAN, PackNet01 or PackNetSlim01 ``params`` and
    ``batch_stats`` -> port ``state_dict``.  Without ``batch_stats`` the SAN
    running statistics are left out; a tree without ``mconvs`` (PackNet01,
    PackNetSlim01) has neither the SAN ladder nor the fusion ``weight`` /
    ``bias``."""
    sd = {}
    enc, dec = params['encoder'], params['decoder']
    conv_block(sd, 'encoder.pre_calc', enc['pre_calc'])
    conv_block(sd, 'encoder.conv1', enc['conv1'])
    for i in range(2, 6):
        residual_block(sd, f'encoder.conv{i}', enc[f'conv{i}'])
    for i in range(1, 6):
        pack_layer(sd, f'encoder.pack{i}', enc[f'pack{i}'])
        pack_layer(sd, f'decoder.unpack{i}', dec[f'unpack{i}'])
        conv_block(sd, f'decoder.iconv{i}', dec[f'iconv{i}'])
    for i in range(1, 5):
        conv(sd, f'decoder.disp{i}_layer.conv1', dec[f'disp{i}_layer']['conv1'])
    if 'mconvs' in params:
        sparse_encoder(sd, 'mconvs', params['mconvs'],
                       None if batch_stats is None else batch_stats['mconvs'])
        sd['weight'] = _t(params['weight'])
        sd['bias'] = _t(params['bias'])
    return sd


def flax_batch_norm(sd, name, p, stats):
    """flax BatchNorm {bn: {scale, bias}} + batch_stats {bn: {mean, var}}
    -> ``{name}.weight/bias/running_mean/running_var``."""
    sd[f'{name}.weight'] = _t(p['bn']['scale'])
    sd[f'{name}.bias'] = _t(p['bn']['bias'])
    if stats is not None:
        sd[f'{name}.running_mean'] = _t(stats['bn']['mean'])
        sd[f'{name}.running_var'] = _t(stats['bn']['var'])
        sd[f'{name}.num_batches_tracked'] = torch.tensor(0)


def resnet_encoder(sd, name, p, stats):
    """ResnetEncoder {conv1, bn1, layer{s}_{b}} -> ``{name}.encoder.*``
    (torchvision names)."""
    st = (lambda k: None) if stats is None else stats.get
    sd[f'{name}.encoder.conv1.weight'] = _conv2d(p['conv1']['kernel'])
    flax_batch_norm(sd, f'{name}.encoder.bn1', p['bn1'], st('bn1'))
    for key, block in p.items():
        if not key.startswith('layer'):
            continue
        stage, b = key[len('layer'):].split('_')
        base = f'{name}.encoder.layer{stage}.{b}'
        bst = (lambda k: None) if stats is None else stats[key].get
        for sub, val in block.items():
            if sub == 'downsample_conv':
                sd[f'{base}.downsample.0.weight'] = _conv2d(val['kernel'])
            elif sub == 'downsample_bn':
                flax_batch_norm(sd, f'{base}.downsample.1', val, bst(sub))
            elif sub.startswith('conv'):
                sd[f'{base}.{sub}.weight'] = _conv2d(val['kernel'])
            else:
                flax_batch_norm(sd, f'{base}.{sub}', val, bst(sub))


def resnet_state_dict_from_jax(params, batch_stats=None):
    """JAX ``DepthResNet`` or ``PoseResNet`` ``params`` (+ ``batch_stats``)
    -> the port's ``state_dict`` (reference monodepth2 names)."""
    sd = {}
    resnet_encoder(sd, 'encoder', params['encoder'],
                   None if batch_stats is None else batch_stats['encoder'])
    dec = params['decoder']
    if 'squeeze_0' in dec:          # PoseDecoder
        for j, key in enumerate(('squeeze_0', 'pose_0', 'pose_1', 'pose_2')):
            conv(sd, f'decoder.net.{j}', dec[key])
        return sd
    depth_decoder(sd, 'decoder', dec, [f'dispconv_{s}' for s in range(4)])
    return sd


def depth_decoder(sd, name, p, heads):
    """monodepth2 DepthDecoder or RaySurfaceDecoder {upconv_{i}_{k},
    heads...} -> ``{name}.decoder.{j}``: the upconvs 4,0 ... 0,1, then the
    heads in order."""
    for j, i in enumerate(range(4, -1, -1)):
        for k in (0, 1):
            conv(sd, f'{name}.decoder.{2 * j + k}.conv.conv', p[f'upconv_{i}_{k}']['conv'])
    for s, head in enumerate(heads):
        conv(sd, f'{name}.decoder.{10 + s}.conv', p[head]['conv'])


def raysurface_state_dict_from_jax(params, batch_stats=None):
    """JAX ``RaySurfaceResNet`` ``params`` (+ ``batch_stats``) -> the port's
    ``state_dict``: the encoder and the depth decoder as
    :func:`resnet_state_dict_from_jax`, the ray-surface decoder under
    ``ray_surf`` (reference ``RaySurfaceResNet.py``)."""
    sd = resnet_state_dict_from_jax(params, batch_stats)
    depth_decoder(sd, 'ray_surf', params['ray_surf'], ['raysurfconv_0'])
    return sd


def depth_state_dict_from_jax(params, batch_stats=None):
    """Any JAX depth network's ``params`` (+ ``batch_stats``) -> the port's
    ``state_dict``, by the tree's shape: PackNet (a ``pre_calc`` stem),
    ``RaySurfaceResNet`` (a ``ray_surf`` decoder) or ``DepthResNet``."""
    if 'pre_calc' in params['encoder']:
        return state_dict_from_jax(params, batch_stats)
    if 'ray_surf' in params:
        return raysurface_state_dict_from_jax(params, batch_stats)
    return resnet_state_dict_from_jax(params, batch_stats)


def pose_state_dict_from_jax(params, batch_stats=None):
    """JAX ``PoseNet`` or ``PoseResNet`` ``params`` (+ ``batch_stats``) ->
    the port's ``state_dict``: PoseNet's layers under the reference names
    ``conv{i}.0`` (conv), ``conv{i}.1`` (GroupNorm) and ``pose_pred``."""
    if 'pose_pred' not in params:
        return resnet_state_dict_from_jax(params, batch_stats)
    sd = {}
    for key, p in params.items():
        if key == 'pose_pred':
            conv(sd, 'pose_pred', p)
        else:
            conv(sd, f'{key}.0', p['conv'])
            group_norm(sd, f'{key}.1', p['norm'])
    return sd
