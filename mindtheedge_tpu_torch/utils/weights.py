"""JAX parameter trees -> the port's ``state_dict``.

The counterpart of ``mindtheedge_tpu/utils/torch_port.py``, running the
other way: ``state_dict_from_jax(params, batch_stats)`` takes the JAX
package's PackNetSAN ``params`` and ``batch_stats`` trees (nested dicts of
numpy arrays) and returns the port's ``state_dict`` with the reference
PackNetSAN01 names.  Layouts:

* conv kernel [kh,kw,I,O]  -> weight [O,I,kh,kw]
* conv3d kernel [3,3,3,1,d] -> weight [d,1,3,3,3]
* GroupNorm scale/bias     -> weight/bias
* MaskedBatchNorm          -> bn.weight/bias/running_mean/running_var
* SAN kernel [kh,kw,I,O]   -> [K^2,I,O], first (row) coordinate fastest
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
    """JAX PackNetSAN ``params`` and ``batch_stats`` -> port ``state_dict``.
    Without ``batch_stats`` the SAN running statistics are left out."""
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
    sparse_encoder(sd, 'mconvs', params['mconvs'],
                   None if batch_stats is None else batch_stats['mconvs'])
    sd['weight'] = _t(params['weight'])
    sd['bias'] = _t(params['bias'])
    return sd
