"""The port's tracing (``utils/profiling.py``) on the CPU at 64x96: spans
and the ``h2d_bytes`` counter of a ``serve.serve`` request and of a
training step, the self-supervised step's pose, photometric and warp
spans and its ``view_synthesis`` counter, kept only while a profiler
records or inside ``recording()``; their tree, in the records and among the profiler's own
events; request ids; self times; the buffer's bound; and outputs,
gradients and weights bit-equal with tracing on and off.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils import profiling

torch.set_num_threads(1)

CHANNELS = (16,) * 6
B, H, W = 2, 64, 96
STEP_PARTS = ['mte.train.zero_grad', 'mte.train.loss', 'mte.train.backward',
              'mte.train.grad_norm', 'mte.train.optimizer']


def request_inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    rgb_u8 = torch.randint(0, 256, (B, H, W, 3), generator=gen, dtype=torch.uint8)
    lidar = torch.rand(B, H, W, 1, generator=gen) * 80.0
    lidar[torch.rand(B, H, W, 1, generator=gen) < 0.9] = 0.0
    return rgb_u8, lidar


def train_batch(seed=0):
    """Blocky depth with its edges and normals at the 4 scales, 10 %
    LiDAR, 25 % ground truth."""
    gen = torch.Generator().manual_seed(seed)
    depth = torch.full((B, H, W, 1), 30.0)
    depth[:, 10:40, 20:60] = 12.0
    depth[1, 30:60, 50:90] = 6.0
    batch = {'rgb': torch.rand(B, H, W, 3, generator=gen),
             'depth': depth * (torch.rand(B, H, W, 1, generator=gen) < 0.25),
             'input_depth': depth * (torch.rand(B, H, W, 1, generator=gen) < 0.1)}
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s]
        edge = (d.diff(dim=2, append=d[:, :, -1:]) != 0) | (d.diff(dim=1, append=d[:, -1:]) != 0)
        batch['edge' + key] = edge.float()
        batch['normal' + key] = (torch.rand(d.shape, generator=gen) * 2 - 1) * torch.pi
    return batch


def train_setup():
    cfg = get_cfg_defaults()
    cfg.model.name = 'SemiSupEdgeModel'
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.channels = CHANNELS
    cfg.model.depth_net.dropout = 0.5
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = 0.5
    cfg.edges.train_depth_edges = True
    task = build_task(cfg, device='cpu')
    state = create_train_state(cfg, task.depth_net)
    return task, state, make_train_step(task)


def profiled(fn):
    """``fn()`` under the CPU profiler -> (its result, the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


@pytest.fixture(scope='module')
def model():
    return serve.build(CHANNELS, device='cpu', seed=3)


@pytest.fixture(scope='module')
def served(model):
    """A request with tracing off, then the same request under the
    profiler -> (outputs off, outputs on, records, profiler events)."""
    rgb_u8, lidar = request_inputs()
    profiling.reset()
    off = serve.serve(model, rgb_u8, lidar)
    assert profiling.records() == []
    on, events = profiled(lambda: serve.serve(model, rgb_u8, lidar))
    return off, on, profiling.records(), events


@pytest.fixture(scope='module')
def stepped():
    """One step from one state with tracing off and one under the profiler
    -> ((loss, grads, weights) off, on, records, profiler events)."""
    results = []
    profiling.reset()
    for traced in (False, True):
        task, state, step = train_setup()
        gen = torch.Generator().manual_seed(7)

        def run():
            metrics = step(state, train_batch(), gen)
            net = state.net
            return (metrics['loss'].detach().clone(),
                    {n: p.grad.clone() for n, p in net.named_parameters()},
                    {n: t.detach().clone() for n, t in net.state_dict().items()})
        if traced:
            out, events = profiled(run)
        else:
            out = run()
            assert profiling.records() == []
        results.append(out)
    return results[0], results[1], profiling.records(), events


def children(spans, parent):
    return [s for s in spans if s['parent'] == parent['id']]


def named(spans, name):
    return [s for s in spans if s['name'] == name]


def ancestors(event):
    out, e = [], event.cpu_parent
    while e is not None:
        out.append(e.name)
        e = e.cpu_parent
    return out


def test_tracing_off_is_one_shared_noop():
    assert not profiling._profiler_on()
    a, b = profiling.span('mte.a'), profiling.span('mte.b')
    assert a is b
    profiling.reset()
    with a:
        profiling.count('n', 1)
    assert profiling.records() == []


def test_request_span_tree(served):
    _, _, recs, events = served
    assert len(recs) == 1 and recs[0]['name'] == 'mte.serve.request'
    spans = recs[0]['spans']
    root = named(spans, 'mte.serve.request')[0]
    assert [s['name'] for s in children(spans, root)] == [
        'mte.serve.input', 'mte.net.forward', 'mte.serve.post']
    forward = named(spans, 'mte.net.forward')[0]
    convs = named(spans, 'mte.net.conv3d')
    assert len(convs) == 10 and all(s['parent'] == forward['id'] for s in convs)
    assert len(spans) == 14
    for s in spans:
        assert s['host_ms'] >= s['self_host_ms'] >= 0 and s['device_ms'] >= 0
    # the same names and nesting among the profiler's own events
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append(e)
    assert len(by_name['mte.net.conv3d']) == 10
    for e in by_name['mte.net.conv3d']:
        assert ancestors(e)[:2] == ['mte.net.forward', 'mte.serve.request']
    for name in ('mte.serve.input', 'mte.net.forward', 'mte.serve.post'):
        assert [ancestors(e)[0] for e in by_name[name]] == ['mte.serve.request']


def test_step_span_tree(stepped):
    _, _, recs, events = stepped
    assert len(recs) == 1 and recs[0]['name'] == 'mte.train.step'
    spans = recs[0]['spans']
    root = named(spans, 'mte.train.step')[0]
    assert [s['name'] for s in children(spans, root)] == STEP_PARTS
    loss = named(spans, 'mte.train.loss')[0]
    forward = named(spans, 'mte.net.forward')
    assert len(forward) == 1 and forward[0]['parent'] == loss['id']
    convs = named(spans, 'mte.net.conv3d')
    assert len(convs) == 20 and all(s['parent'] == forward[0]['id'] for s in convs)
    assert loss['self_device_ms'] == pytest.approx(
        loss['device_ms'] - forward[0]['device_ms'], abs=1e-6)
    convs_seen = [e for e in events if e.name == 'mte.net.conv3d']
    assert len(convs_seen) == 20
    for e in convs_seen:
        assert ancestors(e)[:3] == ['mte.net.forward', 'mte.train.loss', 'mte.train.step']


def test_selfsup_step_spans_and_counter():
    """A step of the self-supervised task (PackNet01 + PoseNet, 2 contexts,
    4 scales): one pose span and one photometric span inside the loss, the
    8 warps inside the photometric span, the counter at 8; with tracing off
    the same step keeps no record."""
    from tests.test_torch_selfsup_reference import selfsup_setup
    _, state, step, batch, _, _, _ = selfsup_setup()
    profiling.reset()
    step(state, batch, torch.Generator().manual_seed(0))
    assert profiling.records() == []
    with profiling.recording():
        step(state, batch, torch.Generator().manual_seed(0))
    recs = profiling.records()
    assert len(recs) == 1 and recs[0]['name'] == 'mte.train.step'
    assert recs[0]['counters'] == {'view_synthesis': 8}
    spans = recs[0]['spans']
    loss = named(spans, 'mte.train.loss')[0]
    assert [s['name'] for s in children(spans, loss)] == [
        'mte.net.forward', 'mte.net.pose', 'mte.train.photometric']
    photometric = named(spans, 'mte.train.photometric')[0]
    warps = named(spans, 'mte.train.warp')
    assert len(warps) == 8 and all(s['parent'] == photometric['id'] for s in warps)
    assert loss['self_host_ms'] < loss['host_ms']


def test_request_ids_shared_within_and_distinct_across_units(model):
    rgb_u8, lidar = request_inputs(1)
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            serve.serve(model, rgb_u8, lidar)
        with profiling.span('mte.train.step'):
            with profiling.span('mte.train.loss'):
                profiling.count('things', 3)
    raw = list(profiling._buffer)
    recs = profiling.records()
    assert [r['name'] for r in recs] == ['mte.serve.request'] * 2 + ['mte.train.step']
    assert len({r['request'] for r in recs}) == 3
    for r in recs:
        ids = {s['id'] for s in r['spans']}
        assert r['request'] in ids
        assert all(s['parent'] in ids for s in r['spans'] if s['parent'] is not None)
        kept = [x for x in raw if isinstance(x, profiling._Span) and x.id in ids]
        assert {x.request for x in kept} == {r['request']}
    assert recs[2]['counters'] == {'things': 3}
    assert not profiling._open


def test_self_times_on_hand_made_spans():
    spans = [
        {'id': 0, 'parent': None, 'host_start': 0.0, 'host_end': 10.0},
        {'id': 1, 'parent': 0, 'host_start': 1.0, 'host_end': 4.0},
        {'id': 2, 'parent': 0, 'host_start': 3.0, 'host_end': 6.0},   # overlaps 1
        {'id': 3, 'parent': 0, 'host_start': 9.0, 'host_end': 12.0},  # runs past its parent
        {'id': 4, 'parent': 1, 'host_start': 2.0, 'host_end': 3.0},
        {'id': 5, 'parent': 2, 'host_start': 7.0, 'host_end': 8.0},   # outside its parent
    ]
    assert profiling.self_times(spans, 'host') == pytest.approx(
        {0: 10.0 - 5.0 - 1.0, 1: 3.0 - 1.0, 2: 3.0, 3: 3.0, 4: 1.0, 5: 1.0})


def test_h2d_bytes(served):
    # the CPU model's inputs are already on its device: nothing is copied
    assert served[2][0]['counters'] == {'h2d_bytes': 0}
    rgb_u8, lidar = request_inputs()
    profiling.reset()
    with profiling.recording(), profiling.span('mte.serve.request'):
        meta = torch.device('meta')
        serve._upload(rgb_u8, meta)
        serve._upload(lidar, meta, torch.bfloat16)
        serve._upload(lidar, meta)
    counted = profiling.records()[0]['counters']['h2d_bytes']
    assert counted == rgb_u8.nbytes + lidar.nbytes // 2 + lidar.nbytes == B * H * W * 9


def test_serving_bit_equal_traced(served):
    off, on = served[0], served[1]
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_step_bit_equal_traced(stepped):
    (loss0, grads0, weights0), (loss1, grads1, weights1) = stepped[0], stepped[1]
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys() and weights0.keys() == weights1.keys()
    for n in grads0:
        assert torch.equal(grads0[n], grads1[n]), n
    for n in weights0:
        assert torch.equal(weights0[n], weights1[n]), n


def test_buffer_keeps_its_bound():
    profiling.reset()
    n = profiling.BUFFER // 3 + 200
    with profiling.recording():
        for _ in range(n):
            with profiling.span('mte.unit'):
                with profiling.span('mte.a'):
                    pass
                profiling.count('k', 1)
    assert len(profiling._buffer) == profiling.BUFFER
    recs = profiling.records()
    assert recs and len(recs) < n
    assert all(len(r['spans']) == 2 and r['counters'] == {'k': 1} for r in recs)
    profiling.reset()
    assert profiling.records() == []
