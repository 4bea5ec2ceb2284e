"""Tiny shapes for the CPU tests: a cell's files shrunk in memory."""

import json
import sys

H, W = 64, 96


def shrink(config, traffic):
    config['image_shape'] = [H, W]
    traffic['pool'] = min(traffic['pool'], 4)
    traffic['batch'] = 2
    traffic['check']['requests'] = min(traffic['check'].get('requests', 0), 2)


def dry_run(name, seed, trace, seconds=0.3, program='port'):
    """One run of cell ``name`` on the CPU at tiny shapes -> the result line
    as the benchmark prints it."""
    import torch
    torch.set_num_threads(2)
    from portbench.run import run_cell
    return json.dumps(run_cell(name, seed, seconds, trace, device='cpu', program=program,
                               adjust=shrink))


if __name__ == '__main__':
    # python -m portbench.tests.tiny CELL SEED TRACE: a dry run, then the
    # top-level modules it loaded, on the last two lines
    line = dry_run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    print(line)
    print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
