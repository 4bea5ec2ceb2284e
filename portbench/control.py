"""Readings of a cell's compared numbers over many seeds in one process:
the program's (``--program port``), the control's (``control``: the
reference put in the program's place, in the precision below the
configuration's) or a planted fault's (``half_batch``: a training step on
half of each batch; ``half_loss``: the passes on the whole batch, the
losses' mean over its first half).  The benchmark's own runs never run
this.

    python3 -m portbench.control --workload <cell> --program port control --seeds 1 2 3 [--seconds 3]

Inference cells run a short window at the cell's load, long enough to
answer as many requests as a run compares; training cells need none.
Prints one JSON line per program and seed and, for each program, a line
with each number's largest and smallest reading.
"""

import argparse
import json
import sys
import time

import torch

from portbench.common import HERE, cell_files, load_module, release
from portbench.run import run_cell


def readings(name, seed, program, seconds):
    _, config, traffic = cell_files(name)
    if traffic['entry'] == 'train':
        entry = load_module(HERE / 'entries' / 'train.py')
        cell = entry.Cell(config, traffic, seed, 'cuda', program)
        numbers = cell.check()
        del cell
    else:
        result = run_cell(name, seed, seconds, 0, 'cuda', program)
        numbers = dict(result['readings'], **{k: c['value'] for k, c in result['checks'].items()})
    release('cuda')
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--program', nargs='+', default=['control'],
                    choices=('port', 'control', 'half_batch', 'half_loss'))
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('portbench.control: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cudnn.benchmark = True     # as the program's set-up turns it on
    for program in args.program:
        rows = []
        for seed in args.seeds:
            t0 = time.perf_counter()
            numbers = readings(args.workload, seed, program, args.seconds)
            rows.append(numbers)
            print(json.dumps({'workload': args.workload, 'program': program, 'seed': seed,
                              'numbers': numbers, 'seconds': time.perf_counter() - t0}),
                  flush=True)
        print(json.dumps({'workload': args.workload, 'program': program, 'seeds': args.seeds,
                          'max': {k: max(r[k] for r in rows) for k in rows[0]},
                          'min': {k: min(r[k] for r in rows) for k in rows[0]}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
