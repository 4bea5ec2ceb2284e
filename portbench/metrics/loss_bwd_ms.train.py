"""Device ms per step outside the network's forward and the optimizer:
the losses, the backward and the step's own launches, as the step's
event span less the two, in the same steps."""


def read(ctx):
    if ctx['kind'] != 'train':
        return None
    rows = [r['unit'] - r['network_fwd'] - r['optimizer'] for r in ctx.get('spans', [])
            if 'network_fwd' in r and 'optimizer' in r]
    return sum(rows) / len(rows) if rows else None
