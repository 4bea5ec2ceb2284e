"""``torch.cuda.max_memory_allocated`` over the window, reset after the
warm-up so that cuDNN's autotuning workspace does not count, in GiB."""


def read(ctx):
    if ctx['kind'] != 'train' or not ctx['window_peak_bytes']:
        return None
    return ctx['window_peak_bytes'] / 2 ** 30
