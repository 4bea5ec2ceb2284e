"""Images whose results reached the host in the window, over the window's
seconds, which end when the last of them arrives (host clock)."""


def read(ctx):
    if ctx['kind'] != 'infer':
        return None
    return ctx['units'] * ctx['images_per_unit'] / ctx['window_s']
