"""Images trained in the window, over the window's seconds, which end in a
synchronize of the device (host clock)."""


def read(ctx):
    if ctx['kind'] != 'train':
        return None
    return ctx['units'] * ctx['images_per_unit'] / ctx['window_s']
