"""Device: the share of the profiled sub-window in which no kernel, copy
or fill ran, from the union of the card's device records; on several
cards the mean over the cards."""


def read(ctx):
    info = ctx.trace
    if info is None or not info.device or info.window_us <= 0:
        return None
    busy = sum(info.busy_us(c) for c in info.device) / len(info.device)
    return 100.0 * (1.0 - busy / info.window_us)
