"""SQL server and admission: the mean, over the window's replies, of the
client's latency less the reply's own ``durationMs`` (the HTTP round
trip, the server's queue and admission, the JSON reply)."""


def read(ctx):
    rs = [r for r in ctx.replies if r.duration_ms is not None]
    if not rs:
        return None
    return sum(r.latency_ms - r.duration_ms for r in rs) / len(rs)
