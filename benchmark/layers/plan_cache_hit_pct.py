"""Plan cache: the share of the window's replies that say ``cacheHit``."""


def read(ctx):
    rs = [r for r in ctx.replies if r.cache_hit is not None]
    if not rs:
        return None
    return 100.0 * sum(r.cache_hit for r in rs) / len(rs)
