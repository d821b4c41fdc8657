"""Stage cache: entries built inside the window, the rise of the
program's ``stage_cache_misses`` gauge between its open and its close.
Every text is built and captured in set-up, so a build here is an
eviction, a variant or a key that did not repeat."""


def read(ctx):
    return ctx.after["stage_cache_misses"] - ctx.before["stage_cache_misses"]
