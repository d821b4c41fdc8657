"""Session to result: the mean of the replies' ``durationMs``, the
server's own timing of a statement from ``session.sql`` through the
plan cache, planner, stage-cache replay and read-back to its JSON rows."""


def read(ctx):
    rs = [r.duration_ms for r in ctx.replies if r.duration_ms is not None]
    return sum(rs) / len(rs) if rs else None
