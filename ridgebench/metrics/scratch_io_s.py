"""``scratch_io_s`` (s): the program's own ``scratch_io_s`` a fit, the host
seconds of the whole-brain fit's ``Â`` scratch (its creation, block
writes, flush, read-back and removal: the ``wholebrain.scratch_*``
spans), from ``BrainEncoder.stream_stats_``, host clock."""


def read(ctx):
    secs = [r.stream["scratch_io_s"] for r in ctx.fits
            if r.stream is not None and "scratch_io_s" in r.stream]
    if not secs or len(secs) != len(ctx.fits):
        return None
    return sum(secs) / len(secs)
