"""``store_stall_s`` (s): the program's own ``read_stall_s`` a fit, the
time the fit waited on the run store's prefetcher for a chunk
(``BrainEncoder.stream_stats_``, host clock)."""


def read(ctx):
    stalls = [r.stream["read_stall_s"] for r in ctx.fits
              if r.stream is not None and "read_stall_s" in r.stream]
    if len(stalls) != len(ctx.fits):
        return None
    return sum(stalls) / len(stalls)
