"""``xty_folds_masked_roofline`` (%): the streamed fold statistics' least
time on the card over the device time of the split-bf16 engine's
kernels a fit, in a cell whose fit streams its rows through
``xty_folds_masked``.  The count (``counts/xty_folds.py``) is the work of
the rows each fold owns; the kernel computes every slot over every row
of a chunk, and its padded rows, so this share shows that waste."""


def read(ctx):
    sec = ctx.trace.layers.get("fold statistics", 0.0) / len(ctx.fits)
    if sec <= 0 or ctx.peaks is None:
        return None
    c = ctx.config
    cnt = ctx.count("xty_folds")
    sizes = dict(n=c["n"], p=c["p"], t=c["t"], k=c["n_folds"])
    bound = max(cnt.flops(**sizes) / ctx.peaks["bf16_flops"],
                cnt.bytes(**sizes) / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / sec
