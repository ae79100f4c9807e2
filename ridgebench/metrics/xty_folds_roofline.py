"""``xty_folds_roofline`` (%): the fold statistics' least time on the card
(``counts/xty_folds.py``: the larger of operations over the bf16 dense
peak and bytes over the memory bandwidth) over the device time of the
split-bf16 engine's kernels a fit, in a cell whose fit computes them in
memory with ``xty_folds``."""


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
