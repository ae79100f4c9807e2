"""``fit_mfu.store`` (%, moves ``fit_s.store``): the counted operations of
a fit fed from a run store (the cell's ``counts/<fit_count>.py``) over
the traced fit's seconds and the card's bf16 dense peak. bf16 because an
f32-accurate product on the tensor cores reaches at most a fraction of
it, so no implementation can pass 100%."""


def read(ctx):
    if ctx.peaks is None:
        return None
    c = ctx.config
    flops = ctx.count(ctx.cell["fit_count"]).flops(
        n=c["n"], p=c["p"], t=c["t"], k=c["n_folds"], r=len(c["lambdas"]))
    return 100.0 * flops / (ctx.fit_s * ctx.peaks["bf16_flops"])
