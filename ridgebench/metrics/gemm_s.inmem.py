"""``gemm_s.inmem`` (s, moves ``fit_s.inmem``): device time a fit from
arrays resident on the card of the kernels launched under an ``aten``
matrix product outside ``eigh``: the scoring, projection and refit
products."""


def read(ctx):
    sec = ctx.trace.layers.get("products", 0.0)
    return sec / len(ctx.fits) if sec > 0 else None
