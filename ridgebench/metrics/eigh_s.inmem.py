"""``eigh_s.inmem`` (s, moves ``fit_s.inmem``): device time a fit from
arrays resident on the card of the kernels launched under
``aten::linalg_eigh`` (cuSOLVER): the factorisation layer."""


def read(ctx):
    sec = ctx.trace.layers.get("factorisation", 0.0)
    return sec / len(ctx.fits) if sec > 0 else None
