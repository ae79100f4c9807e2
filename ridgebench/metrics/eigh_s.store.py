"""``eigh_s.store`` (s, moves ``fit_s.store``): device time a fit fed from
a run store of the kernels launched under ``aten::linalg_eigh``
(cuSOLVER): the factorisation layer."""


def read(ctx):
    sec = ctx.trace.layers.get("factorisation", 0.0)
    return sec / len(ctx.fits) if sec > 0 else None
