"""LM serving: the wave engine and its token sampler (port of
``repro/serving``)."""
from repro_torch.serving.engine import (  # noqa: F401
    ServeEngine, ServeRequest, ServeResult,
)
from repro_torch.serving.sampler import SamplerConfig, sample  # noqa: F401
