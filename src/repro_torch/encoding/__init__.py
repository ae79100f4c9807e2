"""repro_torch.encoding — the brain-encoding estimator API of the port.

    import torch
    from repro_torch.encoding import BrainEncoder, pipeline
    from repro_torch.data import fmri

    g = torch.Generator("cuda").manual_seed(0)
    X, Y, mask = fmri.generate(fmri.SubjectSpec(n=1200, p=128, t=512), g)
    state = pipeline.run(X, Y)            # detrend → split → fit → evaluate
    print(state.evaluation.mean_r, state.evaluation.significant)

Out of core, the rows live in a ``RunStore`` and stream chunk by chunk:

    from repro_torch.data.store import RunStore
    store = RunStore.open("subject-store")
    state = pipeline.run_store(store, chunk_rows=8192)  # standardize → fit
    enc = BrainEncoder(device_memory_budget=4 << 30).fit(store=store)
    print(enc.report_.decision.method, enc.stream_stats_["chunks"])

The paper's MOR baseline (one RidgeCV per target) and banded ridge (one λ
per feature band) are explicit solver choices:

    enc = BrainEncoder(solver="mor").fit(X_train, Y_train)
    enc = BrainEncoder(bands=(4096,) * 4, n_band_candidates=16)
    enc.fit(X_train, Y_train)             # dispatch → "banded"
    print(enc.report_.band_lambdas)

A saved encoder is served through ``repro_torch.serving_encoders``
(``EncoderRegistry`` → ``EncoderService``).  Everything runs on CUDA
unless ``device="cpu"`` is passed.
"""
from repro_torch.encoding import dispatch, pipeline  # noqa: F401
from repro_torch.encoding.config import EncoderConfig  # noqa: F401
from repro_torch.encoding.dispatch import DispatchDecision, resolve  # noqa: F401
from repro_torch.encoding.estimator import (  # noqa: F401
    BrainEncoder, EncodingReport, EvaluationReport,
)
