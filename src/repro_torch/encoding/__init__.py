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

Observing a fit and a fleet
---------------------------
Every tier above is permanently instrumented through ``repro_torch.obs``
— spans, metrics and recompile sentinels — at no cost until you opt in
(with no tracer installed a span site is one module attribute load):

* **Tracing**: install the process-global tracer around any code::

      from repro_torch import obs
      tracer = obs.install()
      enc = BrainEncoder(device_memory_budget=1, chunk_rows=4096)
      enc.fit(store=store)            # fit.dispatch/stats/eigh/solve spans
      obs.write_trace(tracer, "fit.jsonl")    # .json → open in Perfetto
      obs.uninstall()

  ``python -m repro_torch.launch.obs_report fit.jsonl --assert-coverage
  0.95`` renders the per-phase time/bytes table and gates the share of
  the fit root attributed to its phase children.  On the card, only the
  ``fit.eigh``/``fit.solve`` spans wait for the work they enqueued, and
  only while a tracer is installed.
* **Metrics**: ``obs.snapshot()`` renders the process-global counters
  (``compiles{tier=...}``, ``bytes_staged``, ``io_retries{op=...}``,
  ``waves``, ``wave_rows``, ``tenant_rows{tenant=...}``,
  ``registry_hits``/``loads``/``evictions``, fleet admission outcomes)
  into one schema'd dict (``repro.obs/v1``).  ``stream_stats_``,
  ``ServiceStats.to_dict()`` and ``PrefetchStats.to_dict()`` carry the
  same schema marker.
* **Sentinels**: under ``REPRO_OBS_STRICT=1`` every fixed-shape contract
  (the chunked fold update, the whole-brain column-block update, the
  serving wave programs) raises ``obs.RecompileError`` at the update that
  sees a signature beyond its expectation window.

Surviving failures
------------------
``repro_torch.resilience`` makes a killed whole-brain fit resumable: pass
``journal=`` (a directory) to ``wholebrain.fit_wholebrain`` and the
X-statistics pass and every finished column block are committed to an
atomic-rename ledger; re-running the same call after a crash replays them
and streams only the rest, with λ and W bitwise equal to an uninterrupted
fit.  ``RunStore.open(root, fault_policy=FaultPolicy(...))`` retries
transient shard-read faults, and ``resilience.faultsim`` injects them
deterministically.
"""
from repro_torch.encoding import dispatch, pipeline  # noqa: F401
from repro_torch.encoding.config import EncoderConfig  # noqa: F401
from repro_torch.encoding.dispatch import DispatchDecision, resolve  # noqa: F401
from repro_torch.encoding.estimator import (  # noqa: F401
    BrainEncoder, EncodingReport, EvaluationReport,
)
