"""Fitted-encoder artifacts and prediction serving (port of
``repro/serving_encoders``), on one device — CUDA unless ``device="cpu"``.

* ``bundle``   — ``EncoderBundle``: atomic on-disk persistence of a fitted
  ``BrainEncoder`` in the reference's format (sharded W with bf16-as-u16
  storage, μ/σ, selected λ, config + dispatch provenance) with eager
  ``open()`` validation.
* ``registry`` — ``EncoderRegistry``: many bundles, lazy residency under a
  ``device_memory_budget`` with thread-safe LRU eviction, whole bundles or
  single weight column shards, mmap'd read-only weight reads.
* ``service``  — ``EncoderService``: fixed-shape padded MIXED waves that
  pack scored and unscored requests from any tenants together, each
  request's predictions and Pearson r bitwise equal to serving it alone;
  ``predict_columns`` serves one target-column window of a whole-brain
  bundle.
* ``traffic``  — synthetic fleets and the deterministic mixed-traffic
  trace (same digest and payloads as the reference's).
* ``fleet``    — ``ResidencyMap``, ``FleetRegistry``, ``FleetFrontend``
  (bounded admission with typed backpressure rejections) and ``replay``.

Fit once, serve many::

    enc = BrainEncoder().fit(X_train, Y_train)
    enc.save("bundles/sub-01_L12")

    reg = EncoderRegistry(device_memory_budget=512 * 2**20)
    reg.add("sub-01/L12", "bundles/sub-01_L12")
    service = EncoderService(reg, wave_buckets=(32, 128))
    out = service.serve([PredictRequest("sub-01/L12", X_new),
                         PredictRequest("sub-01/L12", X_val, targets=Y_val)])
"""
from repro_torch.serving_encoders.bundle import (  # noqa: F401
    BundleError, EncoderBundle, save_bundle,
)
from repro_torch.serving_encoders.fleet import (  # noqa: F401
    RESIDENCY_MAP, FleetError, FleetFrontend, FleetRegistry, ResidencyMap,
    WorkerLost,
)
from repro_torch.serving_encoders.registry import (  # noqa: F401
    EncoderRegistry, LoadedEncoder, RegistryError, bundle_resident_bytes,
)
from repro_torch.serving_encoders.service import (  # noqa: F401
    EncoderService, PredictRequest, PredictResult, ServiceError,
    plan_mixed_waves, reference_serve,
)
from repro_torch.serving_encoders.traffic import (  # noqa: F401
    TraceSpec, load_trace, replay_requests, save_trace, trace_digest,
)
