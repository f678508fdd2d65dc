"""Serving: quantize-once weight packing, the lockstep engine, and the
continuous-batching engine with its host-side scheduler, prefix cache,
metrics and workload generator."""
from repro_torch.serve import packing  # noqa: F401
from repro_torch.serve.engine import (ContinuousEngine, Engine,  # noqa: F401
                                      ServeConfig)
from repro_torch.serve.metrics import (MetricsRecorder,  # noqa: F401
                                       percentile)
from repro_torch.serve.packing import (pack_model_params,  # noqa: F401
                                       weight_store_bytes)
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serve.scheduler import (PagePool, Request,  # noqa: F401
                                         Scheduler)
from repro_torch.serve.workload import (TenantSpec,  # noqa: F401
                                        WorkloadConfig, WorkloadEvent,
                                        as_requests, generate_workload,
                                        trace_fingerprint)
