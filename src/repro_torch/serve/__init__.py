"""Serving tier: the persistent multi-tenant extraction service
(``service``: cross-tenant window fusion, deadlines, backpressure)."""
from repro_torch.serve.service import (  # noqa: F401  (re-exports)
    DeadlineExceeded,
    ExtractionService,
    ServeFuture,
    ServeResult,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    estimate_case_bytes,
)
