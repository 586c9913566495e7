"""PyTorch/CUDA port of the coadd system, beside the JAX reference ``repro``.

Plain tensor code is torch; each TPU kernel of the reference is a kernel
written by hand for the H100 (``csrc/``).  The package imports neither JAX
nor anything of ``repro``.
"""

from repro_torch.core import (
    BANDS,
    METHODS,
    CoaddEngine,
    CoaddPlan,
    CoaddQuery,
    CoaddResult,
    JobStats,
    SpatialIndex,
    Survey,
    SurveyConfig,
    make_survey,
)

__all__ = [
    "BANDS",
    "CoaddEngine",
    "CoaddPlan",
    "CoaddQuery",
    "CoaddResult",
    "JobStats",
    "METHODS",
    "SpatialIndex",
    "Survey",
    "SurveyConfig",
    "make_survey",
]
