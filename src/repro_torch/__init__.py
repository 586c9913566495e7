"""PyTorch/CUDA port of the coadd system, beside the JAX reference ``repro``.

Plain tensor code is torch; each TPU kernel of the reference is a kernel
written by hand for the H100 (``csrc/``).  The package imports neither JAX
nor anything of ``repro``.
"""

from repro_torch.core import (
    BANDS,
    METHODS,
    BrickCover,
    BrickGrid,
    CoaddEngine,
    CoaddPlan,
    CoaddQuery,
    CoaddResult,
    CoaddService,
    DetectionCatalog,
    JobStats,
    MaterializeReport,
    MeshResidentDataset,
    Overloaded,
    ServiceStats,
    SpatialIndex,
    Survey,
    SurveyConfig,
    detect_sources,
    difference_image,
    inject_transients,
    make_survey,
    match_detections,
)
from repro_torch.launch.mesh import make_mesh, run_ranks

__all__ = [
    "BANDS",
    "BrickCover",
    "BrickGrid",
    "CoaddEngine",
    "CoaddPlan",
    "CoaddQuery",
    "CoaddResult",
    "CoaddService",
    "DetectionCatalog",
    "JobStats",
    "METHODS",
    "MaterializeReport",
    "MeshResidentDataset",
    "Overloaded",
    "ServiceStats",
    "SpatialIndex",
    "Survey",
    "SurveyConfig",
    "detect_sources",
    "difference_image",
    "inject_transients",
    "make_mesh",
    "make_survey",
    "match_detections",
    "run_ranks",
]
