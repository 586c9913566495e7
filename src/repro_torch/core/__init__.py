"""Core of the PyTorch/CUDA port: the coadd query, brick-served templates
and transient detection.

Public API of this slice:
  CoaddQuery, BANDS, make_survey, SurveyConfig, Survey, CoaddEngine,
  CoaddResult, JobStats, METHODS, CoaddPlan, SpatialIndex, BrickGrid,
  BrickCover, MaterializeReport, DetectionCatalog, detect_sources,
  difference_image, inject_transients, match_detections, CoaddService,
  Overloaded, ServiceStats, ScanWindow, window_schedule, ResidencyManager,
  BrickStore.
"""

from repro_torch.core.bricks import BrickCover, BrickGrid
from repro_torch.core.detect import (
    DetectionCatalog,
    detect_sources,
    difference_image,
    inject_transients,
    match_detections,
)
from repro_torch.core.engine import METHODS, CoaddEngine, CoaddResult, JobStats
from repro_torch.core.jobtracker import MaterializeReport
from repro_torch.core.plan import CoaddPlan, ScanWindow, window_schedule
from repro_torch.core.prefilter import SpatialIndex
from repro_torch.core.query import BANDS, CoaddQuery
from repro_torch.core.seqfile import BrickStore, ResidencyManager
from repro_torch.core.serve import CoaddService, Overloaded, ServiceStats
from repro_torch.core.survey import Survey, SurveyConfig, make_survey

__all__ = [
    "BANDS",
    "BrickCover",
    "BrickGrid",
    "BrickStore",
    "CoaddEngine",
    "CoaddPlan",
    "CoaddQuery",
    "CoaddResult",
    "CoaddService",
    "DetectionCatalog",
    "JobStats",
    "METHODS",
    "MaterializeReport",
    "Overloaded",
    "ResidencyManager",
    "ScanWindow",
    "ServiceStats",
    "SpatialIndex",
    "Survey",
    "SurveyConfig",
    "detect_sources",
    "difference_image",
    "inject_transients",
    "make_survey",
    "match_detections",
    "window_schedule",
]
