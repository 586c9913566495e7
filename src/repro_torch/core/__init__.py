"""Core of the PyTorch/CUDA port: the coadd query, brick-served templates
and transient detection.

Public API of this slice:
  CoaddQuery, BANDS, make_survey, SurveyConfig, Survey, CoaddEngine,
  CoaddResult, JobStats, METHODS, CoaddPlan, SpatialIndex, BrickGrid,
  BrickCover, MaterializeReport, DetectionCatalog, detect_sources,
  difference_image, inject_transients, match_detections, CoaddService,
  Overloaded, ServiceStats, ScanWindow, window_schedule, ResidencyManager,
  BrickStore, and the fault domain (DESIGN.md §8): ChaosInjector,
  FaultSchedule, PoisonSpec, WindowTracker, JobTracker, FailureInjector,
  FaultCounters, MapTask, BrickTask, BrickMeta, BrickSpill, DiskJournal,
  JournalStore, the fault classes and classify; multi-device jobs
  (`CoaddEngine.run_distributed`, DESIGN.md §4): MeshResidentDataset.
"""

from repro_torch.core.bricks import BrickCover, BrickGrid
from repro_torch.core.detect import (
    DetectionCatalog,
    detect_sources,
    difference_image,
    inject_transients,
    match_detections,
)
from repro_torch.core.durable import BrickSpill, DiskJournal, JournalStore
from repro_torch.core.engine import METHODS, CoaddEngine, CoaddResult, JobStats
from repro_torch.core.faults import (
    ChaosInjector,
    DeterminismError,
    FatalFault,
    FaultError,
    FaultSchedule,
    PoisonedChunkError,
    PoisonSpec,
    QueryKilled,
    TransientFault,
    classify,
)
from repro_torch.core.jobtracker import (
    BrickTask,
    FailureInjector,
    FaultCounters,
    JobTracker,
    MapTask,
    MaterializeReport,
    WindowTracker,
)
from repro_torch.core.plan import CoaddPlan, ScanWindow, window_schedule
from repro_torch.core.prefilter import SpatialIndex
from repro_torch.core.query import BANDS, CoaddQuery
from repro_torch.core.seqfile import BrickMeta, BrickStore, MeshResidentDataset, ResidencyManager
from repro_torch.core.serve import CoaddService, Overloaded, ServiceStats
from repro_torch.core.survey import Survey, SurveyConfig, make_survey

__all__ = [
    "BANDS",
    "BrickCover",
    "BrickGrid",
    "BrickMeta",
    "BrickSpill",
    "BrickStore",
    "BrickTask",
    "ChaosInjector",
    "CoaddEngine",
    "CoaddPlan",
    "CoaddQuery",
    "CoaddResult",
    "CoaddService",
    "DetectionCatalog",
    "DeterminismError",
    "DiskJournal",
    "FailureInjector",
    "FatalFault",
    "FaultCounters",
    "FaultError",
    "FaultSchedule",
    "JobStats",
    "JobTracker",
    "JournalStore",
    "METHODS",
    "MapTask",
    "MaterializeReport",
    "MeshResidentDataset",
    "Overloaded",
    "PoisonSpec",
    "PoisonedChunkError",
    "QueryKilled",
    "ResidencyManager",
    "ScanWindow",
    "ServiceStats",
    "SpatialIndex",
    "Survey",
    "SurveyConfig",
    "TransientFault",
    "WindowTracker",
    "classify",
    "detect_sources",
    "difference_image",
    "inject_transients",
    "make_survey",
    "match_detections",
    "window_schedule",
]
