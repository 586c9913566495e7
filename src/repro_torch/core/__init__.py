"""Core of the PyTorch/CUDA port: the weighted-mean coadd query, end to end.

Public API of this slice:
  CoaddQuery, BANDS, make_survey, SurveyConfig, Survey, CoaddEngine,
  CoaddResult, JobStats, METHODS, CoaddPlan, SpatialIndex.
"""

from repro_torch.core.engine import METHODS, CoaddEngine, CoaddResult, JobStats
from repro_torch.core.plan import CoaddPlan
from repro_torch.core.prefilter import SpatialIndex
from repro_torch.core.query import BANDS, CoaddQuery
from repro_torch.core.survey import Survey, SurveyConfig, make_survey

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
