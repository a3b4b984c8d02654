"""Model zoo: concrete tracking-experiment models.

Mirrors the reference model zoo (``lqg/tracking/``) plus the notebook-only
hand-motion model, built on stationary specs (no time-stacked matrices).
"""

from lqg_tpu.models.basic import (
    TrackingTask,
    BoundedActor,
    OptimalActor,
    RelativeObservationBoundedActor,
)
from lqg_tpu.models.subjective import SubjectiveActor
from lqg_tpu.models.delay import (
    TemporalDelayModel,
    DelayedSubjectiveActor,
    delay_system,
)
from lqg_tpu.models.point_mass import PointMassBoundedActor
from lqg_tpu.models.hand import HandMotionModelTrackingTask
from lqg_tpu.models.signal_dep import SignalDependentNoiseActor

__all__ = [
    "TrackingTask",
    "BoundedActor",
    "OptimalActor",
    "RelativeObservationBoundedActor",
    "SubjectiveActor",
    "TemporalDelayModel",
    "DelayedSubjectiveActor",
    "delay_system",
    "PointMassBoundedActor",
    "HandMotionModelTrackingTask",
    "SignalDependentNoiseActor",
]
