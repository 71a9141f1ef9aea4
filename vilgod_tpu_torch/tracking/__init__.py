from .assign import ASSIGNMENT_FNS, assign_greedy, assign_hungarian
from .kalman import kf_init, kf_predict, kf_update
from .tracker import Tracker, TrackPool

__all__ = [
    "ASSIGNMENT_FNS", "assign_greedy", "assign_hungarian",
    "kf_init", "kf_predict", "kf_update", "Tracker", "TrackPool",
]
