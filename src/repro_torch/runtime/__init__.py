"""Runtime support shared by the campaign fabric: retry/backoff schedules,
heartbeats, straggler detection, preemption and recoverable steps
(``repro_torch.runtime.fault_tolerance``)."""

from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 PreemptionHandler,
                                                 RetryPolicy,
                                                 StragglerDetector,
                                                 recoverable_step)

__all__ = ["HeartbeatMonitor", "PreemptionHandler", "RetryPolicy",
           "StragglerDetector", "recoverable_step"]
