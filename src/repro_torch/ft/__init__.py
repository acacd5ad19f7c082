from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.ft.preemption import PreemptionHandler

__all__ = ["StepWatchdog", "PreemptionHandler"]
