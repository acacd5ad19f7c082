"""The roofline of the port's steps on the H100, the counterpart of
``repro.roofline``: counts taken while a step runs (``counting``), their
three-term roofline (``analysis``), the layer-count probe (``probe``) and
the report (``report``)."""

from repro_torch.roofline.analysis import HW_H100, RooflineTerms, analyze_step
from repro_torch.roofline.counting import CollectiveTally, StepCounts, count_step

__all__ = ["CollectiveTally", "HW_H100", "RooflineTerms", "StepCounts", "analyze_step",
           "count_step"]
