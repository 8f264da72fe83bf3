"""Workflow execution metrics: per-stage timing/row collection.

The port's copy of ``transmogrifai_tpu/utils/listener.py`` (reference
OpSparkListener, utils/src/main/scala/com/salesforce/op/utils/spark/
OpSparkListener.scala:56,136,164): the prepare plan reports each stage's
fit/transform wall time and row count to an attached listener;
``AppMetrics`` aggregates per run, and ``AppMetrics.fault_events`` holds
the runtime's events of the run (retries, quarantines, journal resumes:
``runtime/telemetry.py``).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_log = logging.getLogger(__name__)

__all__ = ["StageMetric", "AppMetrics", "WorkflowListener"]


@dataclass
class StageMetric:
    """(reference StageMetrics, OpSparkListener.scala:164)

    ``compile_seconds`` is the ``nvcc`` build time of the port's kernels
    (``_build.py``) spent while the stage ran: first-use cost that a
    process with its kernels built never pays again (the JAX package's
    XLA compile time, which the field holds there, has no counterpart in
    eager torch ops). ``execute_seconds`` is the remainder; a device
    stage's seconds end in a synchronize."""
    stage_name: str
    stage_uid: str
    phase: str             # "fit" | "transform"
    seconds: float
    n_rows: int
    compile_seconds: float = 0.0

    @property
    def execute_seconds(self) -> float:
        return max(0.0, self.seconds - self.compile_seconds)

    def to_json(self) -> dict:
        return {"stageName": self.stage_name, "stageUid": self.stage_uid,
                "phase": self.phase, "seconds": round(self.seconds, 6),
                "compileSeconds": round(self.compile_seconds, 6),
                "executeSeconds": round(self.execute_seconds, 6),
                "nRows": self.n_rows}


@dataclass
class AppMetrics:
    """(reference AppMetrics, OpSparkListener.scala:136)"""
    app_name: str = "transmogrifai_tpu"
    custom_tag_name: Optional[str] = None
    custom_tag_value: Optional[str] = None
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    stage_metrics: List[StageMetric] = field(default_factory=list)
    #: fault-runtime events observed during this run (retries,
    #: quarantines, journal resumes, plan fallbacks: runtime/
    #: telemetry.py); empty, and absent from the JSON, on a fault-free
    #: run
    fault_events: List[Dict] = field(default_factory=list)

    @property
    def app_duration(self) -> float:
        end = self.end_time if self.end_time is not None else time.time()
        return end - self.start_time

    def to_json(self) -> dict:
        out = {"appName": self.app_name,
               "customTagName": self.custom_tag_name,
               "customTagValue": self.custom_tag_value,
               "appDurationSeconds": round(self.app_duration, 3),
               "stageMetrics": [m.to_json() for m in self.stage_metrics]}
        if self.fault_events:
            out["faultEvents"] = self.fault_events
        return out

    def profile_pretty(self, top: int = 0) -> str:
        """Human per-stage profile, slowest first — the role of the
        reference's Spark-UI stage table (aux SURVEY §5.5); rendered
        with the same Table util summaryPretty uses."""
        from .table import Table
        rows = sorted(self.stage_metrics, key=lambda m: -m.seconds)
        if top:
            rows = rows[:top]
        total = sum(m.seconds for m in self.stage_metrics) or 1.0
        t = Table(
            ["stage", "phase", "seconds", "compile", "execute",
             "% of total", "rows"],
            [[m.stage_name, m.phase, f"{m.seconds:.3f}",
              f"{m.compile_seconds:.3f}", f"{m.execute_seconds:.3f}",
              f"{100.0 * m.seconds / total:.1f}%", m.n_rows]
             for m in rows],
            name=f"Stage profile ({self.app_name}, "
                 f"{self.app_duration:.2f}s wall)")
        return t.pretty()


class WorkflowListener:
    """Attach via ``Workflow.with_listener`` to collect per-stage metrics
    (reference collectStageMetrics / logStageMetrics, OpParams.scala:94)."""

    def __init__(self, log_stage_metrics: bool = False,
                 collect_stage_metrics: bool = True,
                 app_name: str = "transmogrifai_tpu"):
        self.log_stage_metrics = log_stage_metrics
        self.collect_stage_metrics = collect_stage_metrics
        self.metrics = AppMetrics(app_name=app_name)
        self._end_handlers: List[Callable[[AppMetrics], None]] = []
        # fault-runtime events after this mark belong to this run
        from ..runtime import telemetry as _rt
        self._fault_mark = _rt.events_mark()

    def on_stage_completed(self, stage, phase: str, seconds: float,
                           n_rows: int,
                           compile_seconds: float = 0.0) -> None:
        m = StageMetric(stage_name=stage.stage_name(), stage_uid=stage.uid,
                        phase=phase, seconds=seconds, n_rows=n_rows,
                        compile_seconds=min(compile_seconds, seconds))
        if self.collect_stage_metrics:
            self.metrics.stage_metrics.append(m)
        if self.log_stage_metrics:
            _log.info("stage %s %s: %.3fs over %d rows",
                      m.stage_name, phase, seconds, n_rows)

    def add_application_end_handler(
            self, fn: Callable[[AppMetrics], None]) -> None:
        """(reference OpWorkflowRunner.addApplicationEndHandler:145)"""
        self._end_handlers.append(fn)

    def on_application_end(self) -> None:
        self.metrics.end_time = time.time()
        # the runtime's events of this run, beside its stage profile
        from ..runtime import telemetry as _rt
        self.metrics.fault_events = _rt.events_since(self._fault_mark)
        for fn in self._end_handlers:
            try:
                fn(self.metrics)
            except Exception:  # handlers must not break the run
                _log.exception("application-end handler failed")
