"""PreparePlan: train-time feature engineering on the workflow's device.

Counterpart of ``transmogrifai_tpu/plans/prepare.py``. ``Workflow.train``
walks the feature DAG with it so that the training matrix is born on the
device the selector search runs on: the selector receives the combined
feature vector as a tensor there, and its row gathers, validation folds
and family searches consume it without a copy through the host.

Execution model:

1. Stages are walked in topological order.
2. Estimators fit on host columns, as the JAX package's plan fits them
   (the vectorizers' vocabularies, means and modes are host statistics).
   An input column that a device stage produced is copied to the host for
   the fit, and ``fit_placements`` records it. Predictors (the selector)
   take their feature matrix as the device tensor it is.
3. A transformer (or fitted model) whose ``transform_arrays`` kernel
   applies runs it as torch ops on the device: inputs produced on the
   device pass through; host columns go through the stage's
   ``encode_input_column`` and are copied up once. Its output column keeps
   the tensor, with the metadata of a zero-row run of the stage's numpy
   path. The transform runs behind the runtime retry policy (a transient
   error retries with backoff), with the drill site
   ``prepare:device:dispatch`` (``runtime/faults.py``).
4. Any other stage runs its host ``transform_columns``, and ``coverage``
   records it with the reason. A kernel that raises propagates: it is
   never demoted to the host path. The one demotion is a drill: an
   injected ``prepare:<Stage>:compile`` fault sends the stage to its host
   transform with the fault as its reason, as in the JAX plan.
5. An attached listener (``utils/listener.py``) receives every fit and
   transform with its seconds and row count, as from the JAX plan; a
   device transform's seconds end in a synchronize.

Unlike the JAX plan there are no fused segments, row buckets or compile
caches: each kernel is a few eager torch ops over the whole dataset.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..features.columns import Dataset, FeatureColumn, host_column
from ..features.feature import Feature, topo_layers
from ..features.generator import FeatureGeneratorStage
from ..runtime.faults import maybe_inject
from ..runtime.retry import RetryPolicy
from ..stages.base import Estimator, PipelineStage, Transformer
from ..types import Prediction
from ..utils.device import resolve_device, working_dtype
from .common import PlanCoverage, empty_raw_dataset, lowering_reason, \
    probe_stage

__all__ = ["PreparePlan"]


def raw_features(result_features: Sequence[Feature]) -> List[Feature]:
    """The distinct raw features of ``result_features``, by name."""
    uniq: Dict[str, Feature] = {}
    for rf in result_features:
        for f in rf.raw_features():
            uniq.setdefault(f.uid, f)
    return sorted(uniq.values(), key=lambda f: f.name)


class PreparePlan:
    """Fit and transform a feature DAG with its device stages on
    ``device`` (default the CUDA card; raises without one). One instance
    per ``train()``.

    >>> plan = PreparePlan(result_features, device="cuda",
    ...                    listener=WorkflowListener())
    >>> train_ds, fitted = plan.execute(raw_ds)
    """

    def __init__(self, result_features: Sequence[Feature], device="cuda",
                 listener=None):
        self.result_features = tuple(result_features)
        self.device = resolve_device(device)
        self.listener = listener
        self.dtype = working_dtype(self.device)
        self.coverage = PlanCoverage()
        #: [(stage label, "host"|"device", reason)] fit placements: a
        #: predictor fits on the device tensor it is given, every other
        #: estimator on host columns
        self.fit_placements: List[Tuple[str, str, str]] = []
        #: host seconds of each estimator fit, by stage label
        self.fit_seconds: Dict[str, float] = {}
        #: seconds of device transforms (host encoding, copies up and
        #: the stage's torch ops, synchronized on a card)
        self.device_transform_seconds = 0.0
        #: seconds of host transform_columns stages
        self.host_transform_seconds = 0.0
        #: bytes of host columns copied up to the device
        self.bytes_to_device = 0
        self._retry = RetryPolicy.from_env()

    # -- public ------------------------------------------------------------
    def execute(self, ds: Dataset,
                prefitted: Optional[Dict[str, PipelineStage]] = None
                ) -> Tuple[Dataset, Dict[str, PipelineStage]]:
        """Fit every estimator and materialize every stage output over
        ``ds``: returns the transformed Dataset (device columns hold
        tensors) and the fitted models by estimator uid. ``prefitted``
        supplies models already fitted on THIS dataset (the workflow-CV
        pre-pass), which are not fitted again."""
        stages = [s for layer in topo_layers(list(self.result_features))
                  for s in layer
                  if not isinstance(s, FeatureGeneratorStage)]
        raw = raw_features(self.result_features)
        self._proto = empty_raw_dataset(raw)
        self._producer: Dict[str, str] = {f.name: "host" for f in raw}
        self._uploads: Dict[str, torch.Tensor] = {}
        fitted: Dict[str, PipelineStage] = {}
        for stage in stages:
            out_name = stage.get_output().name
            if isinstance(stage, Estimator):
                model = (prefitted or {}).get(stage.uid)
                if model is None:
                    model = self._fit(stage, ds)
                fitted[stage.uid] = model
                ds = self._transform(model, out_name, ds)
            elif isinstance(stage, Transformer):
                ds = self._transform(stage, out_name, ds)
            else:
                raise TypeError(f"Cannot execute stage {stage!r}")
        return ds, fitted

    def describe(self) -> dict:
        """Plan summary for logs and the smoke's report."""
        return {
            "coverage": self.coverage.to_json(),
            "fit_placements": [list(p) for p in self.fit_placements],
            "fit_seconds": self.fit_seconds,
            "device_transform_seconds": self.device_transform_seconds,
            "host_transform_seconds": self.host_transform_seconds,
            "bytes_to_device": self.bytes_to_device,
        }

    # -- fits --------------------------------------------------------------
    def _fit(self, stage: Estimator, ds: Dataset) -> PipelineStage:
        names = [f.name for f in stage.input_features]
        on_device = [n for n in names if ds[n].on_device]
        where, reason = "host", "inputs host-resident"
        if on_device and stage.device_inputs:
            where, reason = "device", "fits on the device tensor it is given"
        elif on_device:
            reason = f"host fit; inputs copied from the device: {on_device}"
            ds = ds.select(names)
            for n in on_device:
                ds = ds.with_column(n, host_column(ds[n]))
        label = f"{type(stage).__name__}({stage.uid})"
        self.fit_placements.append((label, where, reason))
        # a stage that fits on its workflow's device and was given none
        handed = getattr(stage, "takes_plan_device", False) and \
            stage.device is None
        if handed:
            stage.device = self.device
        t0, b0 = time.perf_counter(), _build.build_seconds()
        try:
            model = stage.fit(ds)
        finally:
            if handed:
                stage.device = None
        self.fit_seconds[label] = time.perf_counter() - t0
        self._report(stage, "fit", self.fit_seconds[label], ds.n_rows, b0)
        return model

    def _report(self, stage: PipelineStage, phase: str, seconds: float,
                n_rows: int, build0: float) -> None:
        """One listener row; ``build0`` is the kernels' build seconds
        when the stage started."""
        if self.listener is not None:
            self.listener.on_stage_completed(
                stage, phase, seconds, n_rows,
                compile_seconds=_build.build_seconds() - build0)

    # -- transforms --------------------------------------------------------
    def _transform(self, stage: Transformer, out_name: str,
                   ds: Dataset) -> Dataset:
        in_names = tuple(f.name for f in stage.input_features)
        if issubclass(stage.static_output_type(), Prediction):
            reason = ("the prediction column assembles on the host from "
                      "the model's device predictions")
        else:
            reason = lowering_reason(stage, in_names, self._producer,
                                     lambda n: self._proto[n])
        label = f"{type(stage).__name__}({out_name})"
        if not reason:
            # drill site: an injected compile fault demotes the stage to
            # its host transform with the recorded reason
            try:
                maybe_inject("prepare", type(stage).__name__, "compile")
            except Exception as e:
                reason = (f"injected compile fault: {type(e).__name__}: "
                          f"{e}")
        if not reason:
            self._proto = probe_stage(stage, self._proto, out_name)
            t0, b0 = time.perf_counter(), _build.build_seconds()
            arrays = [self._device_input(stage, i, ds[n], n)
                      for i, n in enumerate(in_names)]
            out = self._dispatch(stage, arrays)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
            self.device_transform_seconds += wall
            self._report(stage, "transform", wall, ds.n_rows, b0)
            proto = self._proto[out_name]
            data = out if proto.kind == "vector" else out.reshape(-1)
            col = FeatureColumn(proto.ftype, data, proto.metadata)
            self._producer[out_name] = "device"
            self.coverage.lowered.append(label)
            return ds.with_column(out_name, col)
        cols = [ds[n] if stage.device_inputs else host_column(ds[n])
                for n in in_names]
        pulled = [n for n, c in zip(in_names, cols) if c is not ds[n]]
        if pulled:
            reason += f"; inputs copied from the device: {pulled}"
        t0, b0 = time.perf_counter(), _build.build_seconds()
        col = stage.transform_columns(cols)
        wall = time.perf_counter() - t0
        self.host_transform_seconds += wall
        self._report(stage, "transform", wall, ds.n_rows, b0)
        self._proto = self._proto.with_column(
            out_name, col.take(np.zeros(0, dtype=np.int64)))
        self._producer[out_name] = "host"
        self.coverage.fallback.append((label, reason))
        return ds.with_column(out_name, col)

    def _dispatch(self, stage: Transformer, arrays) -> torch.Tensor:
        """One stage's device transform behind the runtime retry policy
        (a transient error backs off and retries; others propagate, and
        the selector's quarantine sits above), with the drill site
        ``prepare:device:dispatch``."""
        def attempt():
            maybe_inject("prepare", "device", "dispatch")
            return stage.transform_arrays(arrays)

        return self._retry.call(attempt, description="prepare-dispatch")

    def _device_input(self, stage: Transformer, i: int, col: FeatureColumn,
                      name: str) -> torch.Tensor:
        """Input slot ``i`` as a tensor on the device: a device column as it
        is; a host column through the stage's encoder, copied up (floats
        in the working dtype; an identity encoding once per column)."""
        if col.on_device:
            return col.data
        shared = not stage.encodes_input(i)
        if shared and name in self._uploads:
            return self._uploads[name]
        arr = np.asarray(stage.encode_input_column(i, col))
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32 if self.dtype == torch.float32
                             else np.float64, copy=False)
        self.bytes_to_device += arr.nbytes
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if shared:
            self._uploads[name] = t
        return t
