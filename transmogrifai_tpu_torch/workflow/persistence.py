"""Workflow-model persistence: save/load a fitted DAG.

The port's copy of ``transmogrifai_tpu/workflow/persistence.py`` (reference
model writer/reader, core/src/main/scala/com/salesforce/op/
{OpWorkflowModelWriter.scala:52-123, OpWorkflowModelReader.scala} and the
stage writer/reader features/.../stages/{OpPipelineStageWriter.scala:78-120,
OpPipelineStageReader.scala:89-135}), with the JAX package's directory
layout:

- ``op-model.json`` — result-feature uids, the full feature DAG (uids,
  types, parent links), and every stage's class name + ctor args (the
  ``_ctor_args`` record taken at construction, ``stages/base.py``), with
  the ``$array``, ``$seq``, ``$dict``, ``$stage``, ``$selsummary``,
  ``$ftype``, ``$vmeta`` and ``$fn`` encodings (and ``$aggregator``,
  below);
- ``arrays.npz`` — every array referenced from ctor args (model
  coefficients, tree heaps, …), keyed ``<stage-uid>/<path>``.

A save is device-free: a tensor argument is written as the numpy copy of
its values, and a ``device`` argument (or any ``torch.device`` or
``torch.dtype`` value) is not written. ``load_model(path, device)`` hands
``device`` to every stage class whose ``__init__`` takes one, so one
directory reloads on the card or on the CPU. A model trained on the card
saves float32 arrays; reloaded on the CPU, they become float64 copies of
those values.

Functions (``extract_fn`` of raw-feature generators, ``fn`` of lambda
transformers) round-trip only when importable (``module:qualname``);
otherwise they are dropped and the generator falls back to by-name lookup;
a ``LambdaTransformer`` whose function was dropped raises on load.

A raw feature's monoid aggregator (``features/aggregators.py``, which the
aggregate readers use) is written as ``{"$aggregator": <class>, "args":
...}``, so that a model trained through an aggregate reader saves and
reloads; the JAX package cannot save such a model.

The raw feature filter's results and the blacklisted raw features' names
are saved as the JAX package saves them (``rawFeatureFilterResults``,
``blacklistedFeatureNames``). A fitted SanityChecker saves its constructor
arguments (the kept indices and the output metadata), as there; its
summary stays in memory.

The training data's drift fingerprints (``drift-fingerprints.json``,
``serving/sentinel.py``) are written beside them, as the JAX package
writes them, and a saved or loaded model remembers its directory
(``model_dir``), where the serving sentinel reads them. Two parts of a JAX save have no
meaning for torch and are left out: the AOT export of the compiled XLA
scoring programs and the plan-fingerprint sidecar of the HLO auditor. The
save's crash site ``workflow:save:save`` (``runtime/faults.py``) sits
between the fingerprints and ``arrays.npz``: a kill there leaves the
staging directory and the target untouched.
"""
from __future__ import annotations

import importlib
import inspect
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, stage_class_by_name
from ..types.base import feature_type_by_name
from ..utils.device import resolve_device
from ..utils.vector_meta import VectorMetadata

__all__ = ["save_model", "load_model", "stage_to_json", "stage_from_json",
           "encode_value", "decode_value", "resolve_importable_fn",
           "MODEL_FORMAT_VERSION"]

MODEL_JSON = "op-model.json"
ARRAYS_NPZ = "arrays.npz"
#: the JAX package's format: $stage/$selsummary nested encodings;
#: readers reject formats newer than this instead of mis-decoding them
MODEL_FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# value encoding (replaces reference AnyValueTypes,
# OpPipelineStageReadWriteShared.scala)
# ---------------------------------------------------------------------------

def resolve_importable_fn(fn) -> Optional[str]:
    """``"module:qualname"`` for a function another process can
    re-import, else None. Functions defined in a script run as
    ``__main__`` are re-resolved through the script's module name —
    a recorded ``__main__:f`` would import the LOADER's main module."""
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", "")
    if not (mod and qual) or "<" in qual:
        return None
    if mod != "__main__":
        return f"{mod}:{qual}"
    import importlib.util
    import sys as _sys
    main = _sys.modules.get("__main__")
    main_spec = getattr(main, "__spec__", None)
    if main_spec is not None and main_spec.name:
        # run with ``python -m pkg.mod``: the module's importable name
        return f"{main_spec.name}:{qual}"
    f = getattr(main, "__file__", None)
    stem = os.path.splitext(os.path.basename(f))[0] if f else None
    if not stem:
        return None
    # resolve without importing (that would re-run the script), and only
    # when the name leads back to the running script
    try:
        spec = importlib.util.find_spec(stem)
    except (ImportError, ValueError, AttributeError):
        return None
    if spec is None or not spec.origin:
        return None
    if os.path.abspath(spec.origin) != os.path.abspath(f):
        return None
    return f"{stem}:{qual}"


def _jsonify(v: Any) -> Any:
    """Pure-JSON copy of a nested dict/list payload: numpy scalars to
    python scalars, arrays to lists."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {(k.item() if isinstance(k, np.generic) else k):
                _jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify(x) for x in v]
    return v


def _device_arg(name: str, v: Any) -> bool:
    """Whether a ctor argument says where or in what type a stage
    computes: such arguments are not saved."""
    return name == "device" or isinstance(v, (torch.device, torch.dtype))


def encode_value(v: Any, arrays: Dict[str, np.ndarray], key: str) -> Any:
    """JSON-safe encoding; arrays (and tensors, copied to the host) are
    swapped for ``{"$array": key}`` refs stored in the npz sidecar."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        arrays[key] = v
        return {"$array": key}
    if isinstance(v, torch.Tensor):
        arrays[key] = v.detach().cpu().numpy()
        return {"$array": key}
    if hasattr(v, "__array__") and not isinstance(v, (list, tuple, dict)):
        arrays[key] = np.asarray(v)
        return {"$array": key}
    if isinstance(v, (list, tuple)):
        return {"$seq": [encode_value(x, arrays, f"{key}/{i}")
                         for i, x in enumerate(v)],
                "$tuple": isinstance(v, tuple)}
    if isinstance(v, dict):
        return {"$dict": {str(k): encode_value(x, arrays, f"{key}/{k}")
                          for k, x in v.items()}}
    if isinstance(v, PipelineStage):
        # nested fitted stage: SelectedModel.inner, the winning model
        return {"$stage": stage_to_json(v, arrays)}
    from ..selector.selector import ModelSelectorSummary
    if isinstance(v, ModelSelectorSummary):
        return {"$selsummary": _jsonify(v.to_json())}
    if isinstance(v, type):
        from ..types.base import FeatureType
        if issubclass(v, FeatureType):
            return {"$ftype": v.__name__}
        raise ValueError(f"Cannot serialize class {v!r} at {key}")
    if isinstance(v, VectorMetadata):
        return {"$vmeta": v.to_json()}
    from ..features.aggregators import MonoidAggregator
    if isinstance(v, MonoidAggregator):
        return {"$aggregator": type(v).__name__,
                "args": encode_value(_aggregator_args(v), arrays, key)}
    if callable(v):
        return {"$fn": resolve_importable_fn(v)}  # None = dropped
    raise ValueError(
        f"Cannot serialize ctor arg of type {type(v).__name__} at {key}")


def decode_value(v: Any, arrays: Dict[str, np.ndarray],
                 device: Optional[torch.device] = None) -> Any:
    """Inverse of :func:`encode_value`; nested stages are rebuilt on
    ``device`` (see :func:`stage_from_json`)."""
    if isinstance(v, dict):
        if "$array" in v:
            return np.asarray(arrays[v["$array"]])
        if "$seq" in v:
            seq = [decode_value(x, arrays, device) for x in v["$seq"]]
            return tuple(seq) if v.get("$tuple") else seq
        if "$dict" in v:
            return {k: decode_value(x, arrays, device)
                    for k, x in v["$dict"].items()}
        if "$ftype" in v:
            return feature_type_by_name(v["$ftype"])
        if "$vmeta" in v:
            return VectorMetadata.from_json(v["$vmeta"])
        if "$stage" in v:
            return stage_from_json(v["$stage"], arrays, device)
        if "$aggregator" in v:
            return _aggregator(v["$aggregator"],
                               decode_value(v["args"], arrays, device))
        if "$selsummary" in v:
            from ..selector.selector import ModelSelectorSummary
            return ModelSelectorSummary.from_json(v["$selsummary"])
        if "$fn" in v:
            if v["$fn"] is None:
                return None
            mod, qual = v["$fn"].split(":", 1)
            obj = importlib.import_module(mod)
            for part in qual.split("."):
                obj = getattr(obj, part)
            return obj
        return {k: decode_value(x, arrays, device) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x, arrays, device) for x in v]
    return v


def _aggregator_args(agg) -> dict:
    """A monoid aggregator's constructor arguments (a raw feature's
    aggregator, which the aggregate readers use)."""
    from ..features.aggregators import CustomMonoidAggregator
    if isinstance(agg, CustomMonoidAggregator):
        return {"zero": agg._zero, "combine": agg._combine}
    return dict(vars(agg))


def _aggregator(name: str, args: dict):
    """Inverse of ``_aggregator_args``: a combine function that was not
    importable at save time cannot be restored."""
    from ..features import aggregators
    if name == "CustomMonoidAggregator" and args.get("combine") is None:
        raise ValueError("CustomMonoidAggregator combine function was not "
                         "importable at save time and cannot be restored")
    return getattr(aggregators, name)(**args)


# ---------------------------------------------------------------------------
# stage serde
# ---------------------------------------------------------------------------

def stage_to_json(stage: PipelineStage, arrays: Dict[str, np.ndarray]) -> dict:
    """(reference OpPipelineStageWriter.scala:78-120)"""
    params = stage.get_params()
    params.pop("uid", None)
    d = {
        "className": type(stage).__name__,
        "uid": stage.uid,
        "operationName": stage.operation_name,
        "ctorArgs": {k: encode_value(v, arrays, f"{stage.uid}/{k}")
                     for k, v in params.items() if not _device_arg(k, v)},
    }
    pec = getattr(stage, "parent_estimator_class", None)
    if pec:
        d["parentEstimatorClass"] = pec
    vmeta = getattr(stage, "vector_metadata", None)
    if isinstance(vmeta, VectorMetadata):
        d["vectorMetadata"] = vmeta.to_json()
    return d


def stage_from_json(d: dict, arrays: Dict[str, np.ndarray],
                    device: Optional[torch.device] = None) -> PipelineStage:
    """(reference OpPipelineStageReader.scala:89-135) A class whose
    ``__init__`` takes ``device`` gets ``device``."""
    cls = stage_class_by_name(d["className"])
    kwargs = {k: decode_value(v, arrays, device)
              for k, v in d["ctorArgs"].items()}
    kwargs["uid"] = d["uid"]
    if kwargs.get("extract_fn", "missing") is None:
        kwargs.pop("extract_fn")  # fall back to by-name record lookup
    if cls.__name__ == "LambdaTransformer" and kwargs.get("fn") is None:
        raise ValueError(
            f"Stage {d['uid']}: LambdaTransformer function was not "
            "importable at save time and cannot be restored")
    if device is not None and \
            "device" in inspect.signature(cls.__init__).parameters:
        kwargs["device"] = device
    stage = cls(**kwargs)
    stage.operation_name = d.get("operationName", stage.operation_name)
    if "parentEstimatorClass" in d:
        stage.parent_estimator_class = d["parentEstimatorClass"]
    if "vectorMetadata" in d:
        stage.vector_metadata = VectorMetadata.from_json(d["vectorMetadata"])
    return stage


# ---------------------------------------------------------------------------
# feature DAG serde (reference FeatureJsonHelper)
# ---------------------------------------------------------------------------

def _feature_to_json(f: Feature) -> dict:
    return {
        "name": f.name,
        "uid": f.uid,
        "typeName": f.ftype.__name__,
        "isResponse": f.is_response,
        "originStageUid": f.origin_stage.uid if f.origin_stage else None,
        "parentUids": [p.uid for p in f.parents],
    }


def _collect_features_topo(result_features) -> List[Feature]:
    """All DAG features, parents before children."""
    seen: Dict[str, Feature] = {}
    order: List[Feature] = []

    def go(f: Feature):
        if f.uid in seen:
            return
        seen[f.uid] = f
        for p in f.parents:
            go(p)
        order.append(f)

    for rf in result_features:
        go(rf)
    return order


# ---------------------------------------------------------------------------
# model save / load
# ---------------------------------------------------------------------------

def _fsync_file(fpath: str) -> None:
    fd = os.open(fpath, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_model(model, path: str) -> None:
    """Write a fitted WorkflowModel to ``path`` (a directory)
    (reference OpWorkflowModelWriter.toJson:75-120).

    Atomic: the files are staged into a sibling temp directory (fsync'd)
    and swapped in with ``os.rename``, so a crash mid-save leaves either
    the previous intact model or no model at ``path``, never a
    half-written directory. A leftover ``<path>.tmp-save*`` staging dir
    is the crash's only trace, and ``load_model`` rejects it."""
    feats = _collect_features_topo(model.result_features)
    for f in feats:
        if f.origin_stage is not None and isinstance(f.origin_stage,
                                                     Estimator):
            raise ValueError(
                f"Feature {f.name!r} still points at unfitted estimator "
                f"{f.origin_stage!r}; save the model returned by train()")
    arrays: Dict[str, np.ndarray] = {}
    stages, staged = [], set()
    for f in feats:
        s = f.origin_stage
        if s is not None and s.uid not in staged:
            staged.add(s.uid)
            stages.append(stage_to_json(s, arrays))
    from ..utils.version import version_info
    rff = getattr(model, "raw_feature_filter_results", None)
    doc = {
        "formatVersion": MODEL_FORMAT_VERSION,
        "versionInfo": version_info().to_json(),
        "resultFeatureUids": [f.uid for f in model.result_features],
        "features": [_feature_to_json(f) for f in feats],
        "stages": stages,
        # reference OpWorkflowModelWriter persists RFF results into
        # op-model.json (OpWorkflowModelWriter.scala:75-120)
        "rawFeatureFilterResults": rff.to_json() if rff is not None
        else None,
        "blacklistedFeatureNames": list(
            getattr(model, "blacklisted_feature_names", ())),
    }
    tmp = f"{path}.tmp-save{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    json_path = os.path.join(tmp, MODEL_JSON)
    with open(json_path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    _save_drift_fingerprints(model, tmp)
    # drill site: a kill here leaves a staged directory and the target
    # untouched (or its previous model in place)
    from ..runtime.faults import maybe_inject
    maybe_inject("workflow", "save", "save")
    np.savez(os.path.join(tmp, ARRAYS_NPZ), **arrays)
    _fsync_file(os.path.join(tmp, ARRAYS_NPZ))
    if os.path.isdir(path):
        # rename cannot replace a non-empty dir: move the old model aside
        # first and remove it only after the new one is in place (worst
        # crash outcome: the old model at <path>.old-save*)
        old = f"{path}.old-save{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)
    # the drift sentinel resolves fingerprints through the model dir
    model.model_dir = path


def _save_drift_fingerprints(model, staging_dir: str) -> None:
    """Write the training data's per-feature distributions into the model
    directory (``drift-fingerprints.json``), so the serving sentinel
    compares scored traffic against training without the training data.
    A model without a train dataset (one loaded from a save) carries
    none, and the sentinel says it is unavailable; a failing fingerprint
    never fails the save."""
    train_ds = getattr(model, "train_dataset", None)
    if train_ds is None:
        return
    from ..serving.sentinel import compute_fingerprints, save_fingerprints
    try:
        fps = compute_fingerprints(model.raw_features(), train_ds)
        if fps:
            save_fingerprints(
                fps, staging_dir,
                trained_at=getattr(model, "trained_generation", 0))
    except Exception as e:   # never let fingerprinting break a save
        import logging
        logging.getLogger(__name__).warning(
            "drift fingerprints not saved (%s: %s); the saved model "
            "will serve without the drift sentinel", type(e).__name__, e)


def _referenced_array_keys(node: Any) -> List[str]:
    """Every ``{"$array": key}`` reference in a model document — the
    npz sidecar must supply all of them or the dir is partial."""
    keys: List[str] = []
    if isinstance(node, dict):
        if "$array" in node and isinstance(node["$array"], str):
            keys.append(node["$array"])
        else:
            for v in node.values():
                keys.extend(_referenced_array_keys(v))
    elif isinstance(node, list):
        for v in node:
            keys.extend(_referenced_array_keys(v))
    return keys


def load_model(path: str, device="cuda"):
    """Load a fitted WorkflowModel from ``path``, its models predicting on
    ``device`` (default the CUDA card; raises without one) (reference
    OpWorkflowModelReader / OpWorkflow.loadModel).

    Rejects partial or corrupt model directories (a stray staging dir, a
    truncated JSON, missing arrays) with a clear error instead of failing
    deep inside stage deserialization."""
    from .workflow import WorkflowModel
    device = resolve_device(device)
    json_path = os.path.join(path, MODEL_JSON)
    if not os.path.isdir(path) or not os.path.exists(json_path):
        raise ValueError(
            f"{path!r} is not a saved model directory (no {MODEL_JSON})"
            + (" — it looks like an interrupted save; re-save the "
               "model" if "tmp-save" in os.path.basename(path)
               or os.path.isdir(path) else ""))
    with open(json_path) as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"model at {path} has a corrupt/truncated {MODEL_JSON} "
                f"({e}) — likely an interrupted save; re-save the "
                f"model") from e
    fmt = doc.get("formatVersion", 1)
    if fmt > MODEL_FORMAT_VERSION:
        raise ValueError(
            f"model at {path} uses format {fmt}; this build reads up "
            f"to {MODEL_FORMAT_VERSION} — load with a newer build")
    npz_path = os.path.join(path, ARRAYS_NPZ)
    arrays: Dict[str, np.ndarray] = {}
    needed = set(_referenced_array_keys(doc.get("stages", [])))
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    missing = sorted(needed - set(arrays))
    if missing:
        raise ValueError(
            f"model at {path} is partial: {MODEL_JSON} references "
            f"{len(needed)} arrays but "
            f"{ARRAYS_NPZ if os.path.exists(npz_path) else 'the missing ' + ARRAYS_NPZ} "
            f"lacks {len(missing)} of them (e.g. {missing[0]!r}) — "
            f"an interrupted save; re-save the model")

    stages: Dict[str, PipelineStage] = {}
    for sd in doc["stages"]:
        stages[sd["uid"]] = stage_from_json(sd, arrays, device)

    features: Dict[str, Feature] = {}
    for fd in doc["features"]:
        parents = tuple(features[u] for u in fd["parentUids"])
        stage = stages.get(fd["originStageUid"]) \
            if fd["originStageUid"] else None
        f = Feature(name=fd["name"],
                    ftype=feature_type_by_name(fd["typeName"]),
                    is_response=fd["isResponse"], origin_stage=stage,
                    parents=parents, uid=fd["uid"])
        features[f.uid] = f
        if stage is not None:
            stage.input_features = parents
            stage._output_feature = f
    result = tuple(features[u] for u in doc["resultFeatureUids"])
    rff = None
    if doc.get("rawFeatureFilterResults"):
        from ..checkers.raw_feature_filter import RawFeatureFilterResults
        rff = RawFeatureFilterResults.from_json(
            doc["rawFeatureFilterResults"])
    model = WorkflowModel(
        result_features=result, raw_feature_filter_results=rff,
        blacklisted_feature_names=doc.get("blacklistedFeatureNames", ()))
    # the drift sentinel reads the training fingerprints from here
    model.model_dir = path
    return model
