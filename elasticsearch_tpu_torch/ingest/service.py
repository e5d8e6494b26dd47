"""IngestService: pipeline registry + execution.

Re-designs the reference's IngestService (ref: ingest/IngestService.java:479
executeBulkRequest routing docs through pipelines before the index action;
ingest/Pipeline.java, CompoundProcessor.java on_failure semantics): a
pipeline is a list of processors, each optionally carrying its own
on_failure chain; a document either comes out transformed, is dropped, or
the failure surfaces on that document's bulk item.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from elasticsearch_tpu_torch.common.errors import ElasticsearchTpuError
from elasticsearch_tpu_torch.ingest.processors import (
    PROCESSORS, DropDocument, IngestDocument, IngestProcessorError,
)


class PipelineMissingError(ElasticsearchTpuError):
    status = 404
    error_type = "resource_not_found_exception"


class _Step:
    def __init__(self, type_: str, cfg: dict):
        self.type = type_
        self.tag = cfg.get("tag")
        self.ignore_failure = cfg.get("ignore_failure", False)
        self.on_failure = [_build_step(c) for c in cfg.get("on_failure", [])]
        builder = PROCESSORS.get(type_)
        if builder is None:
            raise IngestProcessorError(
                f"No processor type exists with name [{type_}]")
        if "if" in cfg:
            # running a conditional processor unconditionally silently
            # corrupts (or drops) documents — refuse at pipeline PUT time
            raise IngestProcessorError(
                f"[{type_}] processor [if] conditions are not supported")
        clean = {k: v for k, v in cfg.items()
                 if k not in ("tag", "ignore_failure", "on_failure",
                              "description")}
        self.run = builder(clean)


def _build_step(spec: dict) -> _Step:
    if not isinstance(spec, dict) or len(spec) != 1:
        raise IngestProcessorError(
            "processor must be a single-key {type: config} object")
    type_, cfg = next(iter(spec.items()))
    return _Step(type_, cfg or {})


class Pipeline:
    def __init__(self, pipeline_id: str, body: dict):
        self.id = pipeline_id
        self.description = body.get("description", "")
        self.body = body
        self.steps = [_build_step(p) for p in body.get("processors", [])]
        self.on_failure = [_build_step(p) for p in body.get("on_failure", [])]

    def execute(self, doc: IngestDocument) -> Optional[IngestDocument]:
        """Returns the (mutated) doc, or None when dropped."""
        try:
            for step in self.steps:
                try:
                    step.run(doc)
                except DropDocument:
                    raise
                except Exception as e:  # noqa: BLE001 — on_failure chain
                    if step.ignore_failure:
                        continue
                    if step.on_failure:
                        doc.meta["_ingest_error"] = str(e)
                        for fb in step.on_failure:
                            fb.run(doc)
                        continue
                    raise
        except DropDocument:
            return None
        except Exception as e:  # noqa: BLE001 — pipeline-level on_failure
            if self.on_failure:
                doc.meta["_ingest_error"] = str(e)
                for fb in self.on_failure:
                    fb.run(doc)
                return doc
            raise
        return doc


class IngestService:
    def __init__(self):
        self._lock = threading.Lock()
        self._pipelines: Dict[str, Pipeline] = {}

    def put_pipeline(self, pipeline_id: str, body: dict) -> None:
        pipeline = Pipeline(pipeline_id, body)   # validates processors
        with self._lock:
            self._pipelines[pipeline_id] = pipeline

    def get_pipeline(self, pipeline_id: str) -> Pipeline:
        p = self._pipelines.get(pipeline_id)
        if p is None:
            raise PipelineMissingError(f"pipeline [{pipeline_id}] is missing")
        return p

    def delete_pipeline(self, pipeline_id: str) -> None:
        with self._lock:
            if self._pipelines.pop(pipeline_id, None) is None:
                raise PipelineMissingError(
                    f"pipeline [{pipeline_id}] is missing")

    def pipelines(self) -> Dict[str, dict]:
        return {pid: p.body for pid, p in self._pipelines.items()}

    def has(self, pipeline_id: str) -> bool:
        return pipeline_id in self._pipelines

    def process(self, pipeline_id: str, source: dict, index: str = "",
                doc_id: str = "") -> Optional[tuple]:
        """Run one source dict through a pipeline. Returns (source, index,
        doc_id) — pipelines may REROUTE via _index/_id metadata writes (the
        date-based-routing pattern) — or None if the document was dropped."""
        doc = IngestDocument(dict(source), index=index, doc_id=doc_id)
        out = self.get_pipeline(pipeline_id).execute(doc)
        if out is None:
            return None
        return out.source, doc.meta.get("_index") or index, \
            doc.meta.get("_id") or doc_id

    def simulate(self, pipeline_body: dict, docs: List[dict]) -> List[dict]:
        """_simulate endpoint: run ad-hoc pipeline over sample docs."""
        pipeline = Pipeline("_simulate_pipeline", pipeline_body)
        out = []
        for d in docs:
            src = d.get("_source", {})
            doc = IngestDocument(dict(src), index=d.get("_index", "_index"),
                                 doc_id=d.get("_id", "_id"))
            try:
                res = pipeline.execute(doc)
                if res is None:
                    out.append({"doc": None})
                else:
                    out.append({"doc": {
                        "_index": doc.meta.get("_index"),
                        "_id": doc.meta.get("_id"),
                        "_source": res.source,
                    }})
            except Exception as e:  # noqa: BLE001 — per-doc simulate errors
                out.append({"error": {
                    "type": getattr(e, "error_type", "exception"),
                    "reason": str(e)}})
        return out
