"""Exception hierarchy mirroring the reference's ElasticsearchException family
(the classes of elasticsearch_tpu/common/errors.py the port raises), plus
the device and kernel errors of the CUDA port.

Each error carries an HTTP status so a REST layer can map exceptions to
responses the way the reference does.
"""

from __future__ import annotations


class ElasticsearchTpuError(Exception):
    """Base error; subclasses set `status` for REST mapping."""

    status = 500
    error_type = "exception"

    def __init__(self, message: str, **metadata):
        super().__init__(message)
        self.message = message
        self.metadata = metadata

    def to_dict(self) -> dict:
        out = {"type": self.error_type, "reason": self.message}
        out.update(self.metadata)
        return out


class IndexNotFoundError(ElasticsearchTpuError):
    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(f"no such index [{index}]", index=index)
        self.index = index


class ResourceAlreadyExistsError(ElasticsearchTpuError):
    status = 400
    error_type = "resource_already_exists_exception"


class CircuitBreakingError(ElasticsearchTpuError):
    """Memory limit trip (ref: common/breaker/CircuitBreakingException.java)."""

    status = 429
    error_type = "circuit_breaking_exception"


class IndexClosedError(ElasticsearchTpuError):
    status = 400
    error_type = "index_closed_exception"


class SearchPhaseExecutionError(ElasticsearchTpuError):
    status = 500
    error_type = "search_phase_execution_exception"


class DocumentMissingError(ElasticsearchTpuError):
    status = 404
    error_type = "document_missing_exception"


class VersionConflictError(ElasticsearchTpuError):
    """Optimistic-concurrency failure (ref: VersionConflictEngineException)."""

    status = 409
    error_type = "version_conflict_engine_exception"


class DeviceFaultError(ElasticsearchTpuError):
    """A device dispatch failed (injected or organic runtime error).

    Carries the dispatch `site` and optional `part` (partition id) so the
    containment layer can attribute the failure to a partition."""

    status = 503
    error_type = "tpu_device_fault_exception"

    def __init__(self, message: str, site: str = None, part: int = None,
                 **metadata):
        super().__init__(message, **metadata)
        self.site = site
        self.part = part

    def to_dict(self) -> dict:
        out = super().to_dict()
        if self.site is not None:
            out["site"] = self.site
        if self.part is not None:
            out["partition"] = self.part
        return out


class HbmOomError(DeviceFaultError):
    """Device memory exhausted mid-dispatch."""

    error_type = "tpu_hbm_oom_exception"


class IllegalArgumentError(ElasticsearchTpuError):
    status = 400
    error_type = "illegal_argument_exception"


class ParsingError(ElasticsearchTpuError):
    status = 400
    error_type = "parsing_exception"


class MapperParsingError(ElasticsearchTpuError):
    status = 400
    error_type = "mapper_parsing_exception"


class DeviceUnavailableError(RuntimeError):
    """The requested device is absent (no CUDA, or not a Hopper sm_90
    card). Raised at construction so nothing silently runs on the CPU."""


class KernelBuildError(Exception):
    """A hand-written CUDA kernel failed to compile or load. Deliberately
    not a RuntimeError: the fault-containment layer treats device runtime
    errors as recoverable faults, and a missing kernel is not one."""


class KernelLaunchError(Exception):
    """A kernel launch was refused (cudaGetLastError != 0). Not a
    RuntimeError for the same reason as KernelBuildError: a refused launch
    is a bug in the port and must not be served around by the host tier."""


class ShardNotFoundError(ElasticsearchTpuError):
    status = 404
    error_type = "shard_not_found_exception"


class JsonParseError(ElasticsearchTpuError):
    status = 400
    error_type = "json_parse_exception"
