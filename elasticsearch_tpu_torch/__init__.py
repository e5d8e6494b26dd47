"""elasticsearch_tpu_torch — the PyTorch + CUDA port of elasticsearch_tpu.

The JAX package beside it is the reference and stays as it is. This package
mirrors its layout and names (``parallel/turbo.py`` here is the port of
``elasticsearch_tpu/parallel/turbo.py``), imports torch and numpy, and never
imports jax or anything of ``elasticsearch_tpu``: what it needs from that
package's jax-free modules it keeps as its own copy.

Inside, it is plain PyTorch: functions on tensors with an explicit
``device``, in-place updates where the reference donated buffers, and the
TPU's Pallas kernels replaced by CUDA C++ kernels for Hopper
(``parallel/csrc``), each with a plain torch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.py``); nothing falls back to the CPU on its own.

Ported so far: the serving entry point —
``index.index_service.IndexService.search`` / ``msearch`` ->
``search.serving.ServingContext`` -> the adaptive dispatch scheduler
(``threadpool.scheduler.serving_dispatch``) -> the engines: Turbo BM25
(``TurboEngine.search_many`` / ``search_bool`` ->
``parallel.turbo.TurboBM25``), quantized kNN (``parallel.knn.KnnEngine``)
and, for every body the fast path declines, the dense executor
(``search.execute_search``) with device aggregations
(``search.agg_device``, K8 on the scheduler's bulk tier).
"""

__version__ = "0.1.0"
