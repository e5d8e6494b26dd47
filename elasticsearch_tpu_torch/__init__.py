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

Ported so far: the BM25 ``match`` serving path at one partition —
``search.serving.extract_plan`` -> ``select_bm25_engine`` ->
``TurboEngine.search_many`` -> ``parallel.turbo.TurboBM25.search_many`` —,
``bool`` and slop-0 phrase serving (``TurboEngine.search_bool``), quantized
kNN (``select_knn_engine`` -> ``parallel.knn.KnnEngine``), and device
aggregations (``search.aggregations`` -> ``search.agg_device``).
"""

__version__ = "0.1.0"
