"""Host lane scores shared by the BM25 engines (the port's copy of
`_host_block_scores`, elasticsearch_tpu/parallel/blockmax.py:896). The
BlockMax engine itself is not ported yet (ROADMAP.md, queue 1)."""

from __future__ import annotations

import numpy as np


def _host_block_scores(fp, avgdl: float) -> np.ndarray:
    """Idf-free lane scores on host (same formula as build_stacked_bm25)."""
    from elasticsearch_tpu_torch.parallel.spmd import B as B_, K1

    dl = fp.doc_len[fp.block_docs]
    denom = fp.block_tfs + K1 * (1.0 - B_ + B_ * dl / max(avgdl, 1e-9))
    return np.where(fp.block_tfs > 0,
                    fp.block_tfs * (K1 + 1.0) / denom, 0.0).astype(np.float32)
