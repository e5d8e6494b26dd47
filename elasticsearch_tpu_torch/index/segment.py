"""Block postings for one inverted field (the port's copy of `FieldPostings`,
`tf_at` and `build_field_postings` from elasticsearch_tpu/index/segment.py,
plus `postings_from_arrays`, which carries an index built by the reference
across to the port), the `VectorColumn` of a dense_vector field, and the
doc-value columns the aggregations read (`NumericColumn`, `KeywordColumn`,
copied as they are, with `numeric_column_from_arrays` and
`keyword_column_from_arrays` to carry the reference's columns across).

Layout (as in the reference): all of a field's postings concatenated as
[n_blocks, 128] (doc-id, tf) host arrays plus per-term (block_start,
block_count); block row 0 is reserved all-zero padding, and the unused
lanes of a term's last row hold doc 0 with tf 0. The positions CSR
(pos_start per posting into pos_data) backs phrase queries
(index/positions.py). The serving engine copies what it needs onto the
device itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence

import numpy as np

BLOCK = 128

# FieldPostings' array fields, in the order bench.py caches them
POSTINGS_ARRAYS = ("doc_freq", "total_term_freq", "block_start",
                   "block_count", "block_docs", "block_tfs", "block_max_tf",
                   "post_start", "post_doc", "pos_start", "pos_data",
                   "doc_len")


@dataclass
class FieldPostings:
    """Block postings + positions for one inverted (text/keyword) field."""

    field: str
    term_to_ord: Dict[str, int]
    terms: List[str]                    # ord -> term (sorted)
    doc_freq: np.ndarray                # [n_terms] i32
    total_term_freq: np.ndarray         # [n_terms] i64
    block_start: np.ndarray             # [n_terms] i32 (row into block arrays)
    block_count: np.ndarray             # [n_terms] i32
    block_docs: np.ndarray              # [n_blocks, BLOCK] i32 (row 0 = zeros)
    block_tfs: np.ndarray               # [n_blocks, BLOCK] f32
    block_max_tf: np.ndarray            # [n_blocks] f32
    post_start: np.ndarray              # [n_terms + 1] i64
    post_doc: np.ndarray                # [total_postings] i32
    pos_start: np.ndarray               # [total_postings + 1] i64
    pos_data: np.ndarray                # [total_positions] i32
    doc_len: np.ndarray                 # [n_docs] f32 (0 if absent)
    sum_doc_len: float

    def ord(self, term: str) -> int:
        return self.term_to_ord.get(term, -1)


@dataclass
class VectorColumn:
    """One dense_vector field of a partition (KnnEngine's input)."""

    vectors: np.ndarray                 # [n_docs, dims] f32
    norms: np.ndarray                   # [n_docs] f32
    exists: np.ndarray                  # [n_docs] bool
    dims: int
    similarity: str


def postings_from_arrays(arrays: Mapping[str, np.ndarray],
                         terms: Sequence[str], sum_doc_len: float,
                         field: str = "body") -> FieldPostings:
    """The port's FieldPostings over the reference's arrays (the
    `POSTINGS_ARRAYS` of a reference FieldPostings, as bench.py caches
    them), with `terms` in ord order. The arrays are used as given."""
    missing = [n for n in POSTINGS_ARRAYS if n not in arrays]
    if missing:
        raise ValueError(f"postings arrays missing: {missing}")
    terms = list(terms)
    if len(terms) != len(arrays["doc_freq"]):
        raise ValueError(f"{len(terms)} terms for "
                         f"{len(arrays['doc_freq'])} doc_freq entries")
    return FieldPostings(
        field=field, term_to_ord={t: i for i, t in enumerate(terms)},
        terms=terms, sum_doc_len=float(sum_doc_len),
        **{n: np.asarray(arrays[n]) for n in POSTINGS_ARRAYS})


@dataclass
class NumericColumn:
    values: np.ndarray                  # [n_docs] f64 (min value; asc sort mode)
    max_values: np.ndarray              # [n_docs] f64 (max value; desc sort mode)
    exists: np.ndarray                  # [n_docs] bool
    # full multi-value CSR for range semantics ("any value in range")
    value_start: np.ndarray             # [n_docs + 1] i64
    all_values: np.ndarray              # [total_values] f64 (per-doc sorted)

    def min_values(self) -> np.ndarray:
        return self.values

    def range_mask(self, lo: float, hi: float, include_lo: bool, include_hi: bool) -> np.ndarray:
        left = self.all_values >= lo if include_lo else self.all_values > lo
        right = self.all_values <= hi if include_hi else self.all_values < hi
        hit = (left & right).astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(hit)])
        counts = cum[self.value_start[1:]] - cum[self.value_start[:-1]]
        return (counts > 0) & self.exists


@dataclass
class KeywordColumn:
    terms: List[str]                    # sorted dictionary
    term_to_ord: Dict[str, int]
    ords: np.ndarray                    # [n_docs] i32, -1 = missing (min value;
    #                                     the reference's asc sort mode "min")
    max_ords: np.ndarray                # [n_docs] i32 (max value; desc sort mode)
    exists: np.ndarray                  # [n_docs] bool
    ord_start: np.ndarray               # [n_docs + 1] i64 — multivalue CSR
    all_ords: np.ndarray                # [total_values] i32 (per-doc sorted)

    def doc_terms(self, ord_: int) -> List[str]:
        lo, hi = int(self.ord_start[ord_]), int(self.ord_start[ord_ + 1])
        return [self.terms[o] for o in self.all_ords[lo:hi]]


# the array fields of the two column types
NUMERIC_ARRAYS = ("values", "max_values", "exists", "value_start",
                  "all_values")
KEYWORD_ARRAYS = ("ords", "max_ords", "exists", "ord_start", "all_ords")


def _column_arrays(arrays: Mapping[str, np.ndarray], names, kind: str):
    missing = [n for n in names if n not in arrays]
    if missing:
        raise ValueError(f"{kind} column arrays missing: {missing}")
    return {n: np.asarray(arrays[n]) for n in names}


def numeric_column_from_arrays(
        arrays: Mapping[str, np.ndarray]) -> NumericColumn:
    """The port's NumericColumn over a reference column's arrays (the
    `NUMERIC_ARRAYS` of a reference NumericColumn), used as given."""
    return NumericColumn(**_column_arrays(arrays, NUMERIC_ARRAYS, "numeric"))


def keyword_column_from_arrays(arrays: Mapping[str, np.ndarray],
                               terms: Sequence[str]) -> KeywordColumn:
    """The port's KeywordColumn over a reference column's arrays (the
    `KEYWORD_ARRAYS` of a reference KeywordColumn), with `terms` its sorted
    dictionary in ord order. The arrays are used as given."""
    cols = _column_arrays(arrays, KEYWORD_ARRAYS, "keyword")
    terms = list(terms)
    if len(cols["all_ords"]) and int(cols["all_ords"].max()) >= len(terms):
        raise ValueError(f"an ord reaches past the {len(terms)} terms")
    return KeywordColumn(terms=terms,
                         term_to_ord={t: i for i, t in enumerate(terms)},
                         **cols)


def tf_at(fp: FieldPostings, term: str,
          docs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(tf f32[n], present bool[n]) of `term` for sorted candidate docs."""
    o = fp.term_to_ord.get(term)
    if o is None:
        return np.zeros(len(docs), np.float32), np.zeros(len(docs), bool)
    lo, hi = int(fp.post_start[o]), int(fp.post_start[o + 1])
    seg = fp.post_doc[lo:hi]
    j = np.searchsorted(seg, docs)
    present = (j < hi - lo)
    present[present] = seg[j[present]] == docs[present]
    within = np.where(present, j, 0).astype(np.int64)
    row = int(fp.block_start[o]) + within // 128
    lane = within % 128
    tf = fp.block_tfs[row, lane].astype(np.float32)
    return np.where(present, tf, 0.0), present


def _sorted_keys_and_positions(key: np.ndarray, token_pos: np.ndarray):
    """(uniq, tf, pos_sorted) for (term, doc) keys with positions: the
    unique keys and their counts as np.unique gives them, and the positions
    grouped in key order, ascending inside a group (the reference's
    lexsort((token_pos, token_docs, token_terms)) order), from one argsort
    of the combined integer key * span + position, which is several times
    faster than the lexsort. Raises ValueError where that integer would
    not fit in 63 bits or a position is negative."""
    pos = token_pos.astype(np.int64)
    span = int(pos.max()) + 1 if len(pos) else 1
    if int(pos.min(initial=0)) < 0 \
            or (int(key.max(initial=0)) + 1) * span >= 1 << 63:
        raise ValueError(f"(term, doc) keys up to {int(key.max())} with "
                         f"positions in [{int(pos.min())}, {span - 1}] do "
                         f"not combine into a 63-bit sort key")
    order = np.argsort(key * span + pos)
    sk = key[order]
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]])) \
        if len(sk) else np.empty(0, np.int64)
    tf = np.diff(np.append(starts, len(sk)))
    return sk[starts], tf, np.ascontiguousarray(pos[order]).astype(np.int32)


def build_field_postings(
    field: str,
    doc_lens: np.ndarray,      # [n_docs] token count per doc
    token_docs: np.ndarray,    # [n_tokens] doc ord of each token
    token_terms: np.ndarray,   # [n_tokens] term ord of each token
    term_names: List[str],     # term ord -> term string (sorted)
    token_pos: np.ndarray | None = None,  # [n_tokens] position within its doc
) -> FieldPostings:
    """Columnar bulk postings build: token arrays -> block postings. When
    `token_pos` is given the positions CSR is recorded too (phrase
    queries read it): each (term, doc) posting's positions, ascending, as
    the reference's builder lays them out. Without it pos_start is all
    zeros and pos_data empty."""
    n_docs = len(doc_lens)
    n_terms = len(term_names)
    key = token_terms.astype(np.int64) * n_docs + token_docs.astype(np.int64)
    if token_pos is not None:
        uniq, tf, pos_data = _sorted_keys_and_positions(key, token_pos)
    else:
        uniq, tf = np.unique(key, return_counts=True)
    term_ord = (uniq // n_docs).astype(np.int64)
    doc_ord = (uniq % n_docs).astype(np.int64)
    tf = tf.astype(np.float32)
    doc_len = doc_lens.astype(np.float32)

    doc_freq = np.bincount(term_ord, minlength=n_terms).astype(np.int32)
    n_blocks_per_term = (doc_freq + BLOCK - 1) // BLOCK
    block_start = np.zeros(n_terms, np.int32)
    if n_terms:
        block_start[0] = 1
        np.cumsum(n_blocks_per_term[:-1], out=block_start[1:])
        block_start[1:] += 1
    total_blocks = 1 + int(n_blocks_per_term.sum())

    term_offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(doc_freq, out=term_offsets[1:])
    within = np.arange(len(term_ord), dtype=np.int64) - term_offsets[term_ord]
    row = block_start[term_ord] + (within // BLOCK).astype(np.int32)
    lane = (within % BLOCK).astype(np.int32)

    block_docs = np.zeros((total_blocks, BLOCK), np.int32)
    block_tfs = np.zeros((total_blocks, BLOCK), np.float32)
    block_docs[row, lane] = doc_ord
    block_tfs[row, lane] = tf
    block_max_tf = np.zeros(total_blocks, np.float32)
    if len(term_ord):
        starts = np.nonzero(lane == 0)[0]
        block_max_tf[row[starts]] = np.maximum.reduceat(tf, starts)

    total_tf = np.zeros(n_terms, np.int64)
    nz = doc_freq > 0
    if nz.any():
        total_tf[nz] = np.add.reduceat(tf.astype(np.int64),
                                       term_offsets[:-1][nz])

    pos_start = np.zeros(len(term_ord) + 1, np.int64)
    if token_pos is not None and len(term_ord):
        np.cumsum(tf.astype(np.int64), out=pos_start[1:])
    else:
        pos_data = np.empty(0, np.int32)

    return FieldPostings(
        field=field,
        term_to_ord={t: i for i, t in enumerate(term_names)},
        terms=list(term_names),
        doc_freq=doc_freq,
        total_term_freq=total_tf,
        block_start=block_start,
        block_count=n_blocks_per_term.astype(np.int32),
        block_docs=block_docs,
        block_tfs=block_tfs,
        block_max_tf=block_max_tf,
        post_start=term_offsets,
        post_doc=doc_ord.astype(np.int32),
        pos_start=pos_start,
        pos_data=pos_data,
        doc_len=doc_len,
        sum_doc_len=float(doc_len.sum()),
    )
