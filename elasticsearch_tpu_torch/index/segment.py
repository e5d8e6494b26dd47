"""The segment: an immutable index partition as fixed-shape arrays (the
port's copy of elasticsearch_tpu/index/segment.py).

Layout (as in the reference): all of a field's postings concatenated as
[n_blocks, 128] (doc-id, tf) host arrays plus per-term (block_start,
block_count); block row 0 is reserved all-zero padding, and the unused
lanes of a term's last row hold doc 0 with tf 0. The positions CSR
(pos_start per posting into pos_data) backs phrase queries
(index/positions.py). Numeric doc values are host f64 columns, keyword
doc values ordinals into a sorted per-segment dictionary, dense_vector one
[n_docs, dims] matrix, `_source` a host list of dicts. Deletes never
mutate a segment: the engine keeps per-segment live masks.

Differences from the reference:

  * **Device.** A `Segment` carries the torch.device its engine resolved
    (`torch_device`; `device.resolve`, so the default is the card and the
    CPU only by name). `Segment.device(key)` keeps the reference's keys
    and tuples and caches torch tensors on that device under
    `_device_lock`; cosine vectors are normalized on the host, then
    turned to bf16 on the device. `__getstate__` drops the cache.
    `SegmentBuilder`, `merge_segments` and `segment_io.segment_from_blob`
    take the device the segments they make carry.
  * `build_field_postings` forms the (term, doc) groups and their
    positions from one argsort of a combined integer key rather than the
    reference's lexsort (`_sorted_keys_and_positions`); the arrays are
    the same.
  * `postings_from_arrays`, `numeric_column_from_arrays` and
    `keyword_column_from_arrays` carry a reference index's arrays across
    (`segment_io.segment_from_arrays` a whole segment's).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from elasticsearch_tpu_torch import device as _device
from elasticsearch_tpu_torch.mapper.mapper_service import LuceneDoc

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

    def term_block_ids(self, term: str) -> np.ndarray:
        o = self.term_to_ord.get(term)
        if o is None:
            return np.empty(0, np.int32)
        s, c = int(self.block_start[o]), int(self.block_count[o])
        return np.arange(s, s + c, dtype=np.int32)

    def positions(self, term: str, doc_ord: int) -> np.ndarray:
        """Positions of `term` in `doc_ord` (host lookup for phrase verify)."""
        o = self.term_to_ord.get(term)
        if o is None:
            return np.empty(0, np.int32)
        lo, hi = int(self.post_start[o]), int(self.post_start[o + 1])
        idx = np.searchsorted(self.post_doc[lo:hi], doc_ord)
        if idx >= hi - lo or self.post_doc[lo + idx] != doc_ord:
            return np.empty(0, np.int32)
        p = lo + idx
        return self.pos_data[int(self.pos_start[p]): int(self.pos_start[p + 1])]


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


@dataclass
class GeoColumn:
    """Paired lat/lon multivalues (CSR, UNSORTED so index i of lat pairs
    with index i of lon — per-axis sorting would scramble the points)."""

    lat: np.ndarray                     # [total_points] f64
    lon: np.ndarray                     # [total_points] f64
    value_start: np.ndarray             # [n_docs + 1] i64
    exists: np.ndarray                  # [n_docs] bool


@dataclass
class NestedTable:
    """Child-table sidecar for one nested field: a full child Segment
    (postings/columns over child rows) plus the child->parent map. The
    TPU-first block-join: parent doc ids/seqnos/live masks are untouched;
    nested queries score the child table and CSR-reduce to parents."""

    child: "Segment"                    # child rows as their own segment
    parent_of: np.ndarray               # [n_children] i32 parent ord (sorted)
    child_start: np.ndarray             # [n_parents + 1] i64 CSR



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


class Segment:
    """Immutable per-shard index partition. Host arrays always present;
    device tensors materialized lazily per field via `device()`, on
    `torch_device`."""

    def __init__(
        self,
        seg_id: int,
        doc_ids: List[str],
        sources: List[dict],
        postings: Dict[str, FieldPostings],
        numeric: Dict[str, NumericColumn],
        keyword: Dict[str, KeywordColumn],
        vectors: Dict[str, VectorColumn],
        seq_nos: np.ndarray,
        versions: np.ndarray | None = None,
        geo: Dict[str, "GeoColumn"] | None = None,
        nested: Dict[str, "NestedTable"] | None = None,
        device=None,
    ):
        self.torch_device = _device.resolve(device)
        self.seg_id = seg_id
        self.n_docs = len(doc_ids)
        self.doc_ids = doc_ids
        self.id_to_ord = {d: i for i, d in enumerate(doc_ids)}
        self.sources = sources
        self.postings = postings
        self.numeric = numeric
        self.keyword = keyword
        self.vectors = vectors
        self.geo = geo or {}
        self.nested = nested or {}
        self.seq_nos = seq_nos          # [n_docs] i64 — seqno of each op
        self.versions = versions if versions is not None else np.ones(self.n_docs, np.int64)
        self._device: dict = {}
        self._device_lock = threading.Lock()

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_device"] = {}          # device arrays are never persisted
        state.pop("_device_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("geo", {})   # pre-geo pickled segments
        self.__dict__.setdefault("nested", {})
        self._device = {}
        self._device_lock = threading.Lock()

    # ---- stats (combined at shard level for idf/avgdl) ----

    def field_stats(self, field: str) -> tuple[int, float]:
        """(docs with field, sum of field lengths) for BM25 norms."""
        fp = self.postings.get(field)
        if fp is None:
            return 0, 0.0
        return int(np.count_nonzero(fp.doc_len)), float(fp.sum_doc_len)

    def term_stats(self, field: str, term: str) -> tuple[int, int]:
        """(doc_freq, total_term_freq) of term in this segment."""
        fp = self.postings.get(field)
        if fp is None:
            return 0, 0
        o = fp.ord(term)
        if o < 0:
            return 0, 0
        return int(fp.doc_freq[o]), int(fp.total_term_freq[o])

    # ---- device residency ----

    def device(self, key: str):
        """Lazily upload one array group to `torch_device`. Keys:
        'post:<field>' -> (block_docs i32, block_tfs f32, doc_len f32)
        'vec:<field>'  -> (vectors bf16, norms f32, exists bool)
        'num:<field>'  -> (values f32, exists bool)
        'kw:<field>'   -> (ords i32, exists bool)
        """
        dev = self.torch_device

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        with self._device_lock:
            if key in self._device:
                return self._device[key]
            kind, _, fname = key.partition(":")
            if kind == "post":
                fp = self.postings[fname]
                out = (put(fp.block_docs), put(fp.block_tfs),
                       put(fp.doc_len))
            elif kind == "vec":
                vc = self.vectors[fname]
                host = vc.vectors.astype(np.float32)
                if vc.similarity == "cosine":
                    # pre-normalize rows at upload: the scoring hot loop
                    # then divides by the query norm only (ops/knn.py)
                    host = host / np.maximum(vc.norms, 1e-20)[:, None]
                out = (put(host).to(torch.bfloat16), put(vc.norms),
                       put(vc.exists))
            elif kind == "num":
                nc = self.numeric[fname]
                out = (put(nc.values.astype(np.float32)), put(nc.exists))
            elif kind == "kw":
                kc = self.keyword[fname]
                out = (put(kc.ords), put(kc.exists))
            else:
                raise KeyError(key)
            self._device[key] = out
            return out

    def ram_bytes(self) -> int:
        total = 0
        for fp in self.postings.values():
            total += fp.block_docs.nbytes + fp.block_tfs.nbytes + fp.doc_len.nbytes
            total += fp.pos_data.nbytes + fp.post_doc.nbytes
        for vc in self.vectors.values():
            total += vc.vectors.nbytes
        for nc in self.numeric.values():
            total += nc.values.nbytes + nc.all_values.nbytes
        for kc in self.keyword.values():
            total += kc.ords.nbytes
        return total


class SegmentBuilder:
    """Accumulates parsed docs and freezes them into a Segment.

    The analog of Lucene's DocumentsWriter + flush: called under the engine's
    refresh (ref: index/engine/InternalEngine.java refresh -> new reader).
    """

    def __init__(self, seg_id: int = 0, device=None):
        self.seg_id = seg_id
        self.device = device
        self._docs: List[LuceneDoc] = []
        self._seq_nos: List[int] = []
        self._versions: List[int] = []

    def add(self, doc: LuceneDoc, seq_no: int = -1, version: int = 1) -> int:
        self._docs.append(doc)
        self._seq_nos.append(seq_no)
        self._versions.append(version)
        return len(self._docs) - 1

    def __len__(self) -> int:
        return len(self._docs)

    def build(self) -> Segment:
        docs = self._docs
        n_docs = len(docs)

        # -- collect field name sets --
        inverted_fields: dict[str, None] = {}
        numeric_fields: dict[str, None] = {}
        keyword_fields: dict[str, None] = {}
        vector_fields: dict[str, None] = {}
        geo_fields: dict[str, None] = {}
        nested_fields: dict[str, None] = {}
        for d in docs:
            for f in d.geo:
                geo_fields[f] = None
            for f in d.nested:
                nested_fields[f] = None
            for f in d.inverted:
                inverted_fields[f] = None
            for f in d.numeric:
                numeric_fields[f] = None
            for f in d.keyword:
                keyword_fields[f] = None
            for f in d.vectors:
                vector_fields[f] = None

        postings = {}
        for fname in inverted_fields:
            postings[fname] = self._build_postings(fname, docs, is_keyword=False)
        # keyword fields are ALSO inverted (term filters run on device blocks)
        for fname in keyword_fields:
            postings.setdefault(fname, self._build_postings(fname, docs, is_keyword=True))

        numeric = {f: self._build_numeric(f, docs) for f in numeric_fields}
        keyword = {f: self._build_keyword(f, docs) for f in keyword_fields}
        vectors = {f: self._build_vectors(f, docs) for f in vector_fields}
        geo = {f: self._build_geo(f, docs) for f in geo_fields}
        nested = {f: self._build_nested(f, docs) for f in nested_fields}

        return Segment(
            seg_id=self.seg_id,
            doc_ids=[d.doc_id for d in docs],
            sources=[d.source for d in docs],
            postings=postings,
            numeric=numeric,
            keyword=keyword,
            vectors=vectors,
            seq_nos=np.asarray(self._seq_nos, np.int64),
            versions=np.asarray(self._versions, np.int64),
            geo=geo,
            nested=nested,
            device=self.device,
        )

    # ---- builders ----

    def _build_postings(self, fname: str, docs: List[LuceneDoc], *, is_keyword: bool) -> FieldPostings:
        # term -> list[(doc_ord, tf, positions)]
        term_postings: Dict[str, list] = {}
        doc_len = np.zeros(len(docs), np.float32)
        for ord_, d in enumerate(docs):
            if is_keyword:
                entries = [(t, [0]) for t in d.keyword.get(fname, ())]
            else:
                entries = d.inverted.get(fname, ())
                doc_len[ord_] = d.field_lengths.get(fname, 0)
            if not entries:
                continue
            # merge duplicate term entries within one doc (multi-valued text)
            merged: Dict[str, list] = {}
            for term, positions in entries:
                merged.setdefault(term, []).extend(positions)
            for term, positions in merged.items():
                term_postings.setdefault(term, []).append((ord_, len(positions), sorted(positions)))

        terms = sorted(term_postings)
        n_terms = len(terms)
        term_to_ord = {t: i for i, t in enumerate(terms)}

        doc_freq = np.zeros(n_terms, np.int32)
        total_tf = np.zeros(n_terms, np.int64)
        block_start = np.zeros(n_terms, np.int32)
        block_count = np.zeros(n_terms, np.int32)

        # count blocks; row 0 reserved for zero padding
        total_blocks = 1
        for i, t in enumerate(terms):
            plist = term_postings[t]
            doc_freq[i] = len(plist)
            total_tf[i] = sum(tf for _, tf, _ in plist)
            nb = (len(plist) + BLOCK - 1) // BLOCK
            block_start[i] = total_blocks
            block_count[i] = nb
            total_blocks += nb

        block_docs = np.zeros((total_blocks, BLOCK), np.int32)
        block_tfs = np.zeros((total_blocks, BLOCK), np.float32)
        block_max_tf = np.zeros(total_blocks, np.float32)

        post_start = np.zeros(n_terms + 1, np.int64)
        post_doc_parts: List[np.ndarray] = []
        pos_counts: List[int] = []
        pos_parts: List[np.ndarray] = []

        for i, t in enumerate(terms):
            plist = term_postings[t]  # already doc-ord sorted (insertion order)
            d_arr = np.fromiter((p[0] for p in plist), np.int32, len(plist))
            tf_arr = np.fromiter((p[1] for p in plist), np.float32, len(plist))
            row = int(block_start[i])
            for off in range(0, len(plist), BLOCK):
                chunk_d = d_arr[off: off + BLOCK]
                chunk_tf = tf_arr[off: off + BLOCK]
                block_docs[row, : len(chunk_d)] = chunk_d
                block_tfs[row, : len(chunk_tf)] = chunk_tf
                block_max_tf[row] = float(chunk_tf.max()) if len(chunk_tf) else 0.0
                row += 1
            post_start[i + 1] = post_start[i] + len(plist)
            post_doc_parts.append(d_arr)
            for p in plist:
                pos_counts.append(len(p[2]))
                pos_parts.append(np.asarray(p[2], np.int32))

        post_doc = np.concatenate(post_doc_parts) if post_doc_parts else np.empty(0, np.int32)
        pos_start = np.zeros(len(post_doc) + 1, np.int64)
        if pos_counts:
            np.cumsum(pos_counts, out=pos_start[1:])
        pos_data = np.concatenate(pos_parts) if pos_parts else np.empty(0, np.int32)

        return FieldPostings(
            field=fname,
            term_to_ord=term_to_ord,
            terms=terms,
            doc_freq=doc_freq,
            total_term_freq=total_tf,
            block_start=block_start,
            block_count=block_count,
            block_docs=block_docs,
            block_tfs=block_tfs,
            block_max_tf=block_max_tf,
            post_start=post_start,
            post_doc=post_doc,
            pos_start=pos_start,
            pos_data=pos_data,
            doc_len=doc_len,
            sum_doc_len=float(doc_len.sum()),
        )

    def _build_nested(self, fname: str, docs: List[LuceneDoc]) -> "NestedTable":
        child_builder = SegmentBuilder(seg_id=0, device=self.device)
        parent_of: List[int] = []
        child_start = np.zeros(len(docs) + 1, np.int64)
        for i, d in enumerate(docs):
            child_start[i] = len(parent_of)
            for child in d.nested.get(fname, ()):
                child_builder.add(child, seq_no=-1)
                parent_of.append(i)
        child_start[len(docs)] = len(parent_of)
        return NestedTable(child=child_builder.build(),
                           parent_of=np.asarray(parent_of, np.int32),
                           child_start=child_start)

    def _build_geo(self, fname: str, docs: List[LuceneDoc]) -> "GeoColumn":
        n = len(docs)
        exists = np.zeros(n, bool)
        starts = np.zeros(n + 1, np.int64)
        lat_parts: List[float] = []
        lon_parts: List[float] = []
        for i, d in enumerate(docs):
            pts = d.geo.get(fname)
            starts[i] = len(lat_parts)
            if pts:
                exists[i] = True
                for la, lo in pts:
                    lat_parts.append(la)
                    lon_parts.append(lo)
        starts[n] = len(lat_parts)
        return GeoColumn(lat=np.asarray(lat_parts, np.float64),
                         lon=np.asarray(lon_parts, np.float64),
                         value_start=starts, exists=exists)

    def _build_numeric(self, fname: str, docs: List[LuceneDoc]) -> NumericColumn:
        n = len(docs)
        values = np.zeros(n, np.float64)
        max_values = np.zeros(n, np.float64)
        exists = np.zeros(n, bool)
        starts = np.zeros(n + 1, np.int64)
        all_parts: List[np.ndarray] = []
        total = 0
        for i, d in enumerate(docs):
            vs = d.numeric.get(fname)
            starts[i] = total
            if vs:
                arr = np.sort(np.asarray(vs, np.float64))
                values[i] = arr[0]
                max_values[i] = arr[-1]
                exists[i] = True
                all_parts.append(arr)
                total += len(arr)
        starts[n] = total
        all_values = np.concatenate(all_parts) if all_parts else np.empty(0, np.float64)
        return NumericColumn(values=values, max_values=max_values, exists=exists,
                             value_start=starts, all_values=all_values)

    def _build_keyword(self, fname: str, docs: List[LuceneDoc]) -> KeywordColumn:
        n = len(docs)
        vocab: dict[str, None] = {}
        for d in docs:
            for v in d.keyword.get(fname, ()):
                vocab[v] = None
        terms = sorted(vocab)
        term_to_ord = {t: i for i, t in enumerate(terms)}
        ords = np.full(n, -1, np.int32)
        max_ords = np.full(n, -1, np.int32)
        exists = np.zeros(n, bool)
        ord_start = np.zeros(n + 1, np.int64)
        all_parts: List[np.ndarray] = []
        total = 0
        for i, d in enumerate(docs):
            vs = d.keyword.get(fname)
            ord_start[i] = total
            if vs:
                os_ = sorted({term_to_ord[v] for v in vs})
                ords[i] = os_[0]
                max_ords[i] = os_[-1]
                exists[i] = True
                all_parts.append(np.asarray(os_, np.int32))
                total += len(os_)
        ord_start[n] = total
        all_ords = np.concatenate(all_parts) if all_parts else np.empty(0, np.int32)
        return KeywordColumn(terms=terms, term_to_ord=term_to_ord, ords=ords,
                             max_ords=max_ords, exists=exists,
                             ord_start=ord_start, all_ords=all_ords)

    def _build_vectors(self, fname: str, docs: List[LuceneDoc]) -> VectorColumn:
        n = len(docs)
        dims = 0
        sim = "cosine"
        for d in docs:
            v = d.vectors.get(fname)
            if v is not None:
                dims = len(v)
                break
        vectors = np.zeros((n, max(dims, 1)), np.float32)
        exists = np.zeros(n, bool)
        for i, d in enumerate(docs):
            v = d.vectors.get(fname)
            if v is not None:
                vectors[i] = v
                exists[i] = True
        norms = np.linalg.norm(vectors, axis=1).astype(np.float32)
        return VectorColumn(vectors=vectors, norms=norms, exists=exists, dims=dims, similarity=sim)


# --------------------------------------------------------------------------
# Columnar segment merge
# --------------------------------------------------------------------------


def merge_segments(segments: List[Segment], live_masks: List[np.ndarray],
                   seg_id: int, device=None) -> Segment:
    """Compact segments into one by RECOMBINING columnar data directly —
    no _source re-parse, no re-analysis (ref: Lucene SegmentMerger, which
    likewise concatenates postings/doc values with ord remaps; VERDICT r2
    weak #9 called the re-parse merge unusable at 1M+ docs).

    Dead docs are dropped; surviving docs keep their relative order
    (segment-major), so per-term postings stay doc-ascending after the
    remap and block arrays rebuild vectorized. The merged segment lives
    on `device`."""
    keeps = [np.asarray(m, bool) for m in live_masks]
    bases: List[int] = []
    ord_maps: List[np.ndarray] = []
    total = 0
    for seg, keep in zip(segments, keeps):
        bases.append(total)
        m = np.cumsum(keep) - 1 + total
        ord_maps.append(m.astype(np.int64))
        total += int(keep.sum())

    doc_ids: List[str] = []
    sources: List[dict] = []
    seq_parts, ver_parts = [], []
    for seg, keep in zip(segments, keeps):
        idx = np.nonzero(keep)[0]
        doc_ids.extend(seg.doc_ids[i] for i in idx)
        sources.extend(seg.sources[i] for i in idx)
        seq_parts.append(seg.seq_nos[idx])
        ver_parts.append(seg.versions[idx])

    fields = {}
    for seg in segments:
        for name in seg.postings:
            fields[name] = None
    postings = {f: _merge_postings(f, segments, keeps, ord_maps, total)
                for f in fields}
    num_fields = {n: None for seg in segments for n in seg.numeric}
    numeric = {f: _merge_numeric(f, segments, keeps, total) for f in num_fields}
    kw_fields = {n: None for seg in segments for n in seg.keyword}
    keyword = {f: _merge_keyword(f, segments, keeps, total) for f in kw_fields}
    vec_fields = {n: None for seg in segments for n in seg.vectors}
    vectors = {f: _merge_vectors(f, segments, keeps, total) for f in vec_fields}
    geo_fields = {n: None for seg in segments for n in seg.geo}
    geo = {f: _merge_geo(f, segments, keeps, total) for f in geo_fields}
    nested_fields = {n: None for seg in segments for n in seg.nested}
    nested = {f: _merge_nested(f, segments, keeps, total, device)
              for f in nested_fields}

    return Segment(
        seg_id=seg_id, doc_ids=doc_ids, sources=sources, postings=postings,
        numeric=numeric, keyword=keyword, vectors=vectors,
        seq_nos=np.concatenate(seq_parts) if seq_parts else np.empty(0, np.int64),
        versions=np.concatenate(ver_parts) if ver_parts else np.empty(0, np.int64),
        geo=geo, nested=nested, device=device,
    )


def _merge_csr(keep: np.ndarray, value_start: np.ndarray, base: int):
    """Shared CSR recombination: (per-kept-doc new start offsets, flat take
    mask over the values, number of surviving values)."""
    counts = (value_start[1:] - value_start[:-1])[keep]
    n = len(counts)
    starts = base + (np.concatenate([[0], np.cumsum(counts)[:-1]])
                     if n else np.empty(0, np.int64))
    take = np.repeat(keep, value_start[1:] - value_start[:-1])
    return starts.astype(np.int64), take, int(counts.sum())


def _posting_tf(fp: FieldPostings) -> np.ndarray:
    """Per-posting tf aligned with post_doc, gathered from block lanes."""
    n = len(fp.post_doc)
    if n == 0:
        return np.empty(0, np.float32)
    df = fp.doc_freq.astype(np.int64)
    within = np.arange(n, dtype=np.int64) - np.repeat(
        fp.post_start[:-1], df)
    lane_ids = np.repeat(fp.block_start.astype(np.int64) * BLOCK, df) + within
    return fp.block_tfs.ravel()[lane_ids]


def _merge_postings(field: str, segments, keeps, ord_maps, total: int
                    ) -> FieldPostings:
    # union over terms with at least one SURVIVING posting — dead-only
    # terms must not accumulate across merge generations
    term_arrays = []
    for seg, keep in zip(segments, keeps):
        fp = seg.postings.get(field)
        if fp is not None and fp.terms and len(fp.post_doc):
            local = np.repeat(np.arange(len(fp.terms), dtype=np.int64),
                              fp.doc_freq.astype(np.int64))
            live_locals = np.unique(local[keep[fp.post_doc]])
            if len(live_locals):
                term_arrays.append(
                    np.asarray(fp.terms, object)[live_locals])
    union = np.unique(np.concatenate(term_arrays)) if term_arrays \
        else np.empty(0, object)
    term_names = [str(t) for t in union]

    tp, dp_, fp_parts, pc_parts, pd_parts, dl_parts = [], [], [], [], [], []
    has_positions = True
    for seg, keep, omap in zip(segments, keeps, ord_maps):
        fp = seg.postings.get(field)
        if fp is None:
            dl_parts.append(np.zeros(int(keep.sum()), np.float32))
            continue
        dl_parts.append(fp.doc_len[keep])
        if len(fp.post_doc) == 0:
            continue
        g_ord = np.searchsorted(union, np.asarray(fp.terms, object))
        per_post_term = np.repeat(g_ord.astype(np.int64),
                                  fp.doc_freq.astype(np.int64))
        live_post = keep[fp.post_doc]
        pos_counts = (fp.pos_start[1:] - fp.pos_start[:-1]).astype(np.int64)
        if len(fp.pos_data) == 0 and int(fp.total_term_freq.sum()) > 0:
            has_positions = False
        tp.append(per_post_term[live_post])
        dp_.append(omap[fp.post_doc[live_post]])
        fp_parts.append(_posting_tf(fp)[live_post])
        pc_parts.append(pos_counts[live_post])
        pd_parts.append(fp.pos_data[np.repeat(live_post, pos_counts)])

    if tp:
        term_all = np.concatenate(tp)
        doc_all = np.concatenate(dp_)
        tf_all = np.concatenate(fp_parts)
        pc_all = np.concatenate(pc_parts)
        pd_all = np.concatenate(pd_parts)
        # postings must sort by (term, doc); docs ascend within a segment
        # and segments concatenate in base order, so a stable sort on term
        # alone would suffice — lexsort keeps it explicit
        order = np.lexsort((doc_all, term_all))
        term_all, doc_all, tf_all = term_all[order], doc_all[order], tf_all[order]
        # reorder the ragged positions with the postings
        pc_sorted = pc_all[order]
        pos_of = np.zeros(len(pc_all) + 1, np.int64)
        np.cumsum(pc_all, out=pos_of[1:])
        take_val, _ = _ragged_gather(pos_of[order], pos_of[order] + pc_sorted,
                                     pd_all)
        pd_all, pc_all = take_val, pc_sorted
    else:
        term_all = np.empty(0, np.int64)
        doc_all = np.empty(0, np.int64)
        tf_all = np.empty(0, np.float32)
        pc_all = np.empty(0, np.int64)
        pd_all = np.empty(0, np.int32)

    return _assemble_postings(field, total, term_names, term_all, doc_all,
                              tf_all, pc_all, pd_all,
                              np.concatenate(dl_parts) if dl_parts
                              else np.zeros(total, np.float32),
                              has_positions)


def _ragged_gather(starts, ends, data):
    lens = (ends - starts).astype(np.int64)
    n = int(lens.sum())
    if n == 0:
        return np.empty(0, data.dtype), np.empty(0, np.int64)
    row = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    flat = starts[row] + (np.arange(n, dtype=np.int64) - first[row])
    return data[flat], row


def _assemble_postings(field: str, n_docs: int, term_names: List[str],
                       term_ord, doc_ord, tf, pos_counts, pos_data,
                       doc_len, has_positions: bool) -> FieldPostings:
    """Block-array assembly from sorted (term, doc, tf) postings — the
    shared back half of build_field_postings, taking explicit tf/positions
    instead of raw tokens."""
    n_terms = len(term_names)
    term_ord = term_ord.astype(np.int64)
    doc_ord = doc_ord.astype(np.int64)
    tf = tf.astype(np.float32)

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

    post_start = np.zeros(n_terms + 1, np.int64)
    post_start[1:] = term_offsets[1:]
    total_tf = np.zeros(n_terms, np.int64)
    nz = doc_freq > 0
    if nz.any():
        total_tf[nz] = np.add.reduceat(tf.astype(np.int64),
                                       term_offsets[:-1][nz])

    pos_start = np.zeros(len(term_ord) + 1, np.int64)
    if has_positions and len(pos_counts):
        np.cumsum(pos_counts, out=pos_start[1:])
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
        post_start=post_start,
        post_doc=doc_ord.astype(np.int32),
        pos_start=pos_start,
        pos_data=pos_data.astype(np.int32),
        doc_len=doc_len.astype(np.float32),
        sum_doc_len=float(doc_len.sum()),
    )


def _merge_numeric(field: str, segments, keeps, total: int) -> NumericColumn:
    values = np.zeros(total, np.float64)
    max_values = np.zeros(total, np.float64)
    exists = np.zeros(total, bool)
    starts = np.zeros(total + 1, np.int64)
    val_parts = []
    off = 0
    vtotal = 0
    for seg, keep in zip(segments, keeps):
        n = int(keep.sum())
        col = seg.numeric.get(field)
        if col is not None:
            values[off: off + n] = col.values[keep]
            max_values[off: off + n] = col.max_values[keep]
            exists[off: off + n] = col.exists[keep]
            s, take, nv = _merge_csr(keep, col.value_start, vtotal)
            starts[off: off + n] = s
            val_parts.append(col.all_values[take])
            vtotal += nv
        else:
            starts[off: off + n] = vtotal
        off += n
    starts[total] = vtotal
    return NumericColumn(values=values, max_values=max_values, exists=exists,
                         value_start=starts,
                         all_values=np.concatenate(val_parts) if val_parts
                         else np.empty(0, np.float64))


def _merge_keyword(field: str, segments, keeps, total: int) -> KeywordColumn:
    # union over terms that SURVIVE on at least one live doc (dead-only
    # terms would otherwise accumulate across merge generations)
    live_term_arrays = []
    for seg, keep in zip(segments, keeps):
        kc = seg.keyword.get(field)
        if kc is not None and kc.terms:
            _, take, _ = _merge_csr(keep, kc.ord_start, 0)
            live = np.unique(kc.all_ords[take])
            if len(live):
                live_term_arrays.append(
                    np.asarray(kc.terms, object)[live])
    union = np.unique(np.concatenate(live_term_arrays)) \
        if live_term_arrays else np.empty(0, object)
    terms = [str(t) for t in union]
    ords = np.full(total, -1, np.int32)
    max_ords = np.full(total, -1, np.int32)
    exists = np.zeros(total, bool)
    ord_start = np.zeros(total + 1, np.int64)
    parts = []
    off = 0
    vtotal = 0
    for seg, keep in zip(segments, keeps):
        n = int(keep.sum())
        kc = seg.keyword.get(field)
        if kc is not None and kc.terms:
            remap = np.searchsorted(union, np.asarray(kc.terms, object)
                                    ).astype(np.int32)
            old = kc.ords[keep]
            ords[off: off + n] = np.where(old >= 0, remap[np.maximum(old, 0)], -1)
            oldm = kc.max_ords[keep]
            max_ords[off: off + n] = np.where(oldm >= 0,
                                              remap[np.maximum(oldm, 0)], -1)
            exists[off: off + n] = kc.exists[keep]
            s, take, nv = _merge_csr(keep, kc.ord_start, vtotal)
            ord_start[off: off + n] = s
            parts.append(remap[kc.all_ords[take]])
            vtotal += nv
        else:
            ord_start[off: off + n] = vtotal
        off += n
    ord_start[total] = vtotal
    return KeywordColumn(terms=terms,
                         term_to_ord={t: i for i, t in enumerate(terms)},
                         ords=ords, max_ords=max_ords, exists=exists,
                         ord_start=ord_start,
                         all_ords=np.concatenate(parts) if parts
                         else np.empty(0, np.int32))


def _merge_vectors(field: str, segments, keeps, total: int) -> VectorColumn:
    dims = 1
    sim = "cosine"
    for seg in segments:
        vc = seg.vectors.get(field)
        if vc is not None and vc.dims:
            dims, sim = vc.dims, vc.similarity
            break
    vectors = np.zeros((total, max(dims, 1)), np.float32)
    norms = np.zeros(total, np.float32)
    exists = np.zeros(total, bool)
    off = 0
    for seg, keep in zip(segments, keeps):
        n = int(keep.sum())
        vc = seg.vectors.get(field)
        if vc is not None and vc.dims == dims:
            vectors[off: off + n] = vc.vectors[keep]
            norms[off: off + n] = vc.norms[keep]
            exists[off: off + n] = vc.exists[keep]
        off += n
    return VectorColumn(vectors=vectors, norms=norms, exists=exists,
                        dims=dims, similarity=sim)


def _merge_geo(field: str, segments, keeps, total: int) -> GeoColumn:
    lat_parts, lon_parts = [], []
    exists = np.zeros(total, bool)
    starts = np.zeros(total + 1, np.int64)
    off = 0
    vtotal = 0
    for seg, keep in zip(segments, keeps):
        n = int(keep.sum())
        gc = seg.geo.get(field)
        if gc is not None:
            exists[off: off + n] = gc.exists[keep]
            s, take, nv = _merge_csr(keep, gc.value_start, vtotal)
            starts[off: off + n] = s
            lat_parts.append(gc.lat[take])
            lon_parts.append(gc.lon[take])
            vtotal += nv
        else:
            starts[off: off + n] = vtotal
        off += n
    starts[total] = vtotal
    return GeoColumn(
        lat=np.concatenate(lat_parts) if lat_parts else np.empty(0, np.float64),
        lon=np.concatenate(lon_parts) if lon_parts else np.empty(0, np.float64),
        value_start=starts, exists=exists)


def _merge_nested(field: str, segments, keeps, total: int,
                  device) -> NestedTable:
    child_segs, child_keeps = [], []
    parent_parts = []
    child_start = np.zeros(total + 1, np.int64)
    off = 0
    ctotal = 0
    for seg, keep in zip(segments, keeps):
        n = int(keep.sum())
        nt = seg.nested.get(field)
        if nt is not None:
            s, ckeep, nc = _merge_csr(keep, nt.child_start, ctotal)
            child_start[off: off + n] = s
            child_segs.append(nt.child)
            child_keeps.append(ckeep)
            omap = np.cumsum(keep) - 1 + off
            parent_parts.append(omap[nt.parent_of[ckeep]])
            ctotal += nc
        else:
            child_start[off: off + n] = ctotal
        off += n
    child_start[total] = ctotal
    merged_child = merge_segments(child_segs, child_keeps, seg_id=0,
                                  device=device) \
        if child_segs else SegmentBuilder(device=device).build()
    return NestedTable(child=merged_child,
                       parent_of=np.concatenate(parent_parts).astype(np.int32)
                       if parent_parts else np.empty(0, np.int32),
                       child_start=child_start)
