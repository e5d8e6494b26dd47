"""Data-only segment serialization: JSON header + raw numpy arrays.

Replaces pickle for every path where segment bytes cross a trust boundary —
snapshot repositories (an arbitrary, shareable directory; ref:
repositories/blobstore/BlobStoreRepository.java stores data-only formats),
peer-recovery file transfers, and on-disk commits. Deserialization never
executes code: arrays load with ``allow_pickle=False`` and everything else
is JSON.

Blob layout (v3, written since the integrity plane)::

    b"ESTPUSEG3" | u64 header_len | header JSON (utf-8) | npz payload
                 | sha256(header_len .. payload) footer (32 bytes)

The header carries structure (which fields exist, term dictionaries,
doc ids, sources); the npz payload carries every numpy array keyed by a
flat path (nested child segments recurse with a ``nested.<name>/`` key
prefix). The trailing footer is the at-rest integrity leg (ref: Lucene's
per-file CodecUtil.writeFooter checksum): `segment_from_blob` re-hashes
on EVERY read and raises `SegmentCorruptedError` on mismatch. v2 blobs
(no footer) remain readable — verification is skipped and the read is
counted under `legacy_blobs_read`.

The port's copy of elasticsearch_tpu/index/segment_io.py: the blob format
is the same, so a segment the reference wrote loads here unchanged and the
other way round. A rebuilt segment lives on the device its caller names
(`segment_from_blob(blob, device)`). `segment_from_arrays` builds a port
segment from the numpy arrays of a reference `Segment` (the same header
and arrays `segment_to_blob` would write, without the bytes).
"""

from __future__ import annotations

import hashlib
import io
import json
from typing import Dict

import numpy as np

MAGIC = b"ESTPUSEG3"
MAGIC_V2 = b"ESTPUSEG2"    # pre-integrity blobs: readable, unverifiable
_FOOTER_LEN = 32           # sha256 digest size


def _put_field_postings(fp, prefix: str, arrays: Dict[str, np.ndarray],
                        meta: dict) -> None:
    meta["terms"] = fp.terms
    meta["sum_doc_len"] = float(fp.sum_doc_len)
    for name in ("doc_freq", "total_term_freq", "block_start", "block_count",
                 "block_docs", "block_tfs", "block_max_tf", "post_start",
                 "post_doc", "pos_start", "pos_data", "doc_len"):
        arrays[prefix + name] = getattr(fp, name)


def _get_field_postings(field: str, prefix: str, arrays, meta: dict):
    from elasticsearch_tpu_torch.index.segment import FieldPostings

    terms = list(meta["terms"])
    kw = {name: np.asarray(arrays[prefix + name])
          for name in ("doc_freq", "total_term_freq", "block_start",
                       "block_count", "block_docs", "block_tfs",
                       "block_max_tf", "post_start", "post_doc", "pos_start",
                       "pos_data", "doc_len")}
    return FieldPostings(field=field, term_to_ord={t: i for i, t in enumerate(terms)},
                         terms=terms, sum_doc_len=float(meta["sum_doc_len"]), **kw)


def _flatten_segment(seg, prefix: str, arrays: Dict[str, np.ndarray]) -> dict:
    meta: dict = {
        "seg_id": int(seg.seg_id),
        "doc_ids": list(seg.doc_ids),
        "sources": list(seg.sources),
        "postings": {},
        "numeric": sorted(seg.numeric),
        "keyword": {},
        "vectors": {},
        "geo": sorted(seg.geo),
        "nested": {},
    }
    arrays[prefix + "seq_nos"] = seg.seq_nos
    arrays[prefix + "versions"] = seg.versions
    for field, fp in seg.postings.items():
        fmeta: dict = {}
        _put_field_postings(fp, f"{prefix}post.{field}/", arrays, fmeta)
        meta["postings"][field] = fmeta
    for field, nc in seg.numeric.items():
        p = f"{prefix}num.{field}/"
        arrays[p + "values"] = nc.values
        arrays[p + "max_values"] = nc.max_values
        arrays[p + "exists"] = nc.exists
        arrays[p + "value_start"] = nc.value_start
        arrays[p + "all_values"] = nc.all_values
    for field, kc in seg.keyword.items():
        p = f"{prefix}kw.{field}/"
        meta["keyword"][field] = {"terms": kc.terms}
        arrays[p + "ords"] = kc.ords
        arrays[p + "max_ords"] = kc.max_ords
        arrays[p + "exists"] = kc.exists
        arrays[p + "ord_start"] = kc.ord_start
        arrays[p + "all_ords"] = kc.all_ords
    for field, vc in seg.vectors.items():
        p = f"{prefix}vec.{field}/"
        meta["vectors"][field] = {"dims": int(vc.dims),
                                  "similarity": vc.similarity}
        arrays[p + "vectors"] = vc.vectors
        arrays[p + "norms"] = vc.norms
        arrays[p + "exists"] = vc.exists
    for field, gc in seg.geo.items():
        p = f"{prefix}geo.{field}/"
        arrays[p + "lat"] = gc.lat
        arrays[p + "lon"] = gc.lon
        arrays[p + "value_start"] = gc.value_start
        arrays[p + "exists"] = gc.exists
    for field, nt in seg.nested.items():
        p = f"{prefix}nested.{field}/"
        child_meta = _flatten_segment(nt.child, p + "child/", arrays)
        arrays[p + "parent_of"] = nt.parent_of
        arrays[p + "child_start"] = nt.child_start
        meta["nested"][field] = child_meta
    return meta


def _rebuild_segment(meta: dict, prefix: str, arrays, device):
    from elasticsearch_tpu_torch.index.segment import (
        GeoColumn, KeywordColumn, NestedTable, NumericColumn, Segment,
        VectorColumn,
    )

    postings = {f: _get_field_postings(f, f"{prefix}post.{f}/", arrays, m)
                for f, m in meta["postings"].items()}
    numeric = {}
    for f in meta["numeric"]:
        p = f"{prefix}num.{f}/"
        numeric[f] = NumericColumn(
            values=np.asarray(arrays[p + "values"]),
            max_values=np.asarray(arrays[p + "max_values"]),
            exists=np.asarray(arrays[p + "exists"]),
            value_start=np.asarray(arrays[p + "value_start"]),
            all_values=np.asarray(arrays[p + "all_values"]))
    keyword = {}
    for f, km in meta["keyword"].items():
        p = f"{prefix}kw.{f}/"
        terms = list(km["terms"])
        keyword[f] = KeywordColumn(
            terms=terms, term_to_ord={t: i for i, t in enumerate(terms)},
            ords=np.asarray(arrays[p + "ords"]),
            max_ords=np.asarray(arrays[p + "max_ords"]),
            exists=np.asarray(arrays[p + "exists"]),
            ord_start=np.asarray(arrays[p + "ord_start"]),
            all_ords=np.asarray(arrays[p + "all_ords"]))
    vectors = {}
    for f, vm in meta["vectors"].items():
        p = f"{prefix}vec.{f}/"
        vectors[f] = VectorColumn(
            vectors=np.asarray(arrays[p + "vectors"]),
            norms=np.asarray(arrays[p + "norms"]),
            exists=np.asarray(arrays[p + "exists"]),
            dims=int(vm["dims"]), similarity=vm["similarity"])
    geo = {}
    for f in meta["geo"]:
        p = f"{prefix}geo.{f}/"
        geo[f] = GeoColumn(
            lat=np.asarray(arrays[p + "lat"]),
            lon=np.asarray(arrays[p + "lon"]),
            value_start=np.asarray(arrays[p + "value_start"]),
            exists=np.asarray(arrays[p + "exists"]))
    nested = {}
    for f, child_meta in meta["nested"].items():
        p = f"{prefix}nested.{f}/"
        nested[f] = NestedTable(
            child=_rebuild_segment(child_meta, p + "child/", arrays, device),
            parent_of=np.asarray(arrays[p + "parent_of"]),
            child_start=np.asarray(arrays[p + "child_start"]))
    return Segment(
        seg_id=int(meta["seg_id"]), doc_ids=list(meta["doc_ids"]),
        sources=list(meta["sources"]), postings=postings, numeric=numeric,
        keyword=keyword, vectors=vectors,
        seq_nos=np.asarray(arrays[prefix + "seq_nos"]),
        versions=np.asarray(arrays[prefix + "versions"]),
        geo=geo, nested=nested, device=device)


def segment_to_blob(seg) -> bytes:
    """Serialize a Segment to a self-contained data-only blob."""
    arrays: Dict[str, np.ndarray] = {}
    meta = _flatten_segment(seg, "", arrays)
    # field names may contain any character; npz keys are positional
    # (`a<i>`) and the header maps real key -> position, so no escaping
    # scheme can collide
    names = sorted(arrays)
    meta["__array_names__"] = names
    header = json.dumps(meta).encode()
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": arrays[name] for i, name in enumerate(names)})
    payload = buf.getvalue()
    body = len(header).to_bytes(8, "big") + header + payload
    return MAGIC + body + hashlib.sha256(body).digest()


def blob_hash(blob: bytes) -> str:
    """Hex sha256 of the whole wire blob — what recovery sources advertise
    next to each segment payload so the target can verify before install."""
    return hashlib.sha256(blob).hexdigest()


def verify_blob(blob: bytes) -> None:
    """Re-hash a v3 blob against its footer; raise on mismatch.

    v2 blobs pass (nothing to verify against); anything else — truncation,
    bad magic, footer mismatch — raises `SegmentCorruptedError`."""
    from elasticsearch_tpu_torch.common.integrity import SegmentCorruptedError

    from elasticsearch_tpu_torch.common import integrity

    if blob.startswith(MAGIC_V2):
        return
    if not blob.startswith(MAGIC) or len(blob) < len(MAGIC) + 8 + _FOOTER_LEN:
        integrity.count("segments_corrupted")
        raise SegmentCorruptedError(
            "not a segment blob (bad magic or truncated)")
    body, footer = blob[len(MAGIC):-_FOOTER_LEN], blob[-_FOOTER_LEN:]
    digest = hashlib.sha256(body).digest()
    if digest != footer:
        integrity.count("segments_corrupted")
        raise SegmentCorruptedError(
            f"segment blob failed checksum verification: footer "
            f"{footer.hex()[:16]}.. != computed {digest.hex()[:16]}..")
    integrity.count("segments_verified")
    integrity.count("bytes_verified", len(blob))


def segment_from_blob(blob: bytes, device=None):
    """Rebuild a Segment on `device` from a blob, verifying the checksum
    footer on every read. Never unpickles."""
    from elasticsearch_tpu_torch.common import integrity

    if blob.startswith(MAGIC_V2):
        # pre-footer blob: parseable but unverifiable (counted, so fleets
        # can watch the legacy population drain as segments rewrite)
        integrity.count("legacy_blobs_read")
        magic, end = MAGIC_V2, len(blob)
    elif blob.startswith(MAGIC):
        verify_blob(blob)
        magic, end = MAGIC, len(blob) - _FOOTER_LEN
    else:
        raise ValueError(
            "not a segment blob (bad magic); refusing to parse — legacy "
            "pickled segments are unsupported (reindex from source)")
    hlen = int.from_bytes(blob[len(magic): len(magic) + 8], "big")
    off = len(magic) + 8
    meta = json.loads(blob[off: off + hlen].decode())
    npz = np.load(io.BytesIO(blob[off + hlen: end]), allow_pickle=False)
    names = meta.pop("__array_names__")
    arrays = {name: npz[f"a{i}"] for i, name in enumerate(names)}
    return _rebuild_segment(meta, "", arrays, device)


def segment_from_arrays(seg, device=None):
    """The port's Segment on `device` over the arrays of `seg`, a segment
    of either package (the reference's included): the header and arrays
    `segment_to_blob` would serialize, rebuilt without the bytes. Arrays
    are shared with `seg`, not copied; the header goes through JSON as in
    a blob, so `_source` dicts are copies."""
    arrays: Dict[str, np.ndarray] = {}
    meta = json.loads(json.dumps(_flatten_segment(seg, "", arrays)))
    return _rebuild_segment(meta, "", arrays, device)
