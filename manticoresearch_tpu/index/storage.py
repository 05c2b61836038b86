"""Index persistence.

Behavioral model: the reference's index files (.sph header + data files,
sphinx.cpp:859-877) and the RT-mode manifest (manticore.json,
searchdconfig.cpp:481). Device redesign: one npz of SoA arrays + a JSON header
per index/segment — the arrays are already in device layout, so loading is
mmap + device upload with no decode step.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..schema import Schema
from ..text.dictionary import DictSettings
from ..text.tokenizer import TokenizerSettings
from .builder import PackedIndex

FORMAT_VERSION = 1


def _settings_to_json(tok: TokenizerSettings, dic: DictSettings) -> dict:
    return {
        "tokenizer": {
            "charset_table": tok.charset_table,
            "min_word_len": tok.min_word_len,
            "ngram_chars": tok.ngram_chars,
            "ngram_len": tok.ngram_len,
            "overshort_step": tok.overshort_step,
            "index_sp": tok.index_sp,
            "html_strip": tok.html_strip,
            "html_remove_elements": list(tok.html_remove_elements),
            "html_index_attrs": tok.html_index_attrs,
            "index_zones": list(tok.index_zones),
        },
        "dict": {
            "stopwords": sorted(dic.stopwords),
            "morphology": list(dic.morphology),
            "wordforms": [list(p) for p in dic.wordforms],
            "index_exact_words": dic.index_exact_words,
            "min_stemming_len": dic.min_stemming_len,
        },
    }


def _settings_from_json(d: dict):
    t = d["tokenizer"]
    s = d["dict"]
    return (
        TokenizerSettings(
            charset_table=t["charset_table"], min_word_len=t["min_word_len"],
            ngram_chars=t["ngram_chars"], ngram_len=t["ngram_len"],
            overshort_step=t["overshort_step"],
            index_sp=t.get("index_sp", False),
            html_strip=t.get("html_strip", False),
            html_remove_elements=tuple(t.get("html_remove_elements", [])),
            html_index_attrs=t.get("html_index_attrs", ""),
            index_zones=tuple(t.get("index_zones", [])),
        ),
        DictSettings(
            stopwords=frozenset(s["stopwords"]),
            morphology=tuple(s["morphology"]),
            wordforms=tuple(tuple(p) for p in s["wordforms"]),
            index_exact_words=s["index_exact_words"],
            min_stemming_len=s["min_stemming_len"],
        ),
    )


def save_packed(packed: PackedIndex, path: str) -> None:
    """Write header.json + arrays.npz + strings.json under `path`/."""
    os.makedirs(path, exist_ok=True)
    header = {
        "version": FORMAT_VERSION,
        "schema": packed.schema.to_json(),
        "n_docs": packed.n_docs,
        "total_hits": packed.total_hits,
        "settings": _settings_to_json(packed.tokenizer_settings,
                                      packed.dict_settings),
        "mva_names": sorted(packed.attrs_mva),
        "zone_names": sorted(packed.zones),
    }
    with open(os.path.join(path, "header.json"), "w") as f:
        json.dump(header, f)
    arrays = {
        "doc_ids": packed.doc_ids,
        "term_offsets": packed.term_offsets,
        "term_docs": packed.term_docs,
        "term_hits": packed.term_hits,
        "post_rowid": packed.post_rowid,
        "post_tf": packed.post_tf,
        "post_tfq": packed.post_tfq,
        "post_fieldmask": packed.post_fieldmask,
        "post_hit_offset": packed.post_hit_offset,
        "hit_packed": packed.hit_packed,
        "field_lens": packed.field_lens,
        "sent_rowid": packed.sent_rowid,
        "sent_pkey": packed.sent_pkey,
        "para_rowid": packed.para_rowid,
        "para_pkey": packed.para_pkey,
    }
    for k, v in packed.attrs_int.items():
        arrays[f"ai__{k}"] = v
    for k, v in packed.attrs_big.items():
        arrays[f"ab__{k}"] = v
    for k, v in packed.attrs_float.items():
        arrays[f"af__{k}"] = v
    for k, (off, vals) in packed.attrs_mva.items():
        arrays[f"amo__{k}"] = off
        arrays[f"amv__{k}"] = vals
    for k, (zr, zs, ze) in packed.zones.items():
        arrays[f"zr__{k}"] = zr
        arrays[f"zs__{k}"] = zs
        arrays[f"ze__{k}"] = ze
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    side = {
        "terms": packed.term_strs,
        "attrs_str": {k: list(v) for k, v in packed.attrs_str.items()},
        "attrs_json": packed.attrs_json,
    }
    with open(os.path.join(path, "strings.json"), "w") as f:
        json.dump(side, f)
    # stored field text goes to the blocked compressed docstore
    # (docstore.cpp:50-181 analog), loaded lazily per block
    from .docstore import save_docstore
    save_docstore(packed.stored_fields, os.path.join(path, "docstore.bin"))


def load_packed(path: str) -> PackedIndex:
    with open(os.path.join(path, "header.json")) as f:
        header = json.load(f)
    if header["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported index format v{header['version']}")
    z = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "strings.json")) as f:
        side = json.load(f)
    tok, dic = _settings_from_json(header["settings"])
    attrs_int, attrs_big, attrs_float, attrs_mva = {}, {}, {}, {}
    for k in z.files:
        if k.startswith("ai__"):
            attrs_int[k[4:]] = z[k]
        elif k.startswith("ab__"):
            attrs_big[k[4:]] = z[k]
        elif k.startswith("af__"):
            attrs_float[k[4:]] = z[k]
        elif k.startswith("amo__"):
            attrs_mva.setdefault(k[5:], [None, None])[0] = z[k]
        elif k.startswith("amv__"):
            attrs_mva.setdefault(k[5:], [None, None])[1] = z[k]
    return PackedIndex(
        schema=Schema.from_json(header["schema"]),
        n_docs=header["n_docs"],
        doc_ids=z["doc_ids"],
        term_strs=side["terms"],
        term_offsets=z["term_offsets"],
        term_docs=z["term_docs"],
        term_hits=z["term_hits"],
        post_rowid=z["post_rowid"],
        post_tf=z["post_tf"],
        post_tfq=z["post_tfq"],
        post_fieldmask=z["post_fieldmask"],
        post_hit_offset=z["post_hit_offset"],
        hit_packed=z["hit_packed"],
        sent_rowid=z.get("sent_rowid", np.zeros(0, np.int32)),
        sent_pkey=z.get("sent_pkey", np.zeros(0, np.int32)),
        para_rowid=z.get("para_rowid", np.zeros(0, np.int32)),
        para_pkey=z.get("para_pkey", np.zeros(0, np.int32)),
        attrs_int=attrs_int,
        attrs_big=attrs_big,
        attrs_float=attrs_float,
        attrs_str=side["attrs_str"],
        attrs_json=side["attrs_json"],
        attrs_mva={k: (v[0], v[1]) for k, v in attrs_mva.items()},
        zones={k: (z[f"zr__{k}"], z[f"zs__{k}"], z[f"ze__{k}"])
               for k in header.get("zone_names", [])},
        stored_fields=_load_stored(path, side),
        field_lens=z["field_lens"],
        total_hits=header["total_hits"],
        tokenizer_settings=tok,
        dict_settings=dic,
    )


def _load_stored(path: str, side: dict) -> dict:
    """Stored fields: blocked docstore file (current format), or inline
    strings.json from pre-docstore indexes."""
    ds_path = os.path.join(path, "docstore.bin")
    if os.path.exists(ds_path):
        from .docstore import load_docstore
        return load_docstore(ds_path)
    return side.get("stored_fields", {})


def save_rt_snapshot(rt) -> None:
    """Checkpoint an RT index: segment docs + schema manifest (disk-chunk
    save analog). Segments re-buildable from docs; posting arrays are also
    saved for fast load."""
    base = rt.data_dir
    manifest = {
        "version": FORMAT_VERSION,
        "name": rt.name,
        "schema": rt.schema.to_json(),
        "settings": _settings_to_json(rt.tok_settings, rt.dict_settings),
        "n_segments": len(rt.segments),
        "chunk_ids": [s.chunk_id for s in rt.segments],
        "next_chunk_id": getattr(rt, "next_chunk_id", 0),
    }
    for i, seg in enumerate(rt.segments):
        seg_dir = os.path.join(base, f"segment_{i}")
        save_packed(seg.packed, seg_dir)
        with open(os.path.join(seg_dir, "docs.json"), "w") as f:
            json.dump(list(seg.docs.values()), f)
    # remove stale higher-numbered segment dirs
    i = len(rt.segments)
    while os.path.isdir(os.path.join(base, f"segment_{i}")):
        import shutil
        shutil.rmtree(os.path.join(base, f"segment_{i}"))
        i += 1
    tmp = os.path.join(base, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(base, "manifest.json"))


def load_rt_snapshot(rt) -> bool:
    """Load a checkpointed RT index state (returns False if no snapshot)."""
    from ..exec.searcher import SearchIndex
    from .rt import _Segment

    base = rt.data_dir
    mpath = os.path.join(base, "manifest.json")
    if not os.path.exists(mpath):
        return False
    with open(mpath) as f:
        manifest = json.load(f)
    rt.segments = []
    rt.docid_seg = {}
    chunk_ids = manifest.get("chunk_ids") or []
    rt.next_chunk_id = manifest.get("next_chunk_id", 0)
    for i in range(manifest["n_segments"]):
        seg_dir = os.path.join(base, f"segment_{i}")
        packed = load_packed(seg_dir)
        with open(os.path.join(seg_dir, "docs.json")) as f:
            docs = {int(d["id"]): d for d in json.load(f)}
        cid = chunk_ids[i] if i < len(chunk_ids) else None
        rt.segments.append(_Segment(packed, SearchIndex(packed), docs, cid))
        for d in docs:
            rt.docid_seg[d] = i
    return True
