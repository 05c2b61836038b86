"""The seeded synthetic corpus the benchmark and the smoke test serve.

One text field `content` and two integer attributes: `year`
(2000 + (docid - 1) % 25) and `group_id` ((docid - 1) % 100). Document lengths are
uniform in [avg_len / 2, 2 avg_len); terms are Zipf(1.25) over a `vocab`
word vocabulary, named t0000, t0001, ... (term id order = frequency rank).
"""
from __future__ import annotations

import numpy as np

from .index.builder import PackedIndex, build_from_pretokenized
from .schema import AttrDef, AttrType, Schema

SCHEMA = Schema(fields=["content"],
                attrs=[AttrDef("year", AttrType.UINT),
                       AttrDef("group_id", AttrType.UINT)])


def term_name(tid: int, vocab: int) -> str:
    return f"t{tid:0{max(4, len(str(vocab - 1)))}d}"


def build_corpus(n_docs: int, vocab: int = 50_000, avg_len: int = 100,
                 seed: int = 42, n_shards: int = 1) -> list[PackedIndex]:
    """The corpus as `n_shards` indexes over consecutive docid ranges
    (docids 1..n_docs); one shard holds it all."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(avg_len // 2, avg_len * 2, n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    offsets[1:] = np.cumsum(lens)
    z = rng.zipf(1.25, int(offsets[-1]))
    terms = np.minimum(z - 1, vocab - 1).astype(np.int64)
    del z
    vocab_list = [term_name(i, vocab) for i in range(vocab)]
    docids = np.arange(1, n_docs + 1, dtype=np.int64)
    year = 2000 + (docids - 1) % 25
    gid = (docids - 1) % 100
    per = -(-n_docs // n_shards)
    shards = []
    for lo in range(0, n_docs, per):
        hi = min(lo + per, n_docs)
        shards.append(build_from_pretokenized(
            SCHEMA,
            doc_ids=docids[lo:hi],
            doc_terms=terms[offsets[lo]:offsets[hi]],
            doc_offsets=offsets[lo:hi + 1] - offsets[lo],
            attrs={"year": year[lo:hi], "group_id": gid[lo:hi]},
            vocab=vocab_list,
        ))
    return shards
