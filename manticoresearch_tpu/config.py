"""Configuration system.

Behavioral model: the reference's config machinery (sphinxutils.cpp:615-957
key tables; searchdconfig.cpp RT-mode manticore.json). This redesign uses
declarative TOML (stdlib tomllib) with the same key semantics:

    [searchd]
    listen_mysql = 9306
    listen_http = 9308
    data_dir = "./data"
    rt_flush_period = 60

    [index.products]            # plain index built by the indexer tool
    type = "plain"
    source = "products.jsonl"   # csv/tsv/jsonl
    fields = ["title", "descr"]
    attrs = { price = "float", cat = "uint" }
    path = "./idx/products"

    [index.rt1]                 # RT index (served from data_dir)
    type = "rt"
    fields = ["body"]
    attrs = { gid = "uint" }

    [index.rt1.tokenizer]
    charset_table = "non_cjk"
    min_word_len = 1

    [index.rt1.dict]
    morphology = ["stem_en"]
    stopwords = ["the", "a"]
"""
from __future__ import annotations

import tomllib
from dataclasses import dataclass, field

from .schema import AttrDef, AttrType, Schema
from .text.dictionary import DictSettings
from .text.tokenizer import TokenizerSettings


class ConfigError(ValueError):
    pass


@dataclass
class SearchdConfig:
    listen_mysql: int = 9306
    listen_http: int = 9308
    host: str = "127.0.0.1"
    data_dir: str | None = None
    rt_flush_period: float = 60.0
    query_log: str | None = None


@dataclass
class IndexConfig:
    name: str
    type: str = "rt"                       # rt | plain | percolate/pq
    source: str | None = None              # for plain: csv/tsv/jsonl path
    path: str | None = None                # for plain: output dir
    schema: Schema = None                  # type: ignore[assignment]
    tokenizer: TokenizerSettings = field(default_factory=TokenizerSettings)
    dict: DictSettings = field(default_factory=DictSettings)


@dataclass
class Config:
    searchd: SearchdConfig
    indexes: dict[str, IndexConfig]


def _parse_schema(name: str, sec: dict) -> Schema:
    fields_ = list(sec.get("fields", []))
    attrs = []
    for aname, atype in (sec.get("attrs") or {}).items():
        try:
            attrs.append(AttrDef(aname, AttrType(atype)))
        except ValueError:
            raise ConfigError(
                f"index {name}: unknown attr type {atype!r} for {aname!r}")
    return Schema(fields=fields_, attrs=attrs)


def _parse_tokenizer(sec: dict) -> TokenizerSettings:
    return TokenizerSettings(
        charset_table=sec.get("charset_table", "non_cjk"),
        min_word_len=int(sec.get("min_word_len", 1)),
        ngram_chars=sec.get("ngram_chars", ""),
        ngram_len=int(sec.get("ngram_len", 1)),
        overshort_step=int(sec.get("overshort_step", 1)),
        html_strip=bool(sec.get("html_strip", False)),
        html_remove_elements=tuple(sec.get("html_remove_elements", [])),
        html_index_attrs=str(sec.get("html_index_attrs", "")),
        index_zones=tuple(sec.get("index_zones", [])),
        index_sp=bool(sec.get("index_sp", False)),
        synonyms=tuple(sec.get("exceptions", sec.get("synonyms", []))),
        blend_chars=sec.get("blend_chars", ""),
        blend_mode=sec.get("blend_mode", ""),
        phrase_boundary=sec.get("phrase_boundary", ""),
        phrase_boundary_step=int(sec.get("phrase_boundary_step", 0)),
        regexp_filter=tuple(sec.get("regexp_filter", [])),
        bigram_index=str(sec.get("bigram_index", "")),
        bigram_freq_words=tuple(sec.get("bigram_freq_words", [])),
    )


def _parse_dict(sec: dict) -> DictSettings:
    return DictSettings(
        stopwords=frozenset(sec.get("stopwords", [])),
        morphology=tuple(sec.get("morphology", [])),
        wordforms=tuple(tuple(p) for p in sec.get("wordforms", [])),
        index_exact_words=bool(sec.get("index_exact_words", False)),
        min_stemming_len=int(sec.get("min_stemming_len", 1)),
    )


def settings_from_sql_options(options: dict[str, str]
                              ) -> tuple[TokenizerSettings, DictSettings]:
    """Map CREATE TABLE option strings (CreateTableSettings_c analog in the
    reference's DDL path: charset_table='...', morphology='stem_en', ...)
    to tokenizer/dict settings. All values arrive as strings from SQL."""
    o = options

    def _b(key, default=False):
        v = o.get(key)
        if v is None:
            return default
        return str(v).strip().lower() not in ("0", "", "false", "none")

    def _i(key, default):
        return int(float(o[key])) if key in o else default

    def _list(key):
        return tuple(x.strip() for x in str(o.get(key, "")).replace(
            ",", " ").split() if x.strip())

    tok = TokenizerSettings(
        charset_table=o.get("charset_table", TokenizerSettings().charset_table),
        min_word_len=_i("min_word_len", 1),
        ngram_chars=o.get("ngram_chars", ""),
        ngram_len=_i("ngram_len", 1),
        overshort_step=_i("overshort_step", 1),
        index_sp=_b("index_sp"),
        html_strip=_b("html_strip"),
        html_remove_elements=_list("html_remove_elements"),
        html_index_attrs=o.get("html_index_attrs", ""),
        index_zones=_list("index_zones"),
        # exceptions/regexp_filter entries are ';'-separated in SQL
        # options since entries carry spaces and '=>' themselves
        synonyms=tuple(e.strip() for e in str(
            o.get("exceptions", "")).split(";") if e.strip()),
        blend_chars=o.get("blend_chars", ""),
        blend_mode=o.get("blend_mode", ""),
        phrase_boundary=o.get("phrase_boundary", ""),
        phrase_boundary_step=_i("phrase_boundary_step", 0),
        regexp_filter=tuple(e.strip() for e in str(
            o.get("regexp_filter", "")).split(";") if e.strip()),
        bigram_index=str(o.get("bigram_index", "")).strip(),
        bigram_freq_words=_list("bigram_freq_words"),
    )
    # wordform lines normalize through the TOKENIZER (the reference folds
    # each side; 'run-time > runer' is a multi-token source because '-'
    # separates). Single->single pairs live in the dict; any multi-token
    # side becomes a tokenizer multiform.
    if o.get("wordforms"):
        from .text.tokenizer import Tokenizer
        from dataclasses import replace as _dc_replace
        norm_tok = Tokenizer(tok)
        wordforms = []
        multiforms = []
        for pair in str(o.get("wordforms", "")).split(","):
            if ">" not in pair:
                continue
            src_w, _, dst = pair.partition(">")
            src_t = [t.text for t in norm_tok.tokenize(src_w.strip())]
            dst_t = [t.text for t in norm_tok.tokenize(dst.strip())]
            if not src_t or not dst_t:
                continue
            if len(src_t) == 1 and len(dst_t) == 1:
                wordforms.append((src_t[0], dst_t[0]))
            else:
                multiforms.append((tuple(src_t), tuple(dst_t)))
                if len(dst_t) == 1:
                    # single-token destinations bypass morphology like
                    # plain wordform results do (identity mapping)
                    wordforms.append((dst_t[0], dst_t[0]))
        tok = _dc_replace(tok, multiforms=tuple(multiforms))
    else:
        wordforms = []
    dic = DictSettings(
        stopwords=frozenset(_list("stopwords")),
        morphology=tuple(m for m in _list("morphology")
                         if m != "none"),
        wordforms=tuple(wordforms),
        index_exact_words=_b("index_exact_words"),
        min_stemming_len=_i("min_stemming_len", 1),
        token_filter=str(o.get("token_filter", "")),
        min_prefix_len=_i("min_prefix_len", 0),
        min_infix_len=_i("min_infix_len", 0),
        mode=str(o.get("dict", "keywords")).strip() or "keywords",
        hitless_words=str(o.get("hitless_words", "") or ""),
        prefix_fields=tuple(
            s.strip().lower() for s in
            str(o.get("prefix_fields", "") or "").replace(",", " ").split()
            if s.strip()),
        infix_fields=tuple(
            s.strip().lower() for s in
            str(o.get("infix_fields", "") or "").replace(",", " ").split()
            if s.strip()),
    )
    return tok, dic


def load_config(path: str) -> Config:
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    sd_raw = raw.get("searchd", {})
    sd = SearchdConfig(
        listen_mysql=int(sd_raw.get("listen_mysql", 9306)),
        listen_http=int(sd_raw.get("listen_http", 9308)),
        host=str(sd_raw.get("host", "127.0.0.1")),
        data_dir=sd_raw.get("data_dir"),
        rt_flush_period=float(sd_raw.get("rt_flush_period", 60.0)),
        query_log=sd_raw.get("query_log"),
    )
    indexes = {}
    for name, sec in (raw.get("index") or {}).items():
        indexes[name] = IndexConfig(
            name=name,
            type=str(sec.get("type", "rt")),
            source=sec.get("source"),
            path=sec.get("path"),
            schema=_parse_schema(name, sec),
            tokenizer=_parse_tokenizer(sec.get("tokenizer", {})),
            dict=_parse_dict(sec.get("dict", {})),
        )
    return Config(searchd=sd, indexes=indexes)
