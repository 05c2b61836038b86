"""UDF / plugin system (host-side).

Behavioral model: the reference's UDF ABI (sphinxudf.h, CREATE FUNCTION ...
SONAME 'lib.so'; sphinxplugin.cpp). This redesign: UDFs are Python callables
registered either programmatically (register_udf) or via SQL:

    CREATE FUNCTION myfunc RETURNS INT SONAME 'mymodule:myfunc'
    DROP FUNCTION myfunc

UDFs evaluate host-side in the final-stage expression pass (select-list
projections over top-k rows) — the same stage the reference runs UDFs in.
"""
from __future__ import annotations

import importlib
from typing import Callable

_UDFS: dict[str, Callable] = {}


class PluginError(ValueError):
    pass


def register_udf(name: str, fn: Callable) -> None:
    _UDFS[name.upper()] = fn


def unregister_udf(name: str) -> bool:
    return _UDFS.pop(name.upper(), None) is not None


def get_udf(name: str) -> Callable | None:
    return _UDFS.get(name.upper())


def udf_names() -> list[str]:
    return sorted(_UDFS)


_TOKEN_FILTERS: dict[str, Callable] = {}


def register_token_filter(name: str, fn: Callable) -> None:
    """fn(token: str) -> str | list[str] | None (None drops the token) —
    the index_token_filter plugin hook (sphinxplugin.cpp token filters),
    applied between the tokenizer and the dictionary at index and query
    time."""
    _TOKEN_FILTERS[name.lower()] = fn


def unregister_token_filter(name: str) -> bool:
    return _TOKEN_FILTERS.pop(name.lower(), None) is not None


def get_token_filter(name: str) -> Callable | None:
    return _TOKEN_FILTERS.get(name.lower())


def token_filter_names() -> list[str]:
    return sorted(_TOKEN_FILTERS)


def load_plugin_soname(name: str, ptype: str, soname: str) -> None:
    """CREATE PLUGIN name TYPE '...' SONAME 'module:callable'."""
    if ptype not in ("index_token_filter", "query_token_filter",
                     "token_filter"):
        raise PluginError(
            f"unsupported plugin type {ptype!r}; token filters and python "
            "UDFs (CREATE FUNCTION) are the supported plugin kinds")
    mod_name, _, fn_name = soname.partition(":")
    if not fn_name:
        fn_name = name
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise PluginError(f"cannot import plugin module {mod_name!r}: {e}")
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise PluginError(f"{soname!r} has no callable {fn_name!r}")
    register_token_filter(name, fn)


def load_udf_soname(name: str, soname: str) -> None:
    """SONAME 'module.path:callable' -> import and register."""
    mod_name, _, fn_name = soname.partition(":")
    if not fn_name:
        fn_name = name
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise PluginError(f"cannot import UDF module {mod_name!r}: {e}")
    fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise PluginError(f"{soname!r} has no callable {fn_name!r}")
    register_udf(name, fn)
