"""manticoresearch_tpu: a full-text search engine whose query path runs on
an accelerator through JAX.

From-scratch re-design of Manticore Search's capabilities (jax/XLA compute
path on NVIDIA GPUs, Python/C++ host runtime). See ARCHITECTURE.md.
"""
__version__ = "0.1.0"

from .schema import AttrDef, AttrType, Schema  # noqa: F401
