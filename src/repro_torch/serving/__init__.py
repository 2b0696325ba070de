"""Serving on the port: the continuous-batching engine over a paged KV
cache whose page table is a Honeycomb store."""
from .engine import Request, ServingEngine
from .kv_cache import PagedKVCache, page_key, prefix_key, rolling_hashes

__all__ = ["Request", "ServingEngine", "PagedKVCache", "page_key",
           "prefix_key", "rolling_hashes"]
