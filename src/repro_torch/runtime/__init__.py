"""Serving runtime: host page bookkeeping (``paged_cache``,
``prefix_cache``, ``scheduler`` — copies of the JAX package's modules)
and the synchronous continuous-batching ``engine``."""
