"""Serving runtime: host page bookkeeping (``paged_cache``,
``prefix_cache``, ``scheduler`` — copies of the JAX package's modules)
the synchronous continuous-batching ``engine`` and the lockstep
``serve_loop`` it is held to."""
