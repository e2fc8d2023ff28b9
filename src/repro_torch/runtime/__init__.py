"""Serving and training runtime: host page bookkeeping (``paged_cache``,
``prefix_cache``, ``scheduler`` — copies of the JAX package's modules),
the continuous-batching ``engine`` — the synchronous ``ServingEngine``
and the ``PipelinedEngine``, which samples on the device and dispatches
one step ahead — the asyncio streaming ``server`` over either, and the
lockstep ``serve_loop`` they are held to; the ``train_loop`` (train and
eval steps) and the ``fault_tolerance`` trainer around it.

The names below are exported as the JAX package's ``runtime`` exports
them.  They load on first use: ``models.transformer`` imports
``paged_cache`` while the engine imports ``models``, so importing the
engine here would be circular.
"""

import importlib

_EXPORTS = {
    "serve_loop": ("generate", "make_decode_step", "make_prefill_step",
                   "sample_row", "sample_token", "sample_tokens"),
    "paged_cache": ("NULL_PAGE", "DecodeView", "OutOfPagesError",
                    "PageAllocator", "PagedCacheConfig", "PrefillChunkView",
                    "decode_view", "padded_n_pages", "pool_shape",
                    "prefill_chunk_view", "to_device", "view_arrays"),
    "prefix_cache": ("PrefixCache",),
    "scheduler": ("PENDING_TOKEN", "Request", "Scheduler", "SeqState"),
    "engine": ("EngineConfig", "EngineStats", "GenerationResult",
               "PipelinedEngine", "RequestHandle", "ServingEngine"),
    "server": ("AsyncServingServer", "RequestStream",
               "ServerSaturatedError"),
    "train_loop": ("TrainState", "cross_entropy", "init_train_state",
                   "make_eval_step", "make_loss_fn", "make_train_step",
                   "train_state"),
    "fault_tolerance": ("ResilientTrainer", "TrainerReport"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
