"""Optimizer substrate: AdamW over f32 masters, LR schedules, int8
gradient compression with error feedback."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_adamw)
from repro_torch.optim.grad_compress import (compress_grads,
                                             init_error_feedback)
from repro_torch.optim.schedules import constant, linear_warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "adamw_update",
           "clip_by_global_norm", "global_norm", "init_adamw",
           "compress_grads", "init_error_feedback", "constant",
           "linear_warmup_cosine"]
