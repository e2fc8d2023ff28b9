"""Attention-only decoder LM over plain dicts of tensors (the JAX
package's parameter layout, weights ``(in, out)``)."""
from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
