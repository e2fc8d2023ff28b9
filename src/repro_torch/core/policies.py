"""Softmax-approximation policy objects.

A :class:`SoftmaxPolicy` is the single switch threaded through the model
zoo, the serving engine and the CUDA paged kernels.  A copy of the JAX
package's ``core/policies.py``; it is hashable, so it can key a cache of
device-resident tables.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

SoftmaxImpl = Literal["exact", "rexp", "lut2d", "rexp_unnorm", "log2_prior"]
LookupImpl = Literal["gather", "onehot"]
IndexMode = Literal["round", "floor"]


@dataclasses.dataclass(frozen=True)
class SoftmaxPolicy:
    """How softmax is computed at a given site.

    Attributes:
      impl: which algorithm.  ``exact`` = jnp softmax (training default);
        ``rexp`` = paper §4.1 / Algorithm 1; ``lut2d`` = paper §4.2 /
        Algorithm 2; ``rexp_unnorm`` = prior art [29] (aggressive,
        unnormalized — Appendix A.1.1); ``log2_prior`` = prior art [32]
        Eq. (11)/(12) (Appendix A.1.2).
      precision: LUT precision name (int16 / uint8 / uint4 / uint2).
      alpha_len: LUT_α length (x_s + 1).  None → paper Table 8 default.
      index_mode: ``round`` (centered bins; default) or ``floor``
        (truncating MSB extraction, the literal HW reading).
      lookup_impl: kernel-level realization of the table read —
        ``gather`` (dynamic gather) or ``onehot`` (one-hot × LUT matmul on
        the MXU; the TPU-native adaptation, see DESIGN.md §2).
      use_kernel: route through the fused Pallas kernels where available.
      max_norm: apply max-subtraction before approximating.  Always True
        for the paper's methods; exposed so prior-art Eq. (11) (no norm)
        can be expressed.
    """

    impl: SoftmaxImpl = "exact"
    precision: str = "uint8"
    alpha_len: int | None = None
    index_mode: IndexMode = "round"
    lookup_impl: LookupImpl = "gather"
    use_kernel: bool = False
    max_norm: bool = True

    def is_approx(self) -> bool:
        return self.impl != "exact"


EXACT = SoftmaxPolicy(impl="exact")
