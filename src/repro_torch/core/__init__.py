"""The paper's contribution: LUT-based softmax approximation (REXP + 2D LUT).

  - precision:    Precision registry (int16/uint8/uint4/uint2, Tables 5/8)
  - lut_builder:  LUT construction (Eq. 4, 7, 8) + size accounting
  - lut_softmax:  Algorithms 1 & 2, exact softmax and the prior-art
                  baselines, in torch
  - policies:     SoftmaxPolicy — the switch threaded through the port
  - quantization: the int8 KV-pool rounding convention and PTQ-D
  - calibration:  Σe^x distribution analysis / LUT sizing (Fig. 4, §5.3)

``precision``, ``policies`` and ``lut_builder`` are copies of the JAX
package's numpy-only modules; the tests pin them to the originals.
"""

from repro_torch.core.precision import PRECISIONS, Precision, get_precision
from repro_torch.core.lut_builder import (
    Lut2DTables,
    RexpTables,
    build_lut2d_tables,
    build_lut_alpha,
    build_lut_exp,
    build_lut_recip_exp,
    build_lut_sigma,
    build_rexp_tables,
)
from repro_torch.core.lut_softmax import (
    logsoftmax_scoring,
    make_softmax_fn,
    softmax_exact,
    softmax_log_prior,
    softmax_lut2d,
    softmax_rexp,
    softmax_rexp_unnorm,
)
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.core.calibration import (
    CalibrationResult,
    SumCollector,
    calibrate_from_logits,
    calibrate_model,
    row_exp_sums,
)

__all__ = [
    "PRECISIONS",
    "Precision",
    "get_precision",
    "Lut2DTables",
    "RexpTables",
    "build_lut2d_tables",
    "build_lut_alpha",
    "build_lut_exp",
    "build_lut_recip_exp",
    "build_lut_sigma",
    "build_rexp_tables",
    "logsoftmax_scoring",
    "make_softmax_fn",
    "softmax_exact",
    "softmax_log_prior",
    "softmax_lut2d",
    "softmax_rexp",
    "softmax_rexp_unnorm",
    "EXACT",
    "SoftmaxPolicy",
    "CalibrationResult",
    "SumCollector",
    "calibrate_from_logits",
    "calibrate_model",
    "row_exp_sums",
]
