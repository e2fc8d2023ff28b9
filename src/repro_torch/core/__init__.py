"""The paper's contribution: LUT-based softmax approximation (REXP + 2D LUT).

  - precision:    Precision registry (int16/uint8/uint4/uint2, Tables 5/8)
  - lut_builder:  LUT construction (Eq. 4, 7, 8) + size accounting
  - lut_softmax:  Algorithms 1 & 2 + exact softmax, in torch
  - policies:     SoftmaxPolicy — the switch threaded through the port

``precision``, ``policies`` and ``lut_builder`` are copies of the JAX
package's numpy-only modules; the tests pin them to the originals.
"""
