"""Static and recorded analysis of the port's kernels and engine steps.

* :mod:`repro_torch.analysis.kernel_guard` — shared-memory, grid,
  cluster, coverage and overflow analysis of the CUDA kernels from
  their ``kernel_spec()`` declarations, built from the kernels' own
  launch plans (``csrc/launch_plan.h``, compiled for the host), plus
  the per-policy LUT census and integer-Σ max-Lk bounds, behind
  ``python -m repro_torch.analysis --check-kernels`` (report committed
  as ``ANALYSIS_kernels_torch.json``).
* :mod:`repro_torch.analysis.contracts` — per-step invariant specs of
  the paged engine, checked by running each device program under a
  ``TorchDispatchMode`` recorder and the mesh's collective log, behind
  ``python -m repro_torch.analysis --check-all`` (report committed as
  ``ANALYSIS_contracts_torch.json``).

The JAX package's ``hlo_guard`` and ``jaxpr_lint`` read JAX's compiled
HLO and jaxprs and have no counterpart here, nor has its
``compile_count``: the port runs eagerly and compiles nothing; the
recorder (``contracts.StepRecorder``) checks the same invariants on the
operations a step runs.
"""

from __future__ import annotations

from repro_torch.analysis.kernel_guard import (ClampProbe, Coverage,
                                               KernelSpec, LaunchSpec,
                                               Operand, Reduction,
                                               check_kernel, check_kernels,
                                               kernel_registry,
                                               policy_ledger)

__all__ = ["ClampProbe", "Coverage", "KernelSpec", "LaunchSpec", "Operand",
           "Reduction", "check_kernel", "check_kernels", "kernel_registry",
           "policy_ledger"]
