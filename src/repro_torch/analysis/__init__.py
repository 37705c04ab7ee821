"""The port's static analysis, op-level analysis and runtime sanitizer.

Three layers guard the port's invariants, ordered by when they fire, as
``repro.analysis``'s guard the reference's:

* **Source level**: :mod:`repro_torch.analysis.lint`, an AST lint over the
  port's files (``python -m repro_torch.analysis.lint``) with four rules:
  R1 dense fabric-sized allocations on hot-path modules (numpy, jnp and
  torch allocators), R2 compile hygiene (``torch.compile`` in a loop or on
  a lambda, host reads inside a slot kernel's loop), R3
  ``pytest.importorskip`` guards of jax and torch in tests, R4 dtype
  discipline (implicit jnp and torch dtypes, uint16 wrap risk).
  Pre-existing violations outside ``core/`` are frozen in
  ``baseline.json``; new ones fail.
* **Op level**: :mod:`repro_torch.analysis.ir` runs every slot kernel of
  the simulator under a dispatch mode (``python -m
  repro_torch.analysis.ir``) and measures what the source lint cannot
  see: flops and bytes moved, peak live bytes, the slot carry's bytes and
  its n-scaling exponent, dtype leaks; budgets live in
  ``ir_budget.json``.  :mod:`repro_torch.analysis.certify` (``python -m
  repro_torch.analysis.certify``) is the same idea for the schedule
  construction: it verifies Theorem-3-level properties of a built
  schedule with no simulation and emits a machine-readable certificate.
* **Runtime level**: :mod:`repro_torch.analysis.sanitize`, contract checks
  the simulator engines run when ``REPRO_SANITIZE=1`` (or
  ``sanitize=True``): bit conservation, schedule validity, credit
  closure; a sanitized run is bit-identical to an unsanitized one.

None of them imports jax.
"""
from .sanitize import SanitizeError, Sanitizer, make_sanitizer, sanitize_enabled

__all__ = [
    "SanitizeError",
    "Sanitizer",
    "make_sanitizer",
    "sanitize_enabled",
]
