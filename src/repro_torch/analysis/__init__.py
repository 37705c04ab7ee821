"""Analysis of the port: runtime contract checks (see :mod:`.sanitize`)
and the static Theorem-3 certificate of a built schedule (see
:mod:`.certify`, ``python -m repro_torch.analysis.certify``)."""
from .sanitize import SanitizeError, Sanitizer, make_sanitizer, sanitize_enabled

__all__ = [
    "SanitizeError",
    "Sanitizer",
    "make_sanitizer",
    "sanitize_enabled",
]
