"""Runtime contract checks of the port (see :mod:`.sanitize`)."""
from .sanitize import SanitizeError, Sanitizer, make_sanitizer, sanitize_enabled

__all__ = [
    "SanitizeError",
    "Sanitizer",
    "make_sanitizer",
    "sanitize_enabled",
]
