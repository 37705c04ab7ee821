"""The port's package surface against the JAX package's: ``repro_torch.core``
re-exports every name ``repro.core`` does except the named unported ones,
and the sanitizer's ``check_matrix`` holds the reference's contract."""
import types

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as ref_core
import repro_torch.core as core
from repro.analysis.sanitize import Sanitizer as RefSanitizer
from repro_torch.analysis.sanitize import SanitizeError, Sanitizer

# what repro.core exports that the port has no copy of, by name (the
# port's counterpart of simulate_aggregate_jax is simulate_aggregate)
UNPORTED = {"simulate_aggregate_jax"}


def test_core_exports_everything_but_the_unported():
    missing = {k for k in set(ref_core.__all__) - set(core.__all__)
               if not isinstance(getattr(ref_core, k), types.ModuleType)}
    assert missing == UNPORTED
    for k in ("run_sweep", "run_adaptive", "simulate", "Schedule",
              "saturate", "vermilion_schedule", "FaultSchedule",
              "FaultEvent", "FaultTimeline", "claims_fault_mask",
              "FAULT_KINDS", "simulate_aggregate"):
        assert k in core.__all__, k
    # each export is the port's own object, never the reference's
    for k in core.__all__:
        v = getattr(core, k)
        mod = getattr(v, "__module__", None) or getattr(v, "__name__", "")
        assert not str(mod).startswith("repro."), k


def test_from_core_import_works():
    from repro_torch.core import AdaptiveCase, run_sweep, simulate  # noqa
    assert callable(run_sweep) and callable(simulate)


@pytest.mark.parametrize("m,kw,ok", [
    (np.eye(3), {}, True),
    (np.eye(3), dict(n=3), True),
    (np.ones((2, 3)), {}, False),                 # not square
    (np.eye(3), dict(n=4), False),                # wrong size
    (np.array([[np.nan, 0.0], [0.0, 1.0]]), {}, False),
    (np.array([[-1.0]]), {}, False),              # negative
    (np.array([[-1.0]]), dict(nonneg=False), True),
    (np.zeros(3), {}, False),                     # not a matrix
])
def test_check_matrix_matches_reference(m, kw, ok):
    san, ref = Sanitizer(), RefSanitizer()
    if ok:
        san.check_matrix(m, **kw)
        ref.check_matrix(m, **kw)
        assert san.counts["matrix"] == 1
    else:
        with pytest.raises(SanitizeError):
            san.check_matrix(m, **kw)
        with pytest.raises(AssertionError):
            ref.check_matrix(m, **kw)


def test_sanitizer_context_in_message():
    """tests/test_analysis.py's context test, through check_matrix."""
    san = Sanitizer()
    san.set_context("case=demo epoch=2 slot=128")
    with pytest.raises(SanitizeError,
                       match=r"\[case=demo epoch=2 slot=128\]"):
        san.check_matrix("m", np.array([[-1.0]]))
    san.set_context(None)
    with pytest.raises(SanitizeError) as ei:
        san.check_matrix("m", np.array([[-1.0]]))
    assert "case=demo" not in str(ei.value)
