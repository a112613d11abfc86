"""Test-suite bootstrap: make the suite collect without ``hypothesis``.

Several test modules use property-based tests via ``hypothesis``.  When
the real package is available it is used unchanged.  When it is missing
(the benchmark containers ship only the jax toolchain) we install a
*minimal deterministic fallback* into ``sys.modules`` before the test
modules are imported, so collection succeeds everywhere and the property
tests still run — each ``@given`` draws ``max_examples`` pseudo-random
examples from a deterministic per-test RNG (seeded from the test's
qualified name, so every test sees its own input stream and a failure
reproduces bit-for-bit across runs and ``-k`` selections).

Fallback runs are *visible*, not silent: every test that executed under
the shim carries the ``hypothesis_fallback`` marker (select them with
``-m hypothesis_fallback``), and the terminal summary prints one
``hypothesis fallback shim: ...`` report line with the test and example
counts, so a CI log always shows which engine generated the inputs.

Only the strategy surface this repo uses is implemented:
``st.integers``, ``st.floats``, ``st.sampled_from``, ``st.booleans``.
Install the real thing (see requirements-dev.txt) for shrinking, the
example database, and the full strategy library.
"""
from __future__ import annotations

import random
import sys
import types
import zlib

_FALLBACK_ACTIVE = False
_FALLBACK_RUNS: dict = {}       # test qualname -> examples drawn

try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    _FALLBACK_ACTIVE = True

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def draw(self, rng: random.Random):
            return self._draw(rng)

    def integers(min_value: int, max_value: int) -> _Strategy:
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def floats(min_value: float, max_value: float, **_kw) -> _Strategy:
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def sampled_from(elements) -> _Strategy:
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def booleans() -> _Strategy:
        return _Strategy(lambda rng: rng.random() < 0.5)

    _DEFAULT_MAX_EXAMPLES = 10

    def _test_seed(fn) -> int:
        """Deterministic per-test seed: stable across runs and test
        selections, distinct across tests (so two property tests never
        replay the same pseudo-random stream)."""
        name = f"{fn.__module__}.{getattr(fn, '__qualname__', fn.__name__)}"
        return zlib.crc32(name.encode()) ^ 0xD9C0

    def given(*strategies, **kw_strategies):
        def decorate(fn):
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_max_examples",
                            getattr(fn, "_max_examples",
                                    _DEFAULT_MAX_EXAMPLES))
                # registered up front so the report line still counts a
                # test whose example batch FAILS midway — the CI-failure
                # case is exactly where visibility matters most
                key = f"{fn.__module__}.{fn.__qualname__}"
                _FALLBACK_RUNS[key] = _FALLBACK_RUNS.get(key, 0) + n
                rng = random.Random(_test_seed(fn))
                for _ in range(n):
                    vals = [s.draw(rng) for s in strategies]
                    kvals = {k: s.draw(rng)
                             for k, s in kw_strategies.items()}
                    fn(*args, *vals, **kwargs, **kvals)
            # NB: no functools.wraps — pytest would introspect the wrapped
            # signature (following __wrapped__) and demand fixtures for the
            # strategy-supplied parameters.  Copy identity attrs only.
            wrapper.__name__ = fn.__name__
            wrapper.__qualname__ = getattr(fn, "__qualname__", fn.__name__)
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            if hasattr(fn, "_max_examples"):
                wrapper._max_examples = fn._max_examples
            if hasattr(fn, "pytestmark"):
                wrapper.pytestmark = fn.pytestmark
            wrapper.hypothesis_fallback = True
            return wrapper
        return decorate

    def settings(max_examples: int = _DEFAULT_MAX_EXAMPLES, **_ignored):
        def decorate(fn):
            fn._max_examples = max_examples
            return fn
        return decorate

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = integers
    _st.floats = floats
    _st.sampled_from = sampled_from
    _st.booleans = booleans

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = given
    _hyp.settings = settings
    _hyp.strategies = _st
    _hyp.HealthCheck = types.SimpleNamespace(all=staticmethod(lambda: []))
    _hyp.__version__ = "0.0-fallback"

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


# -------------------------------------------------- fallback visibility
def pytest_configure(config):
    # registered unconditionally so `-m hypothesis_fallback` is always a
    # valid selection; with real hypothesis installed no item carries it
    config.addinivalue_line(
        "markers",
        "hypothesis_fallback: property test running on the deterministic "
        "seeded shim (hypothesis not installed)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (a hand-written kernel of repro_torch); "
        "skips without one")


def pytest_collection_modifyitems(config, items):
    if not _FALLBACK_ACTIVE:
        return
    import pytest
    for item in items:
        fn = getattr(item, "function", None)
        if getattr(fn, "hypothesis_fallback", False):
            item.add_marker(pytest.mark.hypothesis_fallback)


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    if not _FALLBACK_ACTIVE or not _FALLBACK_RUNS:
        return
    total = sum(_FALLBACK_RUNS.values())
    terminalreporter.write_line(
        f"hypothesis fallback shim: {len(_FALLBACK_RUNS)} property tests "
        f"ran {total} deterministic seeded examples (install hypothesis "
        "for shrinking + the example database)", yellow=True)
