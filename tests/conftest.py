"""Shared pytest fixtures.

NOTE: XLA_FLAGS / host device count is intentionally NOT set here — unit and
smoke tests run on the single real CPU device. Multi-device (sharded) tests
live in test_sharded.py and spawn subprocesses with their own XLA_FLAGS.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest

# -- hypothesis fallback -------------------------------------------------------
# The property tests use hypothesis when it is installed (the `test` extra in
# pyproject.toml).  On bare containers without it, collection of half the
# suite would fail on the import; instead we register a tiny deterministic
# stand-in that replays each @given test over seeded random samples.  It only
# implements the strategy surface this repo uses (integers / floats /
# sampled_from / lists / booleans, keyword-style @given, @settings).
try:  # pragma: no cover - exercised implicitly by every property test
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import random as _random
    import types as _types

    class _Strategy:
        def __init__(self, sample):
            self.sample = sample

    def _integers(min_value=0, max_value=1 << 30):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def _floats(min_value=0.0, max_value=1.0, **_kw):
        return _Strategy(lambda r: r.uniform(min_value, max_value))

    def _sampled_from(options):
        opts = list(options)
        return _Strategy(lambda r: r.choice(opts))

    def _lists(elem, min_size=0, max_size=10, **_kw):
        return _Strategy(
            lambda r: [elem.sample(r) for _ in range(r.randint(min_size, max_size))]
        )

    def _booleans():
        return _Strategy(lambda r: r.random() < 0.5)

    def _given(**strategies):
        def deco(fn):
            def runner():
                rnd = _random.Random(0)
                for _ in range(getattr(runner, "_max_examples", 10)):
                    fn(**{k: s.sample(rnd) for k, s in strategies.items()})

            runner.__name__ = fn.__name__
            runner.__doc__ = fn.__doc__
            runner._max_examples = 10
            return runner

        return deco

    def _settings(max_examples=10, **_kw):
        def deco(fn):
            fn._max_examples = max_examples
            return fn

        return deco

    _st = _types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _st.lists = _lists
    _st.booleans = _booleans
    _hyp = _types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself where "
        "torch finds none")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
