"""repro_torch.core.robust against repro.core.robust on shared loss vectors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import robust as ref
from repro_torch.core import robust as port

CONFIGS = [
    dict(mu=6.0, loss_clip=10.0, enabled=True),
    dict(mu=2.0, loss_clip=None, enabled=True),
    dict(mu=9.0, loss_clip=1.5, enabled=True),
    dict(mu=6.0, loss_clip=10.0, enabled=False),
    dict(mu=6.0, loss_clip=None, enabled=False),
]


@pytest.mark.parametrize("fn", ["robust_scale", "robust_objective", "mixture_weights"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c.values())))
def test_robust_matches_reference(fn, cfg):
    rng = np.random.default_rng(0)
    for k in (1, 10, 33):
        # losses up to 14 so loss_clip=10 / 1.5 actually clips
        losses = rng.uniform(0.0, 14.0, size=k).astype(np.float32)
        want = np.asarray(getattr(ref, fn)(jnp.asarray(losses), ref.RobustConfig(**cfg)))
        got = getattr(port, fn)(torch.from_numpy(losses),
                                port.RobustConfig(**cfg)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_robust_config_rejects_nonpositive_mu():
    with pytest.raises(ValueError):
        port.RobustConfig(mu=0.0)
