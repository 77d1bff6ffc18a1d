"""repro_torch.data against repro.data: identical arrays and batches from one seed."""

import numpy as np
import pytest

from repro import data as ref
from repro_torch import data as port


def _assert_same_dataset(a, b):
    for f in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.num_classes == b.num_classes and a.name == b.name


@pytest.mark.parametrize("maker,seed", [("make_fmnist_like", 0), ("make_fmnist_like", 5),
                                        ("make_cifar_like", 1)])
def test_datasets_match_reference(maker, seed):
    a = getattr(ref, maker)(n_train=600, n_test=200, seed=seed)
    b = getattr(port, maker)(n_train=600, n_test=200, seed=seed)
    _assert_same_dataset(a, b)


@pytest.mark.parametrize("part,kw", [("pathological_noniid_partition", {"shards_per_node": 2}),
                                     ("iid_partition", {}),
                                     ("dirichlet_partition", {"alpha": 0.3})])
def test_partitions_and_batches_match_reference(part, kw):
    ds_ref = ref.make_fmnist_like(n_train=600, n_test=200, seed=0)
    ds = port.make_fmnist_like(n_train=600, n_test=200, seed=0)
    a = getattr(ref, part)(ds_ref, 10, seed=3, **kw)
    b = getattr(port, part)(ds, 10, seed=3, **kw)
    for f in ("x", "y", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.node_classes == b.node_classes
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        for xa, xb in zip(a.sample_batch(ra, 7), b.sample_batch(rb, 7)):
            np.testing.assert_array_equal(xa, xb)
    for xa, xb in zip(a.per_node_test_sets(n_per_node=16, seed=2),
                      b.per_node_test_sets(n_per_node=16, seed=2)):
        np.testing.assert_array_equal(xa, xb)
    for (xa, ya), (xb, yb) in zip(a.per_class_test_sets(), b.per_class_test_sets()):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
