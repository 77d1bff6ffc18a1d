"""Federated data partitioners.

The port's own copy of ``repro.data.partition`` (numpy only, same arrays from the same
seed): ``repro_torch`` imports nothing of ``repro``.

``pathological_noniid_partition`` reproduces the paper's (and McMahan et al.'s)
protocol: sort samples by label, cut into equal shards, assign each device the
same number of shards.  Most devices end up seeing only a few classes, which is
the heterogeneity DR-DSGD is designed to be robust to.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset


@dataclasses.dataclass(frozen=True)
class FederatedDataset:
    """Per-node views over a dataset, with equal-sized local shards."""

    x: np.ndarray            # (K, n_local, ...) node-stacked training inputs
    y: np.ndarray            # (K, n_local)
    x_test: np.ndarray       # shared test inputs
    y_test: np.ndarray
    node_classes: list[list[int]]  # classes present on each node
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_local(self) -> int:
        return int(self.x.shape[1])

    def sample_batch(self, rng: np.random.Generator, batch_per_node: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Sample one minibatch per node: (K, B, ...), (K, B)."""
        k, n = self.x.shape[0], self.x.shape[1]
        idx = rng.integers(0, n, size=(k, batch_per_node))
        xb = np.take_along_axis(
            self.x, idx.reshape(k, batch_per_node, *([1] * (self.x.ndim - 2))), axis=1
        )
        yb = np.take_along_axis(self.y, idx, axis=1)
        return xb, yb

    def per_class_test_sets(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """Test set split by class — used for worst-distribution accuracy."""
        out = []
        for c in range(self.num_classes):
            m = self.y_test == c
            out.append((self.x_test[m], self.y_test[m]))
        return out

    def per_node_test_sets(self, n_per_node: int = 256, seed: int = 0
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Each node's local test distribution (paper §6.2).

        Node k's test distribution is the global test set restricted to the
        classes node k holds — the D_i whose worst mixture the DRO objective
        guards. Returns stacked arrays (K, n, ...), (K, n) (resampled with
        replacement to a common size so they vmap).
        """
        rng = np.random.default_rng(seed)
        xs, ys = [], []
        for classes in self.node_classes:
            m = np.isin(self.y_test, classes)
            idx = np.nonzero(m)[0]
            take = rng.choice(idx, size=n_per_node, replace=True)
            xs.append(self.x_test[take])
            ys.append(self.y_test[take])
        return np.stack(xs), np.stack(ys)


def _stack_equal(xs: list[np.ndarray], ys: list[np.ndarray]
                 ) -> tuple[np.ndarray, np.ndarray]:
    n = min(len(y) for y in ys)
    return (
        np.stack([x[:n] for x in xs]),
        np.stack([y[:n] for y in ys]),
    )


def pathological_noniid_partition(ds: SyntheticImageDataset, num_nodes: int,
                                  shards_per_node: int = 2, seed: int = 0
                                  ) -> FederatedDataset:
    """Sort-by-label shard partition (paper §6.1)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(ds.y_train, kind="stable")
    x, y = ds.x_train[order], ds.y_train[order]
    n_shards = num_nodes * shards_per_node
    shard_size = len(y) // n_shards
    shard_ids = rng.permutation(n_shards)
    xs, ys, node_classes = [], [], []
    for k in range(num_nodes):
        take = shard_ids[k * shards_per_node:(k + 1) * shards_per_node]
        xi = np.concatenate([x[s * shard_size:(s + 1) * shard_size] for s in take])
        yi = np.concatenate([y[s * shard_size:(s + 1) * shard_size] for s in take])
        perm = rng.permutation(len(yi))
        xs.append(xi[perm])
        ys.append(yi[perm])
        node_classes.append(sorted(np.unique(yi).tolist()))
    xk, yk = _stack_equal(xs, ys)
    return FederatedDataset(xk, yk, ds.x_test, ds.y_test, node_classes, ds.num_classes)


def iid_partition(ds: SyntheticImageDataset, num_nodes: int, seed: int = 0
                  ) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(ds.y_train))
    x, y = ds.x_train[perm], ds.y_train[perm]
    n_local = len(y) // num_nodes
    xs = [x[k * n_local:(k + 1) * n_local] for k in range(num_nodes)]
    ys = [y[k * n_local:(k + 1) * n_local] for k in range(num_nodes)]
    xk, yk = _stack_equal(xs, ys)
    classes = [sorted(np.unique(yi).tolist()) for yi in ys]
    return FederatedDataset(xk, yk, ds.x_test, ds.y_test, classes, ds.num_classes)


def dirichlet_partition(ds: SyntheticImageDataset, num_nodes: int,
                        alpha: float = 0.3, seed: int = 0) -> FederatedDataset:
    """Dirichlet(α) label-skew partition — the other standard non-IID protocol."""
    rng = np.random.default_rng(seed)
    xs = [[] for _ in range(num_nodes)]
    ys = [[] for _ in range(num_nodes)]
    for c in range(ds.num_classes):
        idx = np.nonzero(ds.y_train == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_nodes)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            xs[k].append(ds.x_train[part])
            ys[k].append(ds.y_train[part])
    xcat = [np.concatenate(a) if a else ds.x_train[:0] for a in xs]
    ycat = [np.concatenate(a) if a else ds.y_train[:0] for a in ys]
    # guard: every node needs at least a few samples
    min_n = max(4, min(len(y) for y in ycat))
    xcat = [np.resize(x, (min_n, *ds.x_train.shape[1:])) for x in xcat]
    ycat = [np.resize(y, (min_n,)) for y in ycat]
    xk, yk = _stack_equal(xcat, ycat)
    classes = [sorted(np.unique(yi).tolist()) for yi in ycat]
    return FederatedDataset(xk, yk, ds.x_test, ds.y_test, classes, ds.num_classes)
