"""Deterministic synthetic stand-ins for Fashion-MNIST / CIFAR10.

The port's own copy of ``repro.data.synthetic`` (numpy only, same arrays from the same
seed): ``repro_torch`` imports nothing of ``repro``.

Nothing is downloaded: the paper's datasets are simulated with
class-conditional generative mixtures that preserve the properties the paper's
experiments depend on: (i) a fixed number of classes with learnable structure,
(ii) enough within-class variation that test accuracy is non-trivial, and
(iii) identical image shapes to the originals so the paper's exact MLP/CNN
architectures run unchanged.

Each class c is a mixture of ``modes_per_class`` Gaussian prototype images with
smooth spatial correlation (low-frequency random fields), giving a task where
the paper's MLP reaches ~85-95% IID accuracy but pathological non-IID
partitioning (repro of McMahan et al.) still causes the heterogeneity the
DR-DSGD experiments need.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _smooth_field(rng: np.random.Generator, shape: tuple[int, ...], cutoff: int = 6
                  ) -> np.ndarray:
    """Low-pass-filtered Gaussian noise — smooth 'image-like' prototypes."""
    h, w = shape[-2], shape[-1]
    freq = rng.standard_normal(shape).astype(np.float64)
    f = np.fft.rfft2(freq, axes=(-2, -1))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    mask = (np.abs(fy) * h <= cutoff) & (np.abs(fx) * w <= cutoff)
    f = f * mask
    out = np.fft.irfft2(f, s=(h, w), axes=(-2, -1))
    out = out / (np.abs(out).max() + 1e-9)
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SyntheticImageDataset:
    name: str
    x_train: np.ndarray  # (N, ...) float32 in [-1, 1]
    y_train: np.ndarray  # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def image_shape(self) -> tuple[int, ...]:
        return self.x_train.shape[1:]


def _make_dataset(name: str, image_shape: tuple[int, ...], num_classes: int,
                  n_train: int, n_test: int, seed: int,
                  modes_per_class: int = 3, noise: float = 0.9,
                  class_sep: float = 0.55) -> SyntheticImageDataset:
    """Classes share mode structure; only ``class_sep`` of the prototype is
    class-specific — this keeps classes confusable so that the pathological
    non-IID partition produces the heterogeneity the paper studies (with
    fully separable classes every algorithm saturates and DRO is moot)."""
    rng = np.random.default_rng(seed)
    shared = np.stack([_smooth_field(rng, image_shape)
                       for _ in range(modes_per_class)])  # (M, ...)
    # per-class separability ramp: later classes are intrinsically harder
    # (mirrors FMNIST's shirt/pullover-style hard classes). ERM sacrifices
    # them; DRO's node reweighting protects them — the paper's mechanism.
    seps = np.linspace(1.6 * class_sep, 0.45 * class_sep, num_classes)
    protos = np.stack([
        np.stack([
            shared[m] + seps[c] * _smooth_field(rng, image_shape)
            for m in range(modes_per_class)
        ])
        for c in range(num_classes)
    ])  # (C, M, ...)

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        m = rng.integers(0, modes_per_class, size=n)
        base = protos[y, m]
        x = base + noise * rng.standard_normal(base.shape).astype(np.float32)
        return np.clip(x, -1.0, 1.0).astype(np.float32), y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return SyntheticImageDataset(name, x_tr, y_tr, x_te, y_te, num_classes)


def make_fmnist_like(n_train: int = 6000, n_test: int = 1000, seed: int = 0
                     ) -> SyntheticImageDataset:
    """Fashion-MNIST stand-in: 28x28 grayscale, 10 classes."""
    return _make_dataset("fmnist_like", (28, 28), 10, n_train, n_test, seed)


def make_cifar_like(n_train: int = 6000, n_test: int = 1000, seed: int = 1
                    ) -> SyntheticImageDataset:
    """CIFAR10 stand-in: 3x32x32, 10 classes (channels-first like the paper's CNN)."""
    return _make_dataset("cifar_like", (3, 32, 32), 10, n_train, n_test, seed)
