"""The paper's exact experiment models (§6.1), over node-stacked parameters.

- FMNIST: MLP with ReLU, two hidden layers of 128 and 64 neurons.
- CIFAR10: CNN with three 3×3 convolutions (32/64/64 channels, each followed
  by a 2×2 max-pool) and two fully connected layers of 500 neurons.

The port of ``repro.models.paper_nets``.  Parameters are a flat dict of
tensors whose leaves carry a leading node axis K (``"fc0/w"``: (K, in, out),
``"conv0/w"``: (K, 3, 3, Cin, Cout) — the reference's HWIO layout), and the
inputs a leading node axis too.  One call evaluates all K node models: the
dense layers are batched matrix products and the convolutions one grouped
convolution with K groups.  Because the K node losses are independent, one
``backward()`` of their sum gives every node its own gradient.

Two layout points differ from PyTorch's habits and follow the reference:
- convolution weights are stored HWIO and turned into OIHW inside
  :func:`cnn_apply`, so the stored leaf, its gradient and its wire payload
  have the reference's element order;
- the last pooled map is flattened in (H, W, C) order before ``fc0``, as the
  reference's NHWC reshape does; a plain NCHW flatten would permute the rows
  of ``fc0``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _uniform(gen: torch.Generator, shape, limit: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * limit


def _dense_init(gen, fan_in, fan_out, name, out):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out[f"{name}/w"] = _uniform(gen, (fan_in, fan_out), limit)
    out[f"{name}/b"] = torch.zeros(fan_out)


def _conv_init(gen, kh, kw, cin, cout, name, out):
    limit = math.sqrt(6.0 / (kh * kw * cin + cout))
    out[f"{name}/w"] = _uniform(gen, (kh, kw, cin, cout), limit)
    out[f"{name}/b"] = torch.zeros(cout)


def _sorted(params: dict) -> dict:
    return {n: params[n] for n in sorted(params)}


# -- MLP (Fashion-MNIST) ------------------------------------------------------

def mlp_init(gen: torch.Generator, input_dim: int = 784,
             hidden: tuple[int, ...] = (128, 64), num_classes: int = 10):
    """One node's MLP parameters (Glorot-uniform weights, zero biases) on the
    CPU, drawn from ``gen``.  Same shapes and layout as the reference; the
    values differ (another generator), so parity tests carry the
    reference's values across with :mod:`repro_torch.convert`."""
    dims = (input_dim, *hidden, num_classes)
    out: dict = {}
    for i in range(len(dims) - 1):
        _dense_init(gen, dims[i], dims[i + 1], f"fc{i}", out)
    return _sorted(out)


def _dense(params, name, h):
    # (K, B, in) @ (K, in, out) + (K, 1, out)
    return torch.baddbmm(params[f"{name}/b"].unsqueeze(1), h, params[f"{name}/w"])


def mlp_apply(params, x):
    """x: (K, B, 28, 28) or (K, B, 784) -> logits (K, B, 10)."""
    h = x.reshape(x.shape[0], x.shape[1], -1)
    n = sum(1 for name in params if name.endswith("/w"))
    for i in range(n):
        h = _dense(params, f"fc{i}", h)
        if i < n - 1:
            h = torch.relu(h)
    return h


# -- CNN (CIFAR10) ------------------------------------------------------------

def cnn_init(gen: torch.Generator, in_channels: int = 3, image_hw: int = 32,
             channels: tuple[int, int, int] = (32, 64, 64),
             fc_width: int = 500, num_classes: int = 10):
    """One node's CNN parameters on the CPU, drawn from ``gen`` (see
    :func:`mlp_init`)."""
    c1, c2, c3 = channels
    spatial = image_hw // 8  # three stride-2 pools
    out: dict = {}
    _conv_init(gen, 3, 3, in_channels, c1, "conv0", out)
    _conv_init(gen, 3, 3, c1, c2, "conv1", out)
    _conv_init(gen, 3, 3, c2, c3, "conv2", out)
    _dense_init(gen, c3 * spatial * spatial, fc_width, "fc0", out)
    _dense_init(gen, fc_width, fc_width, "fc1", out)
    _dense_init(gen, fc_width, num_classes, "out", out)
    return _sorted(out)


def _conv_relu_pool(params, name, h, k):
    """h: (B, K*Cin, H, W) -> (B, K*Cout, H/2, W/2); per-node 'SAME' 3×3."""
    w = params[f"{name}/w"]                       # (K, kh, kw, Cin, Cout) HWIO
    kh, kw, cin, cout = w.shape[1:]
    w_oihw = w.permute(0, 4, 3, 1, 2).reshape(k * cout, cin, kh, kw)
    h = F.conv2d(h, w_oihw, params[f"{name}/b"].reshape(k * cout),
                 padding=(kh // 2, kw // 2), groups=k)
    return F.max_pool2d(torch.relu(h), 2)


def cnn_apply(params, x):
    """x: (K, B, 3, 32, 32) channels-first (paper convention) -> (K, B, 10)."""
    k, b = x.shape[:2]
    h = x.transpose(0, 1).reshape(b, k * x.shape[2], *x.shape[3:])
    for i in range(3):
        h = _conv_relu_pool(params, f"conv{i}", h, k)
    # (B, K*C, H, W) -> (K, B, H, W, C) -> (K, B, H*W*C): the reference's
    # NHWC flatten order, which fc0's rows are laid out in
    c = h.shape[1] // k
    h = h.reshape(b, k, c, *h.shape[2:]).permute(1, 0, 3, 4, 2).reshape(k, b, -1)
    h = torch.relu(_dense(params, "fc0", h))
    h = torch.relu(_dense(params, "fc1", h))
    return _dense(params, "out", h)


# -- losses -------------------------------------------------------------------

def softmax_xent(logits, labels):
    """logits (K, B, C), labels (K, B) -> (K,) per-node mean cross-entropy."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (lse - gold).mean(-1)


def make_classifier_loss(apply_fn):
    """(params, (x, y)) -> (K,) node losses for a node-stacked ``apply_fn``."""
    def loss_fn(params, batch):
        x, y = batch
        return softmax_xent(apply_fn(params, x), y)

    return loss_fn
