"""Toy 2-D classifier training (counterpart of
flashattn_tpu/training/classifier.py): the reference's "train a Network on
the minitorch datasets" workload.  A 3-layer ReLU MLP with a sigmoid head,
trained full-batch by SGD (the port's :class:`~flashattn_tpu_torch.optim.SGD`,
in place), on the card unless the caller names another device.

``train_classifier(seed=s)`` starts from the JAX module's own initial
weights: the threefry key ``PRNGKey(s)`` split into three, each Linear's
key split into two, and each weight drawn ``uniform(-1/sqrt(in),
1/sqrt(in))`` by :mod:`..serving._threefry`, bit for bit as
``jax.random`` draws them.

    python -m flashattn_tpu_torch.training.classifier --dataset Xor
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..module import Module
from ..nn.basic import Linear
from ..optim import SGD
from ..serving import _threefry
from ..utils.datasets import Graph, datasets


def _linear(in_size: int, out_size: int, key, generator, device) -> Linear:
    """A Linear drawn from ``generator``, or from a threefry ``key`` as the
    JAX module's ``Linear(in, out, key=key)`` draws it."""
    lin = Linear(in_size, out_size, generator=generator, device=device)
    if key is not None:
        bound = 1.0 / (in_size**0.5)
        k0, k1 = _threefry.split(key)
        with torch.no_grad():
            lin.weights.copy_(_threefry.uniform(
                (k0[0], k1[0]), (in_size, out_size), -bound, bound))
            lin.bias.copy_(_threefry.uniform(
                (k0[1], k1[1]), (out_size,), -bound, bound))
    return lin


class Network(Module):
    """2 -> hidden -> hidden -> 1 MLP with ReLU activations and a sigmoid
    output (the classic minitorch ``Network`` shape).  The weights come from
    a threefry ``key`` (the pair of words ``serving._threefry.prng_key``
    gives: JAX's weights for the same key) or else from ``generator``."""

    def __init__(self, hidden: int = 10, *, key=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        keys = [None] * 3
        if key is not None:
            k0, k1 = _threefry.split(key, 3)
            keys = [(k0[i], k1[i]) for i in range(3)]
        self.layer1 = _linear(2, hidden, keys[0], generator, device)
        self.layer2 = _linear(hidden, hidden, keys[1], generator, device)
        self.layer3 = _linear(hidden, 1, keys[2], generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.layer1(x))
        h = torch.relu(self.layer2(h))
        return torch.sigmoid(self.layer3(h))[..., 0]


def binary_nll(probs: torch.Tensor, labels: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """- mean( y·log p + (1−y)·log(1−p) ), p clipped to [eps, 1 − eps]: the
    reference's per-point ``(prob.log() * y + (1-prob).log() * (1-y))``
    loss."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))


def train_classifier(
    dataset: Union[str, Graph] = "Xor",
    n_points: int = 100,
    hidden: int = 10,
    lr: float = 0.5,
    epochs: int = 500,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> Tuple[Network, float]:
    """Train full-batch from JAX's initial weights for ``seed``; returns
    (model, final accuracy).  One step is forward, backward and the SGD
    update in place, the data and weights on ``device`` (the card unless
    named) throughout; the loss reaches the host only when ``verbose``
    prints it."""
    device = torch.device("cuda" if device is None else device)
    graph = (datasets[dataset](n_points, seed=seed)
             if isinstance(dataset, str) else dataset)
    X = torch.as_tensor(np.asarray(graph.X, dtype=np.float32), device=device)
    y = torch.as_tensor(np.asarray(graph.y, dtype=np.float32), device=device)

    model = Network(hidden, key=_threefry.prng_key(torch.tensor(seed)),
                    device=device)
    opt = SGD(lr=lr)
    state = opt.init(model)
    names, params = zip(*model.named_parameters())

    for epoch in range(epochs):
        loss = binary_nll(model(X), y)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        model, state = opt.step(model, grads, state)
        if verbose and (epoch % max(1, epochs // 10) == 0):
            print(f"epoch {epoch:4d}  loss {float(loss):.4f}")

    with torch.no_grad():
        acc = float(torch.mean(((model(X) > 0.5).float() == y).float()))
    return model, acc


def main(dataset: str = "Xor", n_points: int = 100, hidden: int = 10,
         lr: float = 0.5, epochs: int = 500, seed: int = 0,
         device=None) -> None:
    _, acc = train_classifier(dataset, n_points, hidden, lr, epochs, seed,
                              verbose=True, device=device)
    print(f"{dataset}: final accuracy {acc:.3f}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="Xor", choices=sorted(datasets))
    ap.add_argument("--n-points", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    main(**vars(ap.parse_args()))
