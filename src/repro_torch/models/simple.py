"""The paper's own experiment models (port of ``repro/models/simple.py``).

* Case I: a 784 -> hidden -> hidden -> 10 classifier with one ReLU and a
  softmax output -- smooth, non-convex.
* Case II: ridge regression -- smooth and strongly convex.

Parameters are plain ``dict[str, Tensor]`` in the reference's layout:
``w1: [in, hidden]`` and ``x @ w1 + b1`` (not ``nn.Linear``'s [out, in]).
Initial weights are drawn on a CPU ``torch.Generator`` and then moved to
``device``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_mlp_classifier(generator: torch.Generator, in_dim: int = 784,
                        hidden: int = 64, num_classes: int = 10,
                        device="cpu") -> Params:
    s1, s2, s3 = (1 / math.sqrt(in_dim), 1 / math.sqrt(hidden),
                  1 / math.sqrt(hidden))

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    params = {
        "w1": normal(in_dim, hidden) * s1,
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, hidden) * s2,
        "b2": torch.zeros(hidden),
        "w3": normal(hidden, num_classes) * s3,
        "b3": torch.zeros(num_classes),
    }
    return {k: v.to(device) for k, v in params.items()}


def mlp_classifier_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w1"] + params["b1"]
    h = torch.relu(h)
    h = h @ params["w2"] + params["b2"]
    return h @ params["w3"] + params["b3"]


def mlp_classifier_loss(params: Params, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy; y: [B] int labels."""
    logp = torch.log_softmax(mlp_classifier_logits(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y[:, None]))


def mlp_classifier_accuracy(params: Params, x: torch.Tensor,
                            y: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(mlp_classifier_logits(params, x), dim=-1)
    return torch.mean((pred == y).float())


def init_ridge(generator: torch.Generator, dim: int, device="cpu") -> Params:
    w = torch.randn((dim,), generator=generator, dtype=torch.float32) * 0.1
    return {"w": w.to(device)}


def ridge_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
               lam: float) -> torch.Tensor:
    """(1/2B) ||X w - y||^2 + (lam/2) ||w||^2."""
    r = x @ params["w"] - y
    return 0.5 * torch.mean(r * r) + 0.5 * lam * torch.sum(params["w"] ** 2)


def ridge_constants(x_all: torch.Tensor,
                    lam: float) -> Tuple[float, float, float]:
    """Exact (L, M) of the global ridge loss and the Hessian's condition
    number: Hessian = X^T X / D + lam I -> L = lmax + lam, M = lmin + lam."""
    h = (x_all.T @ x_all) / x_all.shape[0]
    eig = torch.linalg.eigvalsh(h)
    return (float(eig[-1] + lam), float(eig[0] + lam),
            float(eig[-1] / torch.clamp(eig[0], min=1e-12)))


def ridge_optimum(x_all: torch.Tensor, y_all: torch.Tensor,
                  lam: float) -> torch.Tensor:
    """Closed-form global minimizer of the global ridge loss."""
    d = x_all.shape[1]
    a = x_all.T @ x_all / x_all.shape[0] + lam * torch.eye(
        d, dtype=x_all.dtype, device=x_all.device)
    b = x_all.T @ y_all / x_all.shape[0]
    return torch.linalg.solve(a, b)
