"""Loss functions for the general LASSO problem (paper Eq. 1-3), in torch.

Port of ``repro.core.losses``. The two losses the paper evaluates:

* least-squares  f(z, y) = 0.5 (z - y)^2          (alpha = 1)
* logistic       f(z, y) = log(1 + exp(-y z))     (alpha = 1/4, labels y in {-1, +1})

Each loss exposes the pieces the SAIF machinery needs:
  value(z, y)        elementwise loss
  grad(z, y)         f'(z, y) w.r.t. z
  conj(u, y)         f*(u, y) elementwise conjugate
  conj_grad(u, y)    f*'(u, y), closed form (the reference takes jax.grad)
  smoothness         alpha such that f'' <= alpha (dual strong convexity 1/alpha)
  dual_clip(u, y)    clamp u into dom f* (identity for LS)
  hess(z, y)         elementwise f''(z, y)

The formulas are the reference's term for term, so the two packages agree
up to the order of reductions.

The objectives, and the dual helpers built on them, also take a stack of
problems, one a row: vectors (B, n), designs (B, n, k) and per-problem
scalars (B,). One problem runs the same operations as before the stack
existed, so serial results keep their bits.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


def mv_last(A: Tensor, v: Tensor) -> Tensor:
    """A v: (n, k) by (k,), or a stack (B, n, k) by (B, k)."""
    return A @ v if A.ndim == 2 else (A @ v[..., None])[..., 0]


def dot_last(a: Tensor, b: Tensor) -> Tensor:
    """The inner product over the last axis (a stack: one a row)."""
    return torch.dot(a, b) if a.ndim == 1 else torch.sum(a * b, dim=-1)


def per_problem(s):
    """A per-problem scalar, shaped to scale (..., n) vectors: a (B,)
    stack gains an axis; a float or a 0-d tensor is returned as is."""
    return s[..., None] if torch.is_tensor(s) and s.ndim else s


@dataclasses.dataclass(frozen=True)
class Loss:
    """Bundle of the loss-specific callables used throughout core/."""

    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    grad: Callable[[Tensor, Tensor], Tensor]
    conj: Callable[[Tensor, Tensor], Tensor]
    conj_grad: Callable[[Tensor, Tensor], Tensor]
    smoothness: float  # alpha: f is alpha-smooth  =>  f* is (1/alpha)-strongly convex
    dual_clip: Callable[[Tensor, Tensor], Tensor]
    hess: Callable[[Tensor, Tensor], Tensor]

    def primal_objective(self, X: Tensor, y: Tensor, beta: Tensor,
                         lam, weights: Tensor | None = None) -> Tensor:
        """P(beta) = sum_j f(x_j. beta, y_j) + lam sum_i w_i |beta_i|;
        ``weights`` (None = all 1) is 0 on an unpenalized coordinate."""
        z = mv_last(X, beta)
        l1 = torch.abs(beta) if weights is None else weights * torch.abs(beta)
        return (torch.sum(self.value(z, y), dim=-1)
                + lam * torch.sum(l1, dim=-1))

    def dual_objective(self, y: Tensor, theta: Tensor, lam) -> Tensor:
        """D(theta) = -sum_j f*(-lam theta_j, y_j)   (paper Eq. 2)."""
        return -torch.sum(self.conj(-per_problem(lam) * theta, y), dim=-1)


# --------------------------------------------------------------------------
# Least squares: f(z, y) = 0.5 (z - y)^2
#   f'(z, y)  = z - y
#   f*(u, y)  = 0.5 u^2 + u y,   f*'(u, y) = u + y
# --------------------------------------------------------------------------

def _ls_value(z, y):
    d = z - y
    return 0.5 * d * d


def _ls_grad(z, y):
    return z - y


def _ls_conj(u, y):
    return 0.5 * u * u + u * y


def _ls_conj_grad(u, y):
    return u + y


def _ls_dual_clip(u, y):
    return u


def _ls_hess(z, y):
    return torch.ones_like(z)


least_squares = Loss(
    name="least_squares",
    value=_ls_value,
    grad=_ls_grad,
    conj=_ls_conj,
    conj_grad=_ls_conj_grad,
    smoothness=1.0,
    dual_clip=_ls_dual_clip,
    hess=_ls_hess,
)


# --------------------------------------------------------------------------
# Logistic: f(z, y) = log(1 + exp(-y z)), y in {-1, +1}
#   f'(z, y)  = -y sigma(-y z)
#   f*(u, y): with s = -u y in [0, 1],
#       f*(u, y) = s log s + (1 - s) log(1 - s)
#   f*'(u, y) = -y (log s - log(1 - s)) inside (0, 1); the reference's
#       autodiff of its where-guarded xlogx gives 0 for a side that is <= 0,
#       and so does this closed form.
# --------------------------------------------------------------------------

def _xlogx(s):
    pos = s > 0
    return torch.where(pos, s * torch.log(torch.where(pos, s, 1.0)), 0.0)


def _dxlogx(s):
    """d/ds of :func:`_xlogx`: log s + 1 where s > 0, else 0."""
    pos = s > 0
    return torch.where(pos, torch.log(torch.where(pos, s, 1.0)) + 1.0, 0.0)


def _logit_value(z, y):
    return torch.logaddexp(torch.zeros_like(z), -y * z)


def _logit_grad(z, y):
    return -y * torch.sigmoid(-y * z)


def _logit_conj(u, y):
    s = -u * y
    return _xlogx(s) + _xlogx(1.0 - s)


def _logit_conj_grad(u, y):
    s = -u * y
    return -y * _dxlogx(s) + y * _dxlogx(1.0 - s)


def _logit_dual_clip(u, y):
    eps = 1e-12
    s = torch.clamp(-u * y, eps, 1.0 - eps)
    return -s * y


def _logit_hess(z, y):
    s = torch.sigmoid(-y * z)
    return s * (1.0 - s)


logistic = Loss(
    name="logistic",
    value=_logit_value,
    grad=_logit_grad,
    conj=_logit_conj,
    conj_grad=_logit_conj_grad,
    smoothness=0.25,
    dual_clip=_logit_dual_clip,
    hess=_logit_hess,
)


LOSSES = {"least_squares": least_squares, "logistic": logistic}


def get_loss(name: str) -> Loss:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(LOSSES)}")
