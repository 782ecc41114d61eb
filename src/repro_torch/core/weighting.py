"""FedAdp adaptive weighting (paper Eqs. 8-11) and the FedAvg baseline.

The torch counterpart of `repro/core/weighting.py`. Plain functions on
(K,) f32 tensors over the participating clients of one round; they run
on whatever device their inputs lie on.

Numerical notes (as in the reference):
  * angles are computed in f32 with the cosine clipped to [-1+eps, 1-eps]
    before arccos;
  * Eq. 11's two cases collapse to one softmax:
      psi_i = D_i e^{f_i} / sum_j D_j e^{f_j} = softmax(f + log D)_i.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

DEFAULT_ALPHA = 5.0
_EPS = 1e-7


class AngleState(NamedTuple):
    """Server-side smoothed-angle state (paper Eq. 9), one slot per client.

    `count` is the number of rounds each client has participated in so far
    (the paper's `t` in Eq. 9).
    """

    smoothed: torch.Tensor  # (N,) f32, radians
    count: torch.Tensor  # (N,) int32

    @classmethod
    def init(cls, num_clients: int,
             device: Optional[torch.device] = None) -> "AngleState":
        return cls(
            smoothed=torch.zeros(num_clients, dtype=torch.float32,
                                 device=device),
            count=torch.zeros(num_clients, dtype=torch.int32, device=device),
        )


def cosine_from_stats(dot: torch.Tensor, sq_a: torch.Tensor,
                      sq_b: torch.Tensor) -> torch.Tensor:
    """cos(theta) from <a,b>, ||a||^2, ||b||^2; guards zero norms."""
    denom = (torch.sqrt(torch.clamp(sq_a, min=_EPS))
             * torch.sqrt(torch.clamp(sq_b, min=_EPS)))
    return torch.clamp(dot / denom, -1.0 + _EPS, 1.0 - _EPS)


def instantaneous_angle(dot: torch.Tensor, sq_local: torch.Tensor,
                        sq_global: torch.Tensor) -> torch.Tensor:
    """theta_i(t), Eq. 8, in radians, elementwise over (K,) stats."""
    return torch.arccos(cosine_from_stats(dot, sq_local, sq_global))


def update_smoothed_angle(state: AngleState, theta: torch.Tensor,
                          selected: torch.Tensor) -> AngleState:
    """Eq. 9 applied to the selected clients' slots.

    selected: (N,) bool mask; theta: (N,) with valid entries where selected.
    """
    new_count = state.count + selected.to(torch.int32)
    t = torch.clamp(new_count, min=1).to(torch.float32)
    smoothed_upd = ((t - 1.0) * state.smoothed + theta) / t
    smoothed = torch.where(selected, smoothed_upd, state.smoothed)
    return AngleState(smoothed=smoothed, count=new_count)


def gompertz(theta: torch.Tensor, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Non-linear contribution mapping f(theta), Eq. 10 (decreasing)."""
    return alpha * (1.0 - torch.exp(-torch.exp(-alpha * (theta - 1.0))))


def fedadp_weights(smoothed_theta: torch.Tensor, data_sizes: torch.Tensor,
                   alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Eq. 11 for the K participating clients: softmax(f(theta~) + log D)."""
    f = gompertz(smoothed_theta.to(torch.float32), alpha)
    logits = f + torch.log(data_sizes.to(torch.float32))
    return torch.softmax(logits, dim=0)


def fedavg_weights(data_sizes: torch.Tensor) -> torch.Tensor:
    """psi_i = D_i / sum D (Eq. 1)."""
    d = data_sizes.to(torch.float32)
    return d / torch.sum(d)


def expected_contribution(weights: torch.Tensor,
                          cos_theta: torch.Tensor) -> torch.Tensor:
    """E_{i|t}[cos theta_i], the Theorem-1 expectation term."""
    return torch.sum(weights * cos_theta)


# ---------------------------------------------------------------- buffered
# Staleness-aware variants for the buffered-async server: a flush
# aggregates only the LANDED reports, and a report applied `age` model
# versions after its pull is discounted by exp(-beta * age). With every
# report landed at age 0 they reduce bit for bit to Eqs. 1 / 11
# (subtracting beta * 0 and multiplying by exp(-0) are exact). Rows that
# did not land are removed by torch.where, never by a multiply by the
# mask: a free row's statistics are 0/0 and its logit -inf.


def staleness_discount(age: torch.Tensor, beta: float) -> torch.Tensor:
    """exp(-beta * age), the decay of a report `age` versions stale."""
    return torch.exp(-beta * age.to(torch.float32))


def buffered_fedadp_weights(smoothed_theta: torch.Tensor,
                            data_sizes: torch.Tensor, age: torch.Tensor,
                            landed: torch.Tensor,
                            alpha: float = DEFAULT_ALPHA,
                            beta: float = 0.0) -> torch.Tensor:
    """Eq. 11 over the landed reports with the decay in the logits:
    softmax(f(theta~) + log D - beta * age), other rows at -inf (weight
    0). Zeros when nothing landed (the softmax of all -inf is NaN)."""
    f = gompertz(smoothed_theta.to(torch.float32), alpha)
    logits = (f + torch.log(data_sizes.to(torch.float32))
              - beta * age.to(torch.float32))
    logits = torch.where(landed, logits, -torch.inf)
    w = torch.softmax(logits, dim=0)
    return torch.where(torch.any(landed), w, torch.zeros_like(w))


def buffered_fedavg_weights(data_sizes: torch.Tensor, age: torch.Tensor,
                            landed: torch.Tensor,
                            beta: float = 0.0) -> torch.Tensor:
    """Eq. 1 over the landed reports with the decay applied to D:
    psi_i = D_i e^{-beta age_i} / sum over the landed of the same."""
    s = torch.where(landed, data_sizes.to(torch.float32)
                    * staleness_discount(age, beta), 0.0)
    return s / torch.clamp(torch.sum(s), min=1e-12)
