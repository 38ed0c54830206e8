"""ScreenRule — pluggable certificate geometry for the SAIF screens.

A copy of ``repro.core.screen_rule`` (the port imports nothing
from ``repro``); the text below speaks of the reference package's modules.

PRs 1-8 made the screening *kernels* fast (fused Pallas, one-gemm batched,
certified mixed precision) but every solve still used the one Theorem-2
sphere rule. This module splits the remaining axis: the **rule** decides
the certificate geometry — which ball is screened against, what bound form
the ADD phase uses, and whether the final stop must pass a safe post-check
— while the **backend** (:mod:`repro.core.screen_backend`) only computes
bounds fast. Three rules ship (DESIGN.md §13):

``saif``
    Today's default, bitwise-unchanged: the gap-safe ball intersected with
    the Theorem-2 sequential ball (Eq. 12), the delta radius ramp on the
    ADD stop, no post-check. Every decision is safe per step.

``gap_safe``
    The Fercoq-Gramfort-Salmon gap sphere alone: identical engine trace to
    ``saif`` minus the sequential-ball intersection (the gap radius is
    derived from the fused dual/gap tail every InnerBackend already
    maintains, so the rule costs nothing extra per step). Strictly safe;
    preferable on warm lambda-path steps where the entry gap is tiny and
    the Theorem-2 ball adds only arithmetic.

``hybrid``
    The Zeng-Yang-Breheny safe-strong composition adapted to SAIF's
    incremental loop: the ADD phase screens with the **point** bound
    (radius 0 — pure KKT violation at the current dual iterate, the
    aggressive strong-rule analogue), stops recruiting as soon as no
    feature violates, and skips the delta ramp entirely; the solver then
    polishes, and the final stop is gated by a vectorized **safe
    post-check** — one full screen at the certified gap-safe radius. Any
    violator denies the stop and is recruited on the spot (the in-loop
    ``lax.cond`` fallback to the safe certificate), so the SAIF safety
    guarantee is preserved by construction: no solve can terminate
    without a passing safe certificate. DELs stay on the safe ball at
    every step under every rule.

This module is deliberately import-light (no jax): ``ScreenRule`` and
:func:`resolve_screen_rule` are part of the PEP-562 lazy public surface
(``from repro import ScreenRule`` must not pull the engines in).
"""
from __future__ import annotations

import dataclasses
from typing import Union

VALID_BOUNDS = ("ball", "point")


@dataclasses.dataclass(frozen=True)
class ScreenRule:
    """Certificate geometry of a screening rule (DESIGN.md §13).

    The engine consumes exactly four facts:

    * ``use_seq_ball`` — intersect the Theorem-2 sequential ball into the
      per-step safe region (``saif`` only; composed with the caller-level
      gates that already disable the seq ball for weighted / unpenalized
      problems);
    * ``add_bound`` — the bound form of the ADD-phase screen: ``"ball"``
      evaluates ``ub_i = |x_i^T c| + ||x_i|| r`` at the (delta-shrunk)
      safe radius, ``"point"`` at radius 0 (``ub_i = |x_i^T c|``, the
      strong-rule analogue — ADD decisions are then *unsafe-aggressive*
      and must be covered by a post-check before the solve may stop);
    * ``post_check`` — the final stop additionally requires one full
      screen at the **unshrunk** safe radius to certify no feature was
      wrongly discarded; violators deny the stop and are recruited
      (the safe fallback);
    * ``delta_ramp`` — whether the ADD stop walks the paper's delta
      radius ramp (point-bound rules stop recruiting immediately);
    * ``newton_polish`` — once recruiting quiesces, propose the exact
      working-set solution from the gram carry (one masked solve of
      ``G b = rho - lam sign``) each polish step; the proposal is
      accepted only if the *official* duality gap certifies it beats the
      CM iterate, so a wrong sign pattern or singular working set just
      falls back to the CM burst — the certificate path is unchanged.
      Applied only where the quantities exist (least-squares loss with
      the ``gram`` inner backend); elsewhere the rule degrades to plain
      CM polish.

    Safety invariant: ``add_bound == "point"`` requires ``post_check``
    (enforced in ``__post_init__``) — an aggressive discard without a
    safe gate on termination would forfeit the SAIF guarantee.
    """
    name: str
    use_seq_ball: bool = True
    add_bound: str = "ball"
    post_check: bool = False
    delta_ramp: bool = True
    newton_polish: bool = False

    def __post_init__(self):
        if self.add_bound not in VALID_BOUNDS:
            raise ValueError(
                f"add_bound must be one of {VALID_BOUNDS}, "
                f"got {self.add_bound!r}")
        if self.add_bound == "point" and not self.post_check:
            raise ValueError(
                "add_bound='point' discards aggressively (strong-rule "
                "semantics); it requires post_check=True so termination "
                "is gated by a safe certificate")


SCREEN_RULES = {
    "saif": ScreenRule("saif", use_seq_ball=True, add_bound="ball",
                       post_check=False, delta_ramp=True),
    "gap_safe": ScreenRule("gap_safe", use_seq_ball=False, add_bound="ball",
                           post_check=False, delta_ramp=True),
    "hybrid": ScreenRule("hybrid", use_seq_ball=False, add_bound="point",
                         post_check=True, delta_ramp=False,
                         newton_polish=True),
}


def resolve_screen_rule(rule: Union[str, ScreenRule]) -> ScreenRule:
    """Rule-selection policy: a name resolves through the registry, a
    :class:`ScreenRule` instance passes through (custom geometries keep
    the same seam the built-ins use)."""
    if isinstance(rule, ScreenRule):
        return rule
    try:
        return SCREEN_RULES[rule]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown screen rule {rule!r}: expected one of "
            f"{sorted(SCREEN_RULES)} or a ScreenRule instance") from None
