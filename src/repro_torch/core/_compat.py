"""One-shot deprecation notices for the legacy frontends (port of
``repro.core._compat``).

Every pre-session frontend (``saif_path``, ``saif_batch``, ``cv_path``,
``saif_fused``, ``fused_path``) delegates to a one-shot
:mod:`repro_torch.core.api` session and announces the migration once per
process. The message holds the literal ``use repro_torch.open_session``,
a pattern a caller can turn into an error to keep its own code off the
deprecated surface.
"""
from __future__ import annotations

import warnings

_WARNED: set = set()


def warn_deprecated(old: str, new: str) -> None:
    """Emit the one-shot ``DeprecationWarning`` for a legacy frontend:
    ``old`` is the legacy callable, ``new`` the session-side call. Once per
    process, so request loops built on a shim do not spam."""
    if old in _WARNED:
        return
    _WARNED.add(old)
    warnings.warn(
        f"{old} is deprecated: use repro_torch.open_session(...) and "
        f"{new} instead", DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    """Forget which one-shot warnings already fired (test hook)."""
    _WARNED.clear()
