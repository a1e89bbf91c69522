"""Launch-ownership protocol: who owns a launch's scoped state.

Counterpart of `spark_sklearn_tpu/parallel/ownership.py` (:48-140).  A
multi-rung search (`search/halving.py`) attaches its rung context to the
search object for the rung loop, and the grid reads it back with
`current_owner` instead of probing a private attribute it does not own:

  - `LaunchOwner` is the base type and declares, with inert defaults,
    the attributes the grid reads from an attached owner;
  - `attach_owner` / `detach_owner` / `current_owner` are the only way
    an owner travels on a search.

The port's grid reads one thing from a rung owner: the namespace of its
chunk ids (``r1:0:0:24``).  The reference's owners also carry the shared
chunk pipeline, the report registry, the data-plane and memory counter
baselines and a fused launch's members; those modules are not ported,
and neither are their fields.  Standard library only.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = [
    "LaunchOwner",
    "attach_owner",
    "current_owner",
    "detach_owner",
]

#: the single attribute owners travel on (set and cleared only through
#: attach_owner/detach_owner)
_ATTR = "_launch_owner"


class LaunchOwner:
    """Base of the launch-ownership protocol: the object holding state
    that spans several `evaluate_candidates` calls of one search.

    The class attributes are the contract the grid reads from an
    attached owner; subclasses override what they mean.  `kind` names
    the owner's flavor ("rung" for a halving rung)."""

    kind: str = "owner"
    #: chunk-id namespace prefix ("" = the search's root namespace)
    ns: str = ""


def attach_owner(search: Any, owner: LaunchOwner) -> LaunchOwner:
    """Attach `owner` to `search` for the duration of its scope.  Rejects
    anything that is not a `LaunchOwner`, and nested attachment (detach
    the current owner first)."""
    if not isinstance(owner, LaunchOwner):
        raise TypeError(
            f"launch owner must be a LaunchOwner, got "
            f"{type(owner).__name__}")
    if getattr(search, _ATTR, None) is not None:
        raise RuntimeError(
            f"search already has an attached {current_owner(search).kind}"
            " owner; detach_owner() it before attaching another")
    setattr(search, _ATTR, owner)
    return owner


def detach_owner(search: Any) -> Optional[LaunchOwner]:
    """Clear and return the search's attached owner (None if none)."""
    owner = getattr(search, _ATTR, None)
    if owner is not None:
        setattr(search, _ATTR, None)
    return owner


def current_owner(search: Any,
                  kind: Optional[str] = None) -> Optional[LaunchOwner]:
    """The owner attached to `search` (of `kind`, where given), or
    None."""
    owner = getattr(search, _ATTR, None)
    if owner is None:
        return None
    if not isinstance(owner, LaunchOwner):
        raise TypeError(
            f"search carries a non-protocol launch owner "
            f"({type(owner).__name__}); attach it through attach_owner")
    if kind is not None and owner.kind != kind:
        return None
    return owner
