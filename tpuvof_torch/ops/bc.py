"""Ghost-cell boundary conditions (counterpart of tpuvof/ops/bc.py).

The j-boundaries are applied first and the i-boundaries second, reading
the updated arrays: corner ghosts hold the value mirrored through the side
neighbour of an already mirrored bottom/top ghost, as in the reference.

Walls: bottom slip (u mirrored, v=0 at the wall face), top with v=0
enforced, left/right slip with no penetration (u=0 on the wall faces).
Scalar fields (F, p, rho) are mirrored with zero gradient.

In 3-D (``apply_bc_3d``) the y-faces come first, then x, then z, the
reference kernel's loop order at edges and corners; w = 0 on the z walls.

``apply_bc``, ``apply_bc_3d`` and ``mirror_scalar`` return new tensors;
``apply_bc_`` and ``apply_bc_3d_`` write into tensors the caller owns.
"""
from __future__ import annotations

__all__ = ["apply_bc", "apply_bc_", "apply_bc_3d", "apply_bc_3d_", "mirror_scalar"]


def mirror_scalar(a):
    """Zero-gradient mirror of a cell-centred scalar into its ghost ring:
    j-boundaries first, then i-boundaries. Returns a new tensor."""
    a = a.clone()
    a[:, 0] = a[:, 1]
    a[:, -1] = a[:, -2]
    a[0, :] = a[1, :]
    a[-1, :] = a[-2, :]
    return a


def apply_bc_(u, v, F, p, rho=None):
    """All wall boundary conditions, in place; returns (u, v, F, p[, rho])."""
    # bottom and top
    u[:, 0] = u[:, 1]
    u[:, -1] = u[:, -2]
    v[:, 1] = 0.0
    v[:, -1] = 0.0  # the "open" top still pins v
    for a in (F, p) if rho is None else (F, p, rho):
        a[:, 0] = a[:, 1]
        a[:, -1] = a[:, -2]
    # left and right (reads see the updated j-ghosts: corner order)
    u[1, :] = 0.0
    u[-1, :] = 0.0
    v[0, :] = v[1, :]
    v[-1, :] = v[-2, :]
    for a in (F, p) if rho is None else (F, p, rho):
        a[0, :] = a[1, :]
        a[-1, :] = a[-2, :]
    return (u, v, F, p) if rho is None else (u, v, F, p, rho)


def apply_bc(u, v, F, p, rho=None):
    """All wall boundary conditions; returns new (u, v, F, p[, rho])."""
    fields = (u, v, F, p) if rho is None else (u, v, F, p, rho)
    return apply_bc_(*(a.clone() for a in fields))


def apply_bc_3d_(u, v, w, F, p, rho=None):
    """The 3-D walls in place, y-faces then x then z; returns (u, v, w, F,
    p[, rho])."""
    scalars = (F, p) if rho is None else (F, p, rho)
    # bottom / top (y)
    for a in (u, w) + scalars:
        a[:, 0, :] = a[:, 1, :]
        a[:, -1, :] = a[:, -2, :]
    v[:, 1, :] = 0.0
    v[:, -1, :] = 0.0
    # left / right (x)
    u[1, :, :] = 0.0
    u[-1, :, :] = 0.0
    for a in (v, w) + scalars:
        a[0, :, :] = a[1, :, :]
        a[-1, :, :] = a[-2, :, :]
    # front / back (z)
    for a in (u, v) + scalars:
        a[:, :, 0] = a[:, :, 1]
        a[:, :, -1] = a[:, :, -2]
    w[:, :, 1] = 0.0
    w[:, :, -1] = 0.0
    return (u, v, w, F, p) if rho is None else (u, v, w, F, p, rho)


def apply_bc_3d(u, v, w, F, p, rho=None):
    """The 3-D walls; returns new (u, v, w, F, p[, rho])."""
    fields = (u, v, w, F, p) if rho is None else (u, v, w, F, p, rho)
    return apply_bc_3d_(*(a.clone() for a in fields))
