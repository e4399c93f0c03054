"""Monte-Carlo samplers as batch-vectorized functions (PyTorch port of
``simple_spectral_tpu.render.sampling``).

Keys are explicit threefry keys (``simple_spectral_torch.random``) drawn in
the JAX package's order, so each sampler returns the same numbers as its JAX
counterpart.  Every division that can hit 0/0 on degenerate inputs is masked
before the division.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.render.vec import V3, dot

PI = 3.14159265358979323846
TWO_PI = 2.0 * PI
# Largest float32 strictly below pi (reference src/util/spherical-tri.cpp:10-16).
PI_UNDER = float(np.array(0x40490FDA, np.uint32).view(np.float32))


def uniform(key, shape, device) -> torch.Tensor:
    return rnd.uniform(key, shape, device=device)


# --- orthonormal basis (reference src/util/math-helpers.hpp:14-38) ---


def onb_from_y(basis_y: V3) -> Tuple[V3, V3]:
    """Branchless ONB from a unit vector treated as the +y axis (Duff et
    al.); returns (basis_x, basis_z)."""
    sign = torch.where(basis_y.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + basis_y.z)
    b = basis_y.x * basis_y.y * a
    basis_x = V3(1.0 + sign * basis_y.x * basis_y.x * a, sign * b, -sign * basis_y.x)
    basis_z = V3(b, sign + basis_y.y * basis_y.y * a, -basis_y.y)
    return basis_x, basis_z


def rotated_to(dir_local: V3, normal: V3) -> V3:
    """Rotate a y-up local direction into the frame whose +y is ``normal``
    (reference src/util/math-helpers.hpp:34-38)."""
    bx, bz = onb_from_y(normal)
    return V3(
        dir_local.x * bx.x + dir_local.y * normal.x + dir_local.z * bz.x,
        dir_local.x * bx.y + dir_local.y * normal.y + dir_local.z * bz.y,
        dir_local.x * bx.z + dir_local.y * normal.z + dir_local.z * bz.z,
    )


def reflect(vec: V3, normal: V3) -> V3:
    """reference src/util/math-helpers.hpp:40-42 (vec points away from the
    surface, i.e. w_o)."""
    s = 2.0 * dot(vec, normal)
    return V3(s * normal.x - vec.x, s * normal.y - vec.y, s * normal.z - vec.z)


# --- hemisphere sampling ---


def rand_coshemi(key, shape, eps: float, device) -> Tuple[V3, torch.Tensor]:
    """Cosine-weighted hemisphere sample around +y, pdf = cos/pi.

    The reference rejection-samples until pdf > EPS (src/util/random.cpp:
    29-49); as in the JAX package the cosine is clamped away from zero
    instead.  Returns (dir V3[...], pdf f32[...])."""
    ka, kb = rnd.split(key)
    angle = uniform(ka, shape, device) * TWO_PI
    radius_sq = uniform(kb, shape, device)
    radius_sq = torch.clamp_max(radius_sq, 1.0 - (eps * 1.01) ** 2)
    radius = torch.sqrt(radius_sq)
    y = torch.sqrt(1.0 - radius_sq)
    d = V3(radius * torch.cos(angle), y, radius * torch.sin(angle))
    return d, y * (1.0 / PI)


# --- cone cap toward a sphere (reference src/util/random.cpp:51-99) ---


def rand_toward_sphere(key, to_center: V3, radius: torch.Tensor) -> Tuple[V3, torch.Tensor]:
    """Uniform direction over the spherical cap a sphere subtends, and the
    cap's area (the reciprocal pdf).

    The reference's recipe: sample a sphere shrunk by 0.99999 so that the
    direction surely hits the real one; cos(theta) = sqrt(1 - (r/l)^2);
    y uniform on [cos(theta), 1], phi uniform, rotated so that +y is the
    centre direction.  From inside the sphere every direction hits: uniform
    over the full sphere (area 4 pi).  As in the JAX package, 1 - cos(theta)
    is computed in f32 in the stable form x^2 / (1 + cos(theta)), where the
    reference uses double."""
    ka, kb = rnd.split(key)
    device = to_center.x.device
    l2 = dot(to_center, to_center)
    l = torch.sqrt(torch.clamp_min(l2, 1e-24))
    inside = l < radius
    x = torch.clamp((radius * 0.99999) / l, 0.0, 1.0)
    cos_theta = torch.sqrt(torch.clamp_min(1.0 - x * x, 0.0))
    one_minus = torch.where(inside, 2.0, x * x / (1.0 + cos_theta))
    area = TWO_PI * one_minus
    y = 1.0 - uniform(ka, l.shape, device) * one_minus  # in [cos(theta), 1]
    phi = uniform(kb, l.shape, device) * TWO_PI
    rad = torch.sqrt(torch.clamp_min(1.0 - y * y, 0.0))
    local = V3(rad * torch.cos(phi), y, rad * torch.sin(phi))
    inv_l = 1.0 / l
    axis = V3(to_center.x * inv_l, to_center.y * inv_l, to_center.z * inv_l)
    return rotated_to(local, axis), area


# --- spherical triangle (reference src/util/spherical-tri.{hpp,cpp}) ---


class SphericalTriangle(NamedTuple):
    A: V3  # unit vectors
    B: V3
    C: V3
    cos_c: torch.Tensor
    b: torch.Tensor
    cos_alpha: torch.Tensor
    alpha: torch.Tensor
    area: torch.Tensor  # spherical excess (0 when degenerate)
    degenerate: torch.Tensor


def spherical_triangle(A: V3, B: V3, C: V3) -> SphericalTriangle:
    """The quantities Arvo's sampler needs (reference
    src/util/spherical-tri.cpp:18-123), with the branch ladder collapsed:
    any vertex-angle denominator that is not strictly positive flags the
    triangle degenerate with area 0."""
    cos_a = torch.clamp(dot(B, C), -1.0, 1.0)
    cos_b = torch.clamp(dot(A, C), -1.0, 1.0)
    cos_c = torch.clamp(dot(A, B), -1.0, 1.0)
    a = torch.clamp(torch.arccos(cos_a), 0.0, PI_UNDER)
    b = torch.clamp(torch.arccos(cos_b), 0.0, PI_UNDER)
    c = torch.clamp(torch.arccos(cos_c), 0.0, PI_UNDER)
    sin_a, sin_b, sin_c = torch.sin(a), torch.sin(b), torch.sin(c)

    numer0 = cos_a - cos_b * cos_c
    numer1 = cos_b - cos_c * cos_a
    numer2 = cos_c - cos_a * cos_b
    denom0 = sin_b * sin_c
    denom1 = sin_c * sin_a
    denom2 = sin_a * sin_b

    ok = (denom0 > 0.0) & (denom1 > 0.0) & (denom2 > 0.0)

    def safe(n, d):
        return torch.clamp(n / torch.where(ok, d, 1.0), -1.0, 1.0)

    cos_alpha = safe(numer0, denom0)
    cos_beta = safe(numer1, denom1)
    cos_gamma = safe(numer2, denom2)
    alpha = torch.clamp(torch.arccos(cos_alpha), 0.0, PI_UNDER)
    beta = torch.clamp(torch.arccos(cos_beta), 0.0, PI_UNDER)
    gamma = torch.clamp(torch.arccos(cos_gamma), 0.0, PI_UNDER)
    area = torch.clamp_min(alpha + beta + gamma - PI, 0.0)
    area = torch.where(ok, area, 0.0)
    return SphericalTriangle(
        A=A, B=B, C=C,
        cos_c=cos_c, b=b,
        cos_alpha=torch.where(ok, cos_alpha, 1.0),
        alpha=torch.where(ok, alpha, 0.0),
        area=area,
        degenerate=~ok,
    )


def _bar(x: V3, y: V3) -> V3:
    """normalize(x - dot(x,y) y), or 0 when the projection vanishes
    (reference src/util/random.cpp:137-142)."""
    s = dot(x, y)
    d = V3(x.x - s * y.x, x.y - s * y.y, x.z - s * y.z)
    lensq = dot(d, d)
    ok = lensq > 0.0
    r = torch.where(ok, torch.rsqrt(torch.where(ok, lensq, 1.0)), 0.0)
    return V3(d.x * r, d.y * r, d.z * r)


def rand_toward_spherical_triangle(key, tri: SphericalTriangle) -> V3:
    """Arvo 1995 spherical-triangle sample (reference
    src/util/random.cpp:101-154).  Returns a unit direction; the pdf is
    1/tri.area (handled by the caller)."""
    k0, k1 = rnd.split(key)
    shape, device = tri.area.shape, tri.area.device
    r0 = uniform(k0, shape, device)
    r1 = uniform(k1, shape, device)

    sin_alpha = torch.sin(tri.alpha)
    random_area = r0 * tri.area
    phi = random_area - tri.alpha
    s = torch.sin(phi)
    t = torch.cos(phi)
    u = t - tri.cos_alpha
    v = s + sin_alpha * tri.cos_c
    denom = (v * s + u * t) * sin_alpha
    denom_ok = denom != 0.0
    q_main = torch.where(
        denom_ok,
        ((v * t - u * s) * tri.cos_alpha - v) / torch.where(denom_ok, denom, 1.0),
        tri.cos_c,
    )
    # degenerate-alpha path: interpolate the angle linearly (random.cpp:131-136)
    q_degen = torch.cos(tri.b * r0)
    q = torch.where(sin_alpha > 0.0, q_main, q_degen)
    q = torch.clamp(q, -1.0, 1.0)

    bar_ca = _bar(tri.C, tri.A)
    sq = torch.sqrt(torch.clamp_min(1.0 - q * q, 0.0))
    c_hat = V3(q * tri.A.x + sq * bar_ca.x, q * tri.A.y + sq * bar_ca.y, q * tri.A.z + sq * bar_ca.z)
    z = 1.0 - r1 * (1.0 - dot(c_hat, tri.B))
    z = torch.clamp(z, -1.0, 1.0)
    bar_cb = _bar(c_hat, tri.B)
    sz = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return V3(z * tri.B.x + sz * bar_cb.x, z * tri.B.y + sz * bar_cb.y, z * tri.B.z + sz * bar_cb.z)
