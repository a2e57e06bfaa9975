"""The denoisers' stencils, plain: the SVGF à-trous chain and the
separable bilateral blur, built on ops/filters.py (a frozen copy of the
port's plain versions in ``ops/stencil.py``)."""
from __future__ import annotations

from hrref.ops import filters


def atrous_chain(color, variance, normal, depth, mask, *, steps, radius=1,
                 phi_color=10.0, phi_normal=32.0, sigma_depth=1.0,
                 feedback_iteration=1):
    """The chain of ``filters.atrous_iteration`` calls. Returns (final,
    feedback, variance); feedback is the output of iteration
    `feedback_iteration`, or the input if the chain is shorter."""
    feedback = color
    for i, step in enumerate(steps):
        color, variance = filters.atrous_iteration(
            color, variance, normal, depth, step=step, radius=radius,
            phi_color=phi_color, phi_normal=phi_normal,
            sigma_depth=sigma_depth, mask=mask)
        if i == feedback_iteration:
            feedback = color
    return color, feedback, variance


def bilateral_blur(img, normal, depth, mask, *, radius=4, depth_phi=1.0,
                   normal_power=32.0):
    """Vertical then horizontal bilateral Gaussian (sigma = radius/1.5)
    with normal/depth edge stops; pixels outside `mask` keep their
    input."""
    return filters.bilateral_blur_separable(
        img, normal, depth, radius=radius, depth_phi=depth_phi,
        normal_power=normal_power, mask=mask)
