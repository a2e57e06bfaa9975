"""What decides ``correct``: the frames the timed path produced, held to
the plain reference (``benchmark/reference/hrref``) once the window has
closed. What is rendered and compared is the frame kind's
(``benchmark/frames/<kind>.py``); the arithmetic is here.

The reference follows the program one frame at a time: for a checked
frame k it reads the program's state after frame k-1 (copied when frame
k was issued) into its own classes, field by field and by name, renders
frame k itself, and holds the program's state after frame k and its
outputs to its own, again by the reference's field names. Frame 0 starts
from the reference's own empty state, so the start is checked on its own.

Each number compared is the share of values, over one layer's planes,
that lie off the reference by more than ``ATOL + RTOL * |reference|``
(any NaN counts as off; integer planes must be equal), the worst of the
checked frames. The control is the reference itself with its planes
rounded through bfloat16 as the passes hand them on, put in the
program's place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

ATOL = 1e-4
RTOL = 1e-4


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _is_dataclass(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def pairs(got, ref) -> List[Tuple[object, torch.Tensor]]:
    """(program's value, reference's tensor) for every tensor
    of `ref` (a tensor, or a dataclass of them, nested), the program's
    value taken from `got` by the same field names (None where it has no
    such field). Fields the program has beyond the reference's are not
    compared."""
    if isinstance(ref, torch.Tensor):
        return [(got, ref)]
    if _is_dataclass(ref):
        out = []
        for f in dataclasses.fields(ref):
            out += pairs(getattr(got, f.name, None), getattr(ref, f.name))
        return out
    return []


def off_counts(got: torch.Tensor, ref: torch.Tensor):
    """(values off, values) of one plane."""
    if got.shape != ref.shape:
        return ref.numel() or 1, ref.numel() or 1
    if not got.dtype.is_floating_point:
        return int((got != ref).sum()), ref.numel()
    g, r = got.to(torch.float32), ref.to(torch.float32)
    ok = (g - r).abs() <= ATOL + RTOL * r.abs()
    return int((~ok).sum()), ref.numel()


def off_share(got, ref) -> float:
    """Share of the values of `ref`'s planes that the matching planes of
    `got` miss; a plane the program lacks, or of another shape, is off
    throughout."""
    off = total = 0
    for g, r in pairs(got, ref):
        if isinstance(g, torch.Tensor):
            o, n = off_counts(g.to(r.device), r)
        else:
            o = n = r.numel() or 1
        off, total = off + o, total + n
    return off / max(total, 1)


def as_reference(template, x):
    """The program's `x` in the reference's structure `template` (one of
    the reference's own values, such as its empty state): every field of
    `template` taken from `x` by name, nested, and its tensors cloned onto
    the template's device, so that nothing the reference does reaches
    the program's. A field the program lacks raises ``AttributeError``."""
    if _is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: as_reference(getattr(template, f.name), getattr(x, f.name))
            for f in dataclasses.fields(template) if f.init})
    if isinstance(x, torch.Tensor):
        device = template.device if isinstance(template, torch.Tensor) else x.device
        return x.to(device).clone()
    return x


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst reading of each number over the checked frames."""
    out: Dict[str, float] = {}
    for rd in readings:
        for k, v in rd.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
