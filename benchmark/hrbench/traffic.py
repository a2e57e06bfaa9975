"""The general generator of every traffic mix: a mix file's parameters and
a configuration's camera path, turned into the frame sequence of one run.

A frame is (eye, target, restart): where the camera is, and whether an
accumulation starts anew there. The sequence is a function of the mix,
the path and the seed alone, never of how fast frames run. The seed draws
the start time on the path, then one checked frame in each of the mix's
``check_frames.window_picks`` ranges of window frames. How path time
advances from frame to frame is the frame kind's (``frames`` in the mix,
``benchmark/frames/<kind>.py``, its ``time_of``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Keyframe:
    eye: Vec3
    target: Vec3
    time: float


def keyframes(path: Sequence[dict]) -> List[Keyframe]:
    """A configuration's ``camera_path`` as keyframes, in time order."""
    kf = [Keyframe(tuple(map(float, k["eye"])), tuple(map(float, k["target"])),
                   float(k["time"])) for k in path]
    if len(kf) < 2 or any(b.time <= a.time for a, b in zip(kf, kf[1:])):
        raise ValueError("camera_path needs two or more keyframes in increasing time")
    return kf


def _catmull_rom(p0, p1, p2, p3, t):
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (2.0 * p1 + (-p0 + p2) * t + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * t2
                  + (-p0 + 3.0 * p1 - 3.0 * p2 + p3) * t3)


def sample_path(kf: Sequence[Keyframe], t: float) -> Tuple[Vec3, Vec3]:
    """(eye, target) at time t of the loop: the demo player's spline
    (a copy of ``utils/animation.DemoPlayer.sample``)."""
    seg = len(kf) - 2
    for i in range(len(kf) - 1):
        if kf[i].time <= t <= kf[i + 1].time:
            seg = i
            break
    t0, t1 = kf[seg].time, kf[seg + 1].time
    u = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)

    def pget(i, attr):
        i = int(np.clip(i, 0, len(kf) - 1))
        return np.asarray(getattr(kf[i], attr), np.float64)

    out = []
    for attr in ("eye", "target"):
        p = _catmull_rom(pget(seg - 1, attr), pget(seg, attr), pget(seg + 1, attr),
                         pget(seg + 2, attr), u)
        out.append(tuple(float(v) for v in p))
    return out[0], out[1]


class Schedule:
    """The frames of one run: ``frame(i)`` for i = 0, 1, ... (the first
    ``warm`` of them are set-up), and the frames kept for the check."""

    def __init__(self, mix: dict, camera_path: Sequence[dict], seed: int, kind):
        self.mix = mix
        self.kind = kind
        self.kf = keyframes(camera_path)
        self.duration = self.kf[-1].time
        self.rng = np.random.default_rng(int(seed))
        self.start = float(self.rng.uniform(0.0, self.duration))
        self.warm = int(mix["warm_frames"])
        self.in_flight = int(mix["frames_in_flight"])
        check = mix["check_frames"]
        picks = [self.warm + int(self.rng.integers(int(a), int(b)))
                 for a, b in check["window_picks"]]
        self.checked = sorted(set(([0] if check.get("start") else []) + picks))

    def time_of(self, i: int) -> Tuple[float, bool]:
        """(path time, restart) of frame i."""
        t, restart = self.kind.time_of(self.mix, self.start, self.duration, i)
        return t % self.duration, bool(restart)

    def frame(self, i: int):
        """(eye, target, restart) of frame i."""
        t, restart = self.time_of(i)
        eye, target = sample_path(self.kf, t)
        return eye, target, restart
