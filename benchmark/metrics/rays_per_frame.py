"""Rays handed to the closest-hit and visibility entry points a frame,
counted by the benchmark's wrappers of the renderer's tracers."""


def read(record):
    return record["rays"] / record["frames"] if record["rays"] else None
