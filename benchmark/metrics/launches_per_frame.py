"""Kernels on the card a frame, from the profiler's device rows."""


def read(record):
    return record["kernels"] / record["frames"]
