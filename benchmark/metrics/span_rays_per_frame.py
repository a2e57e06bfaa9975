"""Rays a frame by the program's own ``rays`` counter, which every tracer
call adds to its span (each request of a ``.many`` call, a sharded call
once): ``rays_per_frame`` counted inside the program."""
from hrbench import spans


def read(record):
    prog = spans.program(record)
    n = sum(prog["counters"].get("rays", {}).values()) if prog else 0
    return n / record["frames"] if n else None
