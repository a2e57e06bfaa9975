"""K1+K2's share of their roofline: the least time of the traced frames'
tracer calls (each ray read once as 32 bytes, each result written once,
each triangle read once as 36 bytes, at the HBM peak; no tree walk) over
the kernels' device time."""


def read(record):
    t = record["kernel_s"]["trace"]
    return 100.0 * record["bound_s"]["trace"] / t if t > 0 else None
