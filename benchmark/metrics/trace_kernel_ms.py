"""Device ms a frame of the tracer kernels K1 (closest hit) and K2 (any
hit), by kernel name."""


def read(record):
    t = record["kernel_s"]["trace"]
    return t * 1e3 / record["frames"] if t > 0 else None
