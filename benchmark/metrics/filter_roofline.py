"""K3+K4+K5's share of their roofline: the least time of the traced
frames' à-trous, bilateral-blur and DDGI-sampler calls (their inputs read
and outputs written once, their arithmetic at the fp32 peak) over the
kernels' device time."""


def read(record):
    t = record["kernel_s"]["filter"]
    b = record["bound_s"]["filter"]
    return 100.0 * b / t if t > 0 and b > 0 else None
