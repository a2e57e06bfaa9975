"""Share of the traced frames' wall time in which no operation ran on
the card: the union of the device operations' intervals against the
window."""


def read(record):
    if record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
