"""Host wall a frame inside the program's spans ``material`` (the material
maps sampled at a batch of hits: the G-buffer's, DDGI's probe hits, the
reflection hits), every span path that ends in ``/material`` summed, read
from the program's span record. Nothing where the program has no such
span: an untextured scene opens none."""
from hrbench import spans


def read(record):
    prog = spans.program(record)
    rows = [row for path, row in (prog["spans"] if prog else {}).items()
            if path.endswith("/material")]
    if not rows:
        return None
    return sum(row["host_s"] for row in rows) * 1e3 / record["frames"]
