"""Host wall a frame inside the program's spans ``direct_light`` (the
direct light of a batch of hits: the path tracer's bounces, DDGI's probe
hits, the reflection hits), every span path that ends in
``/direct_light`` summed, read from the program's span record. Nothing
where the program has no such span."""
from hrbench import spans


def read(record):
    prog = spans.program(record)
    rows = [row for path, row in (prog["spans"] if prog else {}).items()
            if path.endswith("/direct_light")]
    if not rows:
        return None
    return sum(row["host_s"] for row in rows) * 1e3 / record["frames"]
