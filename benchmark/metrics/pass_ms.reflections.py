"""Host wall a frame inside the benchmark's range around
``reflections_pass``: the time the frame loop spends issuing the pass,
its waits for the card included."""


def read(record):
    t = record["host_s"].get("reflections_pass")
    return None if t is None else t * 1e3 / record["frames"]
