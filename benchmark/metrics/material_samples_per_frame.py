"""Atlas samples a frame by the program's counter ``material_samples``
(the lanes of every material map sampled, at every span path). Nothing
where the program keeps no such counter."""
from hrbench import spans


def read(record):
    prog = spans.program(record)
    n = sum(prog["counters"].get("material_samples", {}).values()) if prog else 0
    return n / record["frames"] if n else None
