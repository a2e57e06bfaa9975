"""Host wall a frame inside the benchmark's ranges around ``ddgi_update``
and ``sample_probe_grid_screen``."""


def read(record):
    host = record["host_s"]
    if "ddgi_update" not in host:
        return None
    return (host["ddgi_update"] + host.get("sample_probe_grid_screen", 0.0)) * 1e3 / record["frames"]
