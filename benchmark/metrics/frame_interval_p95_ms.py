"""The 95th percentile of the intervals between consecutive frames'
completion events over the timed window of a traced run, which runs as
an untraced one before its traced frames: ``frame_ms_p95`` where that
spreads too widely from run to run to hold a bound (a host-bound cell)."""
from hrbench import stats


def read(record):
    iv = record.get("frame_intervals_ms") or []
    return stats.percentile(iv, 95) if len(iv) > 1 else None
