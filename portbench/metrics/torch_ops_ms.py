"""torch_ops_ms: device milliseconds a request of every kernel that is
neither a scan kernel (``scan_roofline.is_scan``) nor a copy or memset:
today the binning op and the analytics' torch ops."""

from portbench.metrics.scan_roofline import is_scan


def read(run):
    tl = run.timeline
    if tl is None or tl.requests <= 0:
        return None
    s = tl.seconds(lambda op: op.kind == "kernel" and not is_scan(op))
    return 1e3 * s / tl.requests if s > 0 else None
