"""request_p95_ms: the 95th percentile, in ms, of the latency of every
request of the window, each timed on the host clock from the hand-over of
its host frames to its answers synchronised on the card."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.latencies), 95))
