"""scan_roofline: the least time of a request's integral-histogram work
(``roofline.py``: its pixels read once, the H rows its queries read
written once, over the card's peaks) over the device time a request of
the kernels that compute H or its rows.

Those kernels are the ones the cells' dense ``wf_tis`` plans launch, found
by name: K1 (``wf_tis_scan::scan_kernel`` and its pre-passes
``count_kernel`` and ``row_count_kernel``).  PyTorch's own kernels
(``at::``) never count, whatever their name.  A cell whose plan launches
another scan kernel (K2 fused, K3, K4) brings a roofline metric of its
own.
"""

import re

from portbench import roofline

SCAN_KERNELS = re.compile(
    r"(^|[\s:])(scan_kernel|count_kernel|row_count_kernel)\b")


def is_scan(op) -> bool:
    return (op.kind == "kernel" and "at::" not in op.name
            and SCAN_KERNELS.search(op.name) is not None)


def read(run):
    tl = run.timeline
    if tl is None or tl.requests <= 0:
        return None
    spent = tl.seconds(is_scan)
    if spent <= 0:
        return None
    c = run.cell
    work = roofline.request_work(c["frames"], c["height"], c["width"],
                                 c["num_bins"], c["rows"])
    least = roofline.least_seconds(work, c.get("kind"))
    return 100.0 * least * tl.requests / spent
