"""scan_roofline's bytes and operations at the cells' shapes, against
arithmetic done by hand, and the per-layer readers on a made-up trace."""

import numpy as np
import pytest

from portbench import generate, harness, roofline, timeline
from portbench.kinds import likelihood

MANIFEST = harness.load_manifest()
MB = 8192 * 8192                    # pixels of the aerial frame
VGA = 480 * 640


def _work(cell, seed=5):
    """(specs, rows, work) of a cell."""
    c = harness.load_cell(MANIFEST, cell)
    cfg, traffic = c.config, c.traffic
    n = traffic["frames_per_request"]
    specs = generate.make_queries(cfg, traffic, seed)
    rows = roofline.needed_rows(specs, cfg["height"])
    return specs, rows, roofline.request_work(
        n, cfg["height"], cfg["width"], generate.num_bins(cfg), rows.size)


def test_whole_h_reads_every_row():
    specs, rows, work = _work("aerial8k128-dense")
    assert specs == [] and rows.tolist() == list(range(8192))
    assert work == {"bytes": MB + 4 * 128 * MB, "ops": MB + 128 * MB}
    assert work["bytes"] == 34_426_847_232
    least = roofline.least_seconds(work, "NVIDIA H100 80GB HBM3")
    assert least == pytest.approx(34_426_847_232 / 3.35e12)


def test_peaks_of_another_card_are_refused():
    _, _, work = _work("aerial8k128-dense")
    for kind in (None, "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError):
            roofline.least_seconds(work, kind)


def test_likemap_reads_every_row():
    _, rows, work = _work("vga32-likemap")
    assert rows.tolist() == list(range(480))
    assert work == {"bytes": 9_830_400 + 1_258_291_200,
                    "ops": 9_830_400 + 314_572_800}


def _events():
    """A made-up traced stretch of 2 requests on one thread: 10 ms."""
    ms = 1_000_000
    return [
        ("portbench.trace", "CPU", "user_annotation", 0, 10 * ms, 1),
        ("portbench.request", "CPU", "user_annotation", 0, 5 * ms, 1),
        ("portbench.request", "CPU", "user_annotation", 5 * ms, 10 * ms, 1),
        ("aten::to", "CPU", "cpu_op", 0, 1 * ms, 1),
        ("aten::unique", "CPU", "cpu_op", 3 * ms, 4 * ms, 1),
        ("Memcpy HtoD (Pinned -> Device)", "CUDA", "gpu_memcpy",
         0, 1 * ms, 7),
        ("void wf_tis_scan::scan_kernel<1, 2, false>(int const*)", "CUDA",
         "kernel", 1 * ms, 3 * ms, 7),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", "CUDA",
         "kernel", 4 * ms, 5 * ms, 7),
        ("Memcpy HtoD (Pinned -> Device)", "CUDA", "gpu_memcpy",
         5 * ms, 6 * ms, 7),
        ("void wf_tis_scan::count_kernel<8>(int const*)", "CUDA",
         "kernel", 6 * ms, 8 * ms, 7),
        ("portbench.request", "CUDA", "gpu_user_annotation", 0, 10 * ms, 7),
    ]


def test_timeline_and_readers_on_a_made_up_trace():
    tl = timeline.summarize(_events())
    assert tl.requests == 2 and tl.window_s == pytest.approx(0.010)
    assert tl.busy_s == pytest.approx(0.007)
    assert tl.idle_gaps[0] == ["portbench.request", pytest.approx(0.002)]
    assert dict(map(tuple, tl.idle_gaps))["aten::unique"] == \
        pytest.approx(0.001)
    ops = dict(map(tuple, tl.device_ops()))
    assert ops["wf_tis_scan::scan_kernel<1, 2, false>"] == \
        pytest.approx(0.002)
    run = harness.Run(cell={"frames": 1, "height": 8192, "width": 8192,
                            "num_bins": 128, "rows": 16,
                            "kind": "NVIDIA H100 80GB HBM3"},
                      setup_s=1.0, window_s=1.0, frames=2,
                      latencies=[0.005, 0.005], timeline=tl)
    read = {name: harness.load_reader(name)(run) for name in
            ("device_idle_pct", "h2d_ms", "torch_ops_ms", "scan_roofline",
             "frames_per_s", "request_p95_ms", "setup_s")}
    assert read["device_idle_pct"] == pytest.approx(30.0)
    assert read["h2d_ms"] == pytest.approx(1.0)
    assert read["torch_ops_ms"] == pytest.approx(0.5)
    least = (MB + 4 * 128 * 16 * 8192) / 3.35e12
    assert read["scan_roofline"] == pytest.approx(100 * least * 2 / 0.004)
    assert read["frames_per_s"] == 2.0 and read["setup_s"] == 1.0
    assert read["request_p95_ms"] == pytest.approx(5.0)


def test_readers_find_nothing_without_a_trace():
    run = harness.Run(cell={}, setup_s=1.0, window_s=1.0, frames=1,
                      latencies=[0.1])
    for name in ("device_idle_pct", "h2d_ms", "torch_ops_ms",
                 "scan_roofline"):
        assert harness.load_reader(name)(run) is None
    assert timeline.summarize([("x", "CPU", "cpu_op", 0, 1, 1)]) is None


def test_window_rows_match_the_lattices():
    assert likelihood.window_rows(480, (64, 64), 16).tolist() == \
        list(np.arange(27) * 16 + 63) + list(np.arange(27) * 16 - 1)
