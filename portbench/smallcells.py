"""The benchmark's cells cut to a size a CPU test can hold.

Each keeps its kinds of query and the plan they lead to (a stored H),
and counts above 256 in its bottom rows, so bfloat16 cannot hold them
exactly.  For the tests of ``portbench`` only; a run of the benchmark
never reads this.
"""

from __future__ import annotations

from portbench import harness

# cell: (configuration keys, traffic keys)
SMALL = {
    "aerial8k128-dense": ({"height": 96, "width": 128, "num_bins": 8}, {}),
    "vga32-likemap": (
        {"height": 48, "width": 64, "num_bins": 8},
        {"frames_per_request": 4, "target": {"window": [8, 8]},
         "queries": [{"kind": "likelihood", "window": [8, 8],
                      "stride": 1}]}),
}
STACKS = [k for k, (_, t) in SMALL.items()
          if t.get("frames_per_request", 1) > 1]


def small_cell(workload: str) -> harness.Cell:
    """The cell ``workload`` of BENCHMARK.json with its configuration and
    traffic cut to the small size."""
    config, traffic = SMALL[workload]
    cell = harness.load_cell(harness.load_manifest(), workload)
    config = dict(config)
    engine = dict(cell.config["engine"], num_bins=config.pop("num_bins"))
    cell.config.update(config, engine=engine)
    cell.traffic.update(traffic)
    return cell
