"""The control at a size a test run holds: the reference with its integral
histogram in bfloat16, put in the port's place, fails a limit of every
cell, while the port's own runs keep to all of them."""

import pytest

from portbench import check, control, smallcells


@pytest.mark.parametrize("cell", list(smallcells.SMALL))
def test_the_control_fails_and_the_port_passes(cell):
    c = smallcells.small_cell(cell)
    out = control.readings(c, [2 ** 31 + 1, 2 ** 32 + 9], [17, 2 ** 31 + 3],
                           0.2, "cpu")
    limits = c.traffic["limits"]
    assert all(p["correct"] for p in out["program"])
    for reading in out["control"]:
        assert any(reading[name] > limits[name]
                   for name in check.numbers_for(control_specs(c))), reading


def control_specs(cell):
    from portbench import generate

    return generate.make_queries(cell.config, cell.traffic, 0)
