"""How ``correct`` is decided: the port's outputs against the plain
reference, number by number, each against its limit.

The numbers compared (each the largest over everything it covers):

* ``count_gap``: |port - reference| over the H of the sampled requests
  at a seeded sample of rows.  Counts are exact, so its limit is 0.
* ``map_gap``: |port - reference| over the likelihood maps of the
  sampled requests.

Each kind of query (``kinds/<kind>.py``) gives its answers' numbers; the
limits live in the traffic file (``limits``).  The control
(``control.py``) is ``reference_answers`` with ``h_dtype=torch.bfloat16``:
the reference with its integral histogram held in bfloat16, put in the
port's place; it has to come out as not correct.
"""

from __future__ import annotations

import importlib
import math

import torch


def gap(got, want) -> float:
    """max |got - want| as a float; inf where shapes differ or a value
    is not finite."""
    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    if got.numel() == 0:
        return 0.0
    d = (got.to(want.device, torch.float64) - want.to(torch.float64)).abs()
    m = float(d.max())
    return m if math.isfinite(m) else math.inf


def kind(name: str):
    """The module ``kinds/<name>.py`` of a kind of query."""
    if not name.isidentifier():
        raise ValueError(f"no kind of query {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}")


def program_answers(results, specs: list, frames_per_request: int) -> list:
    """The port's results in the reference's shapes (a leading frame
    axis always)."""
    if results is None:
        return [None] * len(specs)
    one = frames_per_request == 1
    return [kind(s["kind"]).answer(r, one) for s, r in zip(specs, results)]


def reference_answers(ids, num_bins: int, specs: list, target,
                      h_dtype=None) -> list:
    """Every query's answer for the frames' bin ids (n, h, w): exact with
    ``h_dtype`` None, else the control's, read from an H rounded to it."""
    return [kind(s["kind"]).reference(ids, num_bins, s, target, h_dtype)
            for s in specs]


def compare(got: list, want: list, specs: list) -> dict:
    """The gaps of one request's answers: {number: value}."""
    gaps = dict.fromkeys(numbers_for(specs), 0.0)
    for spec, g, w in zip(specs, got, want):
        for name, value in kind(spec["kind"]).compare(g, w, spec).items():
            gaps[name] = max(gaps[name], value)
    return gaps


def numbers_for(specs: list) -> tuple:
    """The numbers a cell's queries give: ``count_gap`` of the H rows
    always, then each kind's in order."""
    out = ["count_gap"]
    for s in specs:
        out += [n for n in kind(s["kind"]).NUMBERS if n not in out]
    return tuple(out)


def judge(gaps: dict, limits: dict, specs: list) -> tuple[bool, dict]:
    """(every number within its limit, {number: {"value", "limit"}})."""
    checks = {}
    ok = True
    for name in numbers_for(specs):
        value = gaps.get(name, math.inf)
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
