"""One module a kind of query: ``<kind>.py``, found by the ``kind`` that a
traffic file gives each of its queries.  A module states:

* ``NUMBERS``: the compared numbers its answers give (``check.py``);
* ``resolve(q, h, w, gen)``: the traffic's parameters made into a spec
  (a dict with ``"kind"``), seeded by the numpy generator ``gen``;
* ``program(spec, target)``: the port's query object for the spec;
* ``rows(spec, h)``: the H rows the query reads (``roofline.py``);
* ``reference(ids, num_bins, spec, target, h_dtype=None)``: the plain
  reference's answer for the frames' bin ids (n, h, w);
* ``answer(result, one_frame)``: the port's answer in the reference's
  shape, a leading frame axis always;
* ``compare(got, want, spec)``: {number: gap} of one answer.

A new kind of query is a new module here; a new mix of kinds is a new
traffic file.
"""
