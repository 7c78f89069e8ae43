"""One module a way of making requests: ``<client>.py``, found by the
``client`` a traffic file names.  ``make(engine_options, queries,
device)`` returns the request, a callable of one request's host frames
that returns what the port hands back (``result.source`` its H or rows,
``result.results`` one answer a query, ``result.plan`` its plan).
``engine_options`` is the configuration's ``engine`` object, passed on
unchanged."""
