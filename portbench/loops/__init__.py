"""One module a way of offering load: ``<loop>.py``, found by the
``loop`` a traffic file names.  ``serve(request, views, sync, ...)``
makes the requests and times each on the host clock (see
``closed.py``)."""
