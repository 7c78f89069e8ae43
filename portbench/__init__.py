"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root is the manifest.  Everything a
cell is made of lives in a file of its own that the harness finds by the
name the manifest or a file gives: ``configs/<config>.json`` (the
deployment's sizes, guarantees and the port's ``engine`` options),
``traffic/<traffic>.json`` (parameters that ``generate.py``, the one
generator, reads), ``kinds/<kind>.py`` (a kind of query),
``clients/<client>.py`` (how a request is made), ``loops/<loop>.py`` (how
load is offered), ``metrics/<metric>.py`` (one reader a metric).
``reference/`` is the plain restatement the outputs are held against; it
imports nothing of the port.
"""
