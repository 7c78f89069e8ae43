"""The model zoo's ported families (ROADMAP 1.9): the ssm family
(Mamba-2), the transformer's dense, moe and vlm families, Griffin and the
encoder-decoder, served and trained, on one device or over a mesh
(``sharding/rules.py``).  ``api`` is the uniform entry point."""
