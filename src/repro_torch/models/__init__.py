"""The model zoo's ported families (ROADMAP 1.9): the ssm family
(Mamba-2) for serving and training, and the transformer's dense, moe and
vlm families for serving.  ``api`` is the uniform entry point."""
