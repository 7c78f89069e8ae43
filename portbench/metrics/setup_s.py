"""setup_s: seconds from the start of the process to the first timed
request: imports, the CUDA context, the kernels' libraries (built in the
checkout on its first run), the frame pool and the warm-up requests."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
