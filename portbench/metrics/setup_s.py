"""setup_s: from the start of run.py to the first timed step: imports, the
CUDA context, the kernels' library (built first where the checkout has none),
tables and queries from the seed, the entry's objects and its warm-up."""


def read(run):
    return run.setup_s
