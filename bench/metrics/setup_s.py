"""Set-up: process start to the first timed call (imports, the kernels'
libraries loaded or built, weights made, warm-up), host clock."""


def read(run):
    return run.setup_s
