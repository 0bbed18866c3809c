"""setup_s: seconds from the process's start to the first timed call:
imports, the mechanism text and the program's parse and packing, the
module, loading (the first time building) the kernels, staging the
states and the warm-up calls.  Host clock."""


def read(run):
    return run.setup_s
