"""setup_s: process start to the first timed operation (generation, the
node, the kernels' load or build, the warm-up), host clock."""


def read(run):
    return run.setup_s
