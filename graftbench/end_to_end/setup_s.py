"""Process start to window open: data, kernels, the warm phase."""


def read(run):
    return run.setup_s
