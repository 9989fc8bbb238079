"""setup_s: process start to the first event of the measured window
(imports, CUDA context, kernel build or load, graph start, warm
stream), by the host's clock."""


def read(run):
    return run.setup_s
