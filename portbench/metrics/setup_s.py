"""setup_s: process start to the first measured step: imports, CUDA,
the kernels and native plane loaded (built on a first run), the cluster
built from the seed and the warm-up steps."""


def read(rec):
    return rec.setup_s
