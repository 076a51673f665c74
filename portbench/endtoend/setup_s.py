"""Set-up: from the process's start to the first measured request (the
program's import, the CUDA context, the kernels' load or build, weights,
calibration, warm-up of the cell's own buckets)."""


def read(run):
    return run.setup_s
