"""setup_s: seconds from the process's start to the window's first request:
imports, CUDA's start, the kernels' libraries loaded (or built, in a
checkout's first run), weights and frames made, the server opened, every
bucket's executor warmed and the traffic run for its warm-up."""


def read(run):
    return run.setup_s
