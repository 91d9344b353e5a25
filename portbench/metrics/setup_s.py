"""Set-up seconds: from the process start (imports, the CUDA context,
the inputs from the seed, the program built and warmed up, its kernels
built on a first run) to the window."""


def read(ctx):
    return ctx["setup_s"]
