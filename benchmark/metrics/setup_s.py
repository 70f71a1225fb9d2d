"""Set-up seconds: process start to the first timed step (imports, CUDA context,
the kernels' libraries, Moldata, circuit and grid maps, OO_pqc's core,
the warm-up solve)."""


def read(run):
    return run.setup_s
