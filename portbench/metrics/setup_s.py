"""Process start to the start of the window: imports, CUDA context, the
kernel library, mesh, constraint, operator, preconditioner, one warm
request."""


def read(rec):
    return rec["setup_s"]
