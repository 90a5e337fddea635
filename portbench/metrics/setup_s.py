"""Seconds from the process's start to the window's: imports, the kernel
library's load, the context's tables, keys, pools and warm-up.  A cold
checkout's nvcc build is not in it (the run prints it as build_s)."""


def read(rec):
    return rec.setup_s
