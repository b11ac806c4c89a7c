"""Seconds from the process's start to the window's: imports, the card,
the kernel library, the library and index (built on a checkout's first
run), the inputs and the warm job."""


def read(rec):
    return rec["setup_s"]
