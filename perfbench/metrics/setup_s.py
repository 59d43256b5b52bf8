"""Set-up: from the process's start to the window's (imports, kernel
builds or loads, weights, warm-up)."""


def read(rec):
    return rec["setup_s"]
