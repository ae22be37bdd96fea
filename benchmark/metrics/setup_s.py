"""Set-up: from the start of the process until the window opens (imports,
the inputs made on the device, the warm-up calls, and in a first run the
build of the program's kernels)."""


def read(rec):
    return rec.setup_s
