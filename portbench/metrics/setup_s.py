"""Set-up: process start to the first timed unit (imports, the program's
build or load, the inputs, the warm-up)."""
UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
