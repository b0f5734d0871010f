"""``setup_s``: seconds from the process's start to the window's first
request: imports, the card's start, data, build, warm-up."""


def read(run):
    return run.setup_s
