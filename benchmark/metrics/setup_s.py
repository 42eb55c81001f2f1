"""Set-up time: import, library load (and, in a checkout's first run,
the build), frames made on the card, warm-up; host clock."""


def read(run):
    return run.setup_s
