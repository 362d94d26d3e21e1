"""Seconds from the process's start to the end of the program's set-up,
the dispatch after the followed iterations: imports, the kernel library,
the env and terrain build, the runner, the capture and the first replay.
Left out: the host copies of the followed iterations, which are the
check's, and the replays that then wait for the card's steady mode
(program.py): no change to the program shortens them."""


def read(ctx):
    return ctx["setup_s"]
