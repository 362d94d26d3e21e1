"""Host seconds from the runner's construction to the end of the
program's set-up (setup_s): the nets, the reset, the capture of the
training iteration and the first replay (algo/capture.py, algo/ppo.py)."""


def read(ctx):
    return ctx["setup_capture_s"]
