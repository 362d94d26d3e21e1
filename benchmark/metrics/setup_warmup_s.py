"""Host seconds of the first capture's warm-up (the capture span
capture.warm_up: one eager iteration on a side stream, then the state put
back), a part of setup_capture_s."""

from benchmark import stages


def read(ctx):
    spans = stages.first_capture(ctx)
    return None if spans is None else spans["capture.warm_up"]
