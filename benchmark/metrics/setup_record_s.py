"""Host seconds of the first capture's recording of the iteration as a CUDA
graph (the capture span capture.record), a part of setup_capture_s."""

from benchmark import stages


def read(ctx):
    spans = stages.first_capture(ctx)
    return None if spans is None else spans["capture.record"]
