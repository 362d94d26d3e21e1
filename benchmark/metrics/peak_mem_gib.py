"""The peak of torch.cuda.max_memory_allocated() over set-up and window,
the captured graph's pool included, in GiB."""


def read(ctx):
    peak = ctx["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
