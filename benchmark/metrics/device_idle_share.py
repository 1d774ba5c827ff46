"""device_idle_share: the share of the traced window in which nothing ran
on the card: 1 - the union of device activity intervals (kernels, copies,
fills, from torch.profiler's CUDA activity) over the window's length."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
