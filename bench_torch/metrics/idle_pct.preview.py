"""idle_pct.preview: the share of the traced window in which no operation ran
on the device, in %: 1 - (the union of the device operations' intervals) /
(the window), from the torch.profiler trace of the traced previews."""


def read(ctx, out):
    tr = out.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
