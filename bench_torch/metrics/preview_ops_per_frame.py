"""preview_ops_per_frame: device operations (kernels, copies, fills) a
preview frame in the torch.profiler trace: their count in the traced
window over the frames it holds."""


def read(ctx, out):
    tr, frames = out.trace, out.traced.get("frames")
    return tr.ops / frames if tr is not None and frames else None
