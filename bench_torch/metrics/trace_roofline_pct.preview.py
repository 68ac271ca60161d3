"""trace_roofline_pct.preview: the least time the traced preview work can take on
the card, over the device time of the program's own kernels in the trace
(the preview's trace kernel: K5 (route stepped) on cornell, K6 (route
stepped_prim) on mesh), in %.

The work is the route's, whatever kernels do it: the configuration's
essential operations a traced segment (``ops.preview.segment_flops``) times
the segments (what ``integrator.render_pass`` returned for the traced frames), plus its operations a camera ray
(``sample_flops``) times the samples. The bytes: each launch of the
program's kernels reads its inputs and writes its outputs once,
``ops.preview.lane_bytes`` a lane, with the traffic's lanes a launch. The
least time is the larger of operations over the float32 peak and bytes over
the HBM rate (``peaks.py``); which one bounds is printed. Nothing is
clamped: a share over 100% means the count is wrong."""

import peaks


def read(ctx, out):
    tr, work = out.trace, out.traced
    if tr is None or tr.port_s <= 0 or not work.get("segments"):
        return None
    ops = ctx.config["ops"]["preview"]
    flops = work["segments"] * ops["segment_flops"] + work["samples"] * ops["sample_flops"]
    nbytes = tr.port_launches * work["lanes"] * ops["lane_bytes"]
    least, by = peaks.least_seconds(flops, nbytes)
    print(f"trace_roofline_pct.preview: {flops:.6g} flop, {nbytes:.6g} bytes over "
          f"{tr.port_launches} launches: least {least * 1e3:.6g} ms ({by}) against "
          f"{tr.port_s * 1e3:.6g} ms of the program's kernels", flush=True)
    return 100.0 * least / tr.port_s
