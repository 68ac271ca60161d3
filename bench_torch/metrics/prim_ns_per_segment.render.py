"""prim_ns_per_segment.render: K4's device time a segment, in ns: the device
time of ``trace_regen_prim_kernel`` (K4, ``csrc/trace_regen_prim.cu``) in
the traced window over the segments K4 traced in the traced renders, the
sizes of their ``render.prim`` records in the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``; per render
``RenderStats.extra["prim_segments"]``). A record's tag says where K4 read
its rows: ``shared`` (the tables staged in a block's shared memory) or
``global`` (read from device memory); it is printed beside the reading. A
program without the records, or renders of another route, report
nothing."""

KERNEL = "trace_regen_prim_kernel"


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    tr = out.trace
    if tr is None or not hasattr(profiling, "spans"):
        return None
    notes = [s for s in profiling.spans() if s.name == "render.prim" and s.size]
    seconds = sum(t for name, t in tr.device_ops if name == KERNEL)
    if not notes or seconds <= 0:
        return None
    segments = sum(s.size for s in notes)
    tables = sorted({str(s.tag) for s in notes})
    print(f"prim_ns_per_segment.render: {KERNEL} {seconds * 1e3:.6g} ms over "
          f"{segments} segments of {len(notes)} renders; prim_table "
          f"{'/'.join(tables)}", flush=True)
    return 1e9 * seconds / segments
