"""resolve_ns_per_segment.render: K3's device time a resolve segment, in ns:
the device time of ``resolve_pool_kernel`` (K3, ``csrc/portal_resolve.cu``)
in the traced window over the segments K3 resolved in the traced renders,
the sizes of their ``render.resolve`` records in the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``; per render
``RenderStats.extra["resolve_segments"]``). A record's tag says where K3
read its rows: ``shared`` (the compact table staged in a block's shared
memory) or ``global`` (read from device memory); it is printed beside the
reading. It shows the two regimes side by side: mesh's table fits, mesh13k's
does not. A program without the records, or renders of another route,
report nothing."""

KERNEL = "resolve_pool_kernel"


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    tr = out.trace
    if tr is None or not hasattr(profiling, "spans"):
        return None
    notes = [s for s in profiling.spans() if s.name == "render.resolve" and s.size]
    seconds = sum(t for name, t in tr.device_ops if name == KERNEL)
    if not notes or seconds <= 0:
        return None
    segments = sum(s.size for s in notes)
    tables = sorted({str(s.tag) for s in notes})
    print(f"resolve_ns_per_segment.render: {KERNEL} {seconds * 1e3:.6g} ms over "
          f"{segments} resolve segments of {len(notes)} renders; "
          f"resolve_table {'/'.join(tables)}", flush=True)
    return 1e9 * seconds / segments
