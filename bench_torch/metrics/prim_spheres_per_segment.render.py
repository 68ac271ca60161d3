"""prim_spheres_per_segment.render: the sphere and bounding-sphere rows K4's
scans tested a segment: over the traced renders, the sizes of the
``render.prim.spheres`` records in the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``; per render
``RenderStats.extra["prim_spheres"]``, K4's ``work[3]``) over the sizes of
their ``render.prim`` records (the segments K4 traced). A flat scan tests
every row of the sphere table a segment; a sphere cull lowers it. A
program without the records, or renders of another route, report
nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if out.trace is None or not hasattr(profiling, "spans"):
        return None
    size = {}
    for s in profiling.spans():
        if s.name in ("render.prim", "render.prim.spheres"):
            size[s.name] = size.get(s.name, 0) + (s.size or 0)
    segments, rows = size.get("render.prim", 0), size.get("render.prim.spheres")
    if segments <= 0 or rows is None:
        return None
    print(f"prim_spheres_per_segment.render: {rows} sphere rows over {segments} "
          "segments", flush=True)
    return rows / segments
