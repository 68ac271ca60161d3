"""prim_groups_per_query.render: the runs of 32 tiles whose tiles K4
slab-tested a warp query: over the traced renders, the sizes of the
``render.prim.groups`` records in the program's span log
(``path_tracer_tpu_torch.utils.profiling.spans``; per render
``RenderStats.extra["prim_groups"]``: past one run, the runs whose box
each warp query's line entered closer than its best hit so far) over the
sizes of their ``render.prim.query`` records (``prim_queries``: the
segments whose line enters a tile, which K4 traces with a whole warp). A
flat scan over all tiles would read the number of runs. A program without
the records, or renders of another route, report nothing."""


def read(ctx, out):
    from path_tracer_tpu_torch.utils import profiling

    if out.trace is None or not hasattr(profiling, "spans"):
        return None
    size = {}
    for s in profiling.spans():
        if s.name in ("render.prim.query", "render.prim.groups"):
            size[s.name] = size.get(s.name, 0) + (s.size or 0)
    queries, groups = size.get("render.prim.query", 0), size.get("render.prim.groups")
    if queries <= 0 or groups is None:
        return None
    print(f"prim_groups_per_query.render: {groups} runs of tiles over {queries} "
          "warp queries", flush=True)
    return groups / queries
