"""Seconds of the dense stage's point cloud and mesh (the result's
`timings_s["point_cloud"] + ["mesh"]`), mean over the window's runs."""


def read(ctx):
    runs = ctx.get("runs")
    if not runs:
        return None
    return sum(r["timings_s"]["point_cloud"] + r["timings_s"]["mesh"]
               for r in runs) / len(runs)
