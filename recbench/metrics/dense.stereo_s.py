"""Seconds of the dense stage's stereo (the result's `timings_s["stereo"]`,
pairwise SGM and fusion), mean over the window's runs."""


def read(ctx):
    runs = ctx.get("runs")
    if not runs:
        return None
    return sum(r["timings_s"]["stereo"] for r in runs) / len(runs)
