"""throughput (Mdisp/s): H * W * (d_max + 1) summed over every frame
completed in the window, over the window's seconds (host clock, from the
first frame's entry call to the last frame's map on the host)."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    work = sum(f.size[0] * f.size[1] * (f.d_max + 1) for f in run.frames)
    return work / run.window_s / 1e6
