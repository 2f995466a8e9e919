"""Kernel D (`warp_fwd_kernel`, `warp_bwd_kernel`): the border-mode
bilinear warp of the neighbouring frames into frame 0 in the training
loss, and its coordinate gradient.

Forward: coordinates and image read, output written, about 30 f32
operations a pixel; backward: also the output gradient read and the
coordinate gradient written, about 45 a pixel."""

TRACE_NAMES = ("warp_fwd_kernel", "warp_bwd_kernel")
COUNTERS = {"warp_fwd": 1, "warp_bwd": 1}


def work(n, H, W, phase):
    pix = n * H * W
    if phase == "forward":
        return 30 * pix, 4 * pix * (2 + 3 + 3)
    return 45 * pix, 4 * pix * (2 + 3 + 3 + 2)


def launches(calls, p):
    """The program stacks a loss branch's frames into one forward launch,
    and one backward where the coordinates need their gradient."""
    branches = {}
    for c in calls:
        if c["site"] == "warp":
            branches.setdefault(c["branch"], []).append(c)
    out = []
    for frames in branches.values():
        n = sum(c["img"][0] for c in frames)
        H, W = frames[0]["img"][1:3]
        out.append(("f32", (n, H, W, "forward")))
        if any(c["grad"] for c in frames):
            out.append(("f32", (n, H, W, "backward")))
    return out
