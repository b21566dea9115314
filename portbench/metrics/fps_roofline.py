"""The FPS kernel (``csrc/fps.cu``, ``fps_cluster_kernel``): the least time
one H100 needs for a batch's FPS at the cell's shapes (frozen
``fps_bound(B, H x W, cluster_num)``: the main path samples the
zero-masked grid), over the kernel's mean device time per launch in the
traced window, in %."""

from statistics import mean

from portbench import roofline


def read(r):
    t = r.record.trace
    times = [] if t is None else t.kernel_times_s("fps_cluster_kernel")
    if not times:
        return None
    lid, K = r.config["lidar"], int(r.config["codec"]["cluster_num"])
    hw = int(lid["height"]) * int(lid["width"])
    need = mean(roofline.fps_bound(len(b), hw, K)[0] for b in r.record.batches)
    return 100.0 * need / (1e3 * mean(times))
