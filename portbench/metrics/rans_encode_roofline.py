"""The rANS encode kernel (``csrc/rans.cu``, ``rans_encode_kernel``, one
launch per engine batch for its residual and contour fields): the least
time one H100 needs for a batch (frozen ``rans_bound`` over each frame's
returned points), over the kernel's mean device time per launch in the
traced window, in %."""

from statistics import mean

from portbench import roofline


def read(r):
    t = r.record.trace
    times = [] if t is None or r.record.loop != "closed" else t.kernel_times_s("rans_encode_kernel")
    if not times:
        return None
    H, W = int(r.config["lidar"]["height"]), int(r.config["lidar"]["width"])
    need = mean(roofline.rans_bound([r.valid_points[k] for k in b], H, W)[0] for b in r.record.batches)
    return 100.0 * need / (1e3 * mean(times))
