"""The DBSCAN kernels (``csrc/dbscan.cu``: ``dbscan_mask_kernel`` then
``dbscan_cluster_kernel``, one call): the least time one H100 needs for a
batch's labels (frozen ``dbscan_bound``), over the two launches' device
time per call in the traced window, in %.  The active pixels are counted
as every returned point of the input: the ground the program leaves out
is not worked out again here, so the bound counts at most the work
needed."""

from statistics import mean

from portbench import roofline


def read(r):
    t = r.record.trace
    if t is None:
        return None
    calls = t.kernel_times_s("dbscan_cluster_kernel")
    if not calls:
        return None
    per_call = (sum(calls) + sum(t.kernel_times_s("dbscan_mask_kernel"))) / len(calls)
    H, W = int(r.config["lidar"]["height"]), int(r.config["lidar"]["width"])
    need = mean(roofline.dbscan_bound(sum(r.valid_points[k] for k in b), len(b), H, W)[0]
                for b in r.record.batches)
    return 100.0 * need / (1e3 * per_call)
