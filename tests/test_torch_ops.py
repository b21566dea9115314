"""Stage-by-stage parity of the port's ops with ``rpcc_tpu``, each stage fed
the reference's own inputs (jax and torch both on the CPU).

Tolerances and why:
  * integer outputs (subsample, seg ids, stream order, residuals, contour
    bits, run values) are element-identical.  A seg id may differ only
    where its two competing distances lie within 4 ulps: XLA on the CPU
    contracts the (K, 3) x (3, HW) dot and ``x*x+y*y+z*z`` into FMAs, the
    port does not;
  * planes from the closed-form eigenvector: rtol 1e-5 (f32 sums in
    another order, and arccos/cos from another math library);
  * point means and cumsums: bit-equal (``fixed_order_cumsum`` sums in
    the order of XLA's CPU cumsum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.ops import contour as j_contour
from rpcc_tpu.ops import fps as j_fps
from rpcc_tpu.ops import ransac as j_ransac
from rpcc_tpu.ops import rounding as j_rounding
from rpcc_tpu.ops import segment as j_segment
from rpcc_tpu.ops import stream as j_stream
from rpcc_tpu.ops.projection import build_transform_planes, project_points_host_u16
from rpcc_tpu_torch.data import lidar_config
from rpcc_tpu_torch.data.synth import synth_cloud_for
from rpcc_tpu_torch.ops import contour, fps, prng, ransac, rounding, segment, stream
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

CFG = CodecConfig()


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _frame(name):
    if name == "small":
        lidar, pc, K = SMALL, synth_scene(seed=0), 16
    else:
        lidar = lidar_config("Velodyne64E")
        pc, K = synth_cloud_for(lidar, 0), CFG.cluster_num
    q, d = project_points_host_u16(pc, lidar, np.float32(CFG.step / 16.0))
    ri = q.astype(np.float32) * d
    tm = build_transform_planes(lidar)
    key = jax.random.split(jax.random.PRNGKey(np.uint32(0)))[0]
    seg, ground, centers = jax.jit(
        lambda p, r, t, k: j_segment.segment_range_image(p, r, t, k, CFG.ground_threshold, K)
    )(ri[None] * tm, ri, tm, key)
    return dict(
        lidar=lidar, ri=ri, tm=tm, K=K, M=K + 2, planes=ri[None] * tm,
        seg=np.asarray(seg), ground=np.asarray(ground), centers=np.asarray(centers),
    )


@pytest.fixture(scope="module", params=["small", "64e"])
def frame(request):
    return _frame(request.param)


def test_round_half_away_exact_halves():
    x = np.asarray([-3.5, -2.5, -1.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, 3.5, 0.49999997, -0.49999997,
                    8388607.5, -8388607.5, 1.25, -1.75], np.float32)
    got = rounding.round_half_away(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_rounding.round_half_away(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:4], [-4, -3, -2, -1])
    np.testing.assert_array_equal(got[6:10], [1, 2, 3, 4])
    assert torch.round(T(np.float32([2.5]))).item() == 2.0  # why the port keeps its own


def test_smallest_eigvec_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    cov[0] = np.eye(3, dtype=np.float32)  # isotropic: falls back to +z
    cov[1] = np.diag([5.0, 2.0, 0.1]).astype(np.float32)
    ref = np.asarray(jax.vmap(j_ransac.smallest_eigvec_3x3)(jnp.asarray(cov)))
    got = ransac.smallest_eigvec_3x3(T(cov)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[0], [0.0, 0.0, 1.0])


def test_fit_plane_weighted_matches_reference():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(8, 200, 3)).astype(np.float32) * [20.0, 20.0, 0.3]
    pts = pts.astype(np.float32)
    w = (rng.uniform(size=(8, 200)) > 0.3).astype(np.float32)
    ref = np.asarray(jax.vmap(j_ransac.fit_plane_weighted)(jnp.asarray(pts), jnp.asarray(w)))
    got = ransac.fit_plane_weighted(T(pts), T(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_ground_subsample_and_plane(frame):
    xs, ys, zs = (frame["planes"][i].reshape(-1) for i in range(3))
    valid = frame["ri"].reshape(-1) > 0
    for seed in (0, 7):
        jk = jax.random.PRNGKey(np.uint32(seed))
        tk = prng.prng_key(seed, "cpu")
        mask = (zs < -1.5) & valid
        j_sub, j_n = jax.jit(j_ransac.compact_random_subset_planar, static_argnums=5)(xs, ys, zs, mask, jk, 5000)
        t_sub, t_n = ransac.compact_random_subset_planar(T(xs), T(ys), T(zs), T(mask), tk, 5000)
        n = int(j_n)
        assert int(t_n) == n
        np.testing.assert_array_equal(t_sub.numpy()[:n], np.asarray(j_sub)[:n])
        ref = np.asarray(jax.jit(lambda *a: j_segment.fit_ground_plane_planar(*a[:4], valid=a[4]))(
            xs, ys, zs, jk, valid))
        got = segment.fit_ground_plane_planar(T(xs), T(ys), T(zs), tk, valid=T(valid)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_seg_ids_from_reference_plane_and_centers(frame):
    """The argmin stage on the reference's ground plane and FPS centres."""
    planes, ri, tm = T(frame["planes"]), T(frame["ri"]), T(frame["tm"])
    got = segment.assign_clusters(planes, ri, tm, T(frame["ground"]), T(frame["centers"])).numpy()
    ref = frame["seg"]
    flips = np.flatnonzero(got.reshape(-1) != ref.reshape(-1))
    if flips.size:
        xs, ys, zs = (planes[i].reshape(-1) for i in range(3))
        g_res = torch.abs(segment.ground_depth_residual(ri, T(frame["ground"]), tm).reshape(-1))
        dist = torch.cat([g_res[None], segment.center_distances(xs, ys, zs, T(frame["centers"]))]).numpy()
        row = lambda s: np.where(s > 1, s - 1, s)  # noqa: E731  seg id -> distance row
        a = dist[row(got.reshape(-1)[flips]), flips]
        b = dist[row(ref.reshape(-1)[flips]), flips]
        assert (np.abs(a - b) <= 4 * np.spacing(np.maximum(a, b))).all()
    assert flips.size <= 1e-4 * ri.numel()


def test_fps_on_reference_mask(frame):
    """FPS over the reference's zero-masked non-ground grid.  Identical up to
    the first step whose winner is a near-tie (XLA's FMA-contracted d2 can
    break an exact f32 tie the other way); at that step the reference's pick
    must be within 2 ulps of the port's maximum."""
    xs, ys, zs = (frame["planes"][i].reshape(-1) for i in range(3))
    vert = np.asarray(j_ransac.point_plane_distance_planar(xs, ys, zs, jnp.asarray(frame["ground"])))
    m = ((vert > CFG.ground_threshold) & (frame["ri"].reshape(-1) > 0)).astype(np.float32)
    ngx, ngy, ngz = xs * m, ys * m, zs * m
    K = frame["K"]
    ref = np.asarray(jax.jit(j_fps.furthest_point_sample_planar, static_argnums=3)(ngx, ngy, ngz, K))
    got = fps.furthest_point_sample(T(ngx), T(ngy), T(ngz), K).numpy()
    diff = np.flatnonzero(got != ref)
    if diff.size:
        i = diff[0]
        md = np.full(ngx.shape, 1e10, np.float32)
        for last in got[:i]:
            dx, dy, dz = ngx - ngx[last], ngy - ngy[last], ngz - ngz[last]
            md = np.minimum(md, dx * dx + dy * dy + dz * dz)
        assert got[i] == np.argmax(md)
        assert md.max() - md[ref[i]] <= 2 * np.spacing(md.max())


def test_stream_order_means_and_residuals(frame):
    seg, ri, M = frame["seg"], frame["ri"], frame["M"]
    j_order, (j_ri_s,) = jax.jit(lambda s, r: j_stream.stream_sort(s, [r], M))(seg.reshape(-1), ri.reshape(-1))
    order, (ri_s,) = stream.stream_sort(T(seg.reshape(-1)), [T(ri.reshape(-1))], M)
    np.testing.assert_array_equal(order.perm.numpy(), np.asarray(j_order.perm))
    np.testing.assert_array_equal(order.seg.numpy(), np.asarray(j_order.seg))
    np.testing.assert_array_equal(order.starts.numpy(), np.asarray(j_order.starts))
    np.testing.assert_array_equal(order.counts.numpy(), np.asarray(j_order.counts))
    assert int(order.stream_len) == int(j_order.stream_len)
    np.testing.assert_array_equal(ri_s.numpy(), np.asarray(j_ri_s))

    # point means: bit-equal (the cumsum follows XLA's summation order)
    j_means = np.asarray(jax.jit(j_stream.point_means_stream)(j_ri_s, j_order))
    means = stream.point_means_stream(ri_s, order).numpy()
    np.testing.assert_array_equal(means, j_means)

    # quantized residuals from the reference's model table: element-identical
    table = jnp.asarray(np.stack([np.zeros_like(j_means)] * 3 + [j_means], 1)).at[0].set(frame["ground"])
    j_rays = j_stream.rays_from_perm(j_order, frame["lidar"])
    j_pred = j_stream.predict_stream(table, j_order, j_rays, ri.size)
    j_q = np.asarray(j_rounding.round_half_away((j_ri_s - j_pred) / np.float32(CFG.step)).astype(jnp.int32))
    pred = stream.predict_stream(T(table), order, stream.rays_from_perm(order, frame["lidar"]))
    q = rounding.round_half_away((ri_s - pred) / torch.tensor(CFG.step, dtype=torch.float32))
    live = int(order.stream_len)
    np.testing.assert_array_equal(q.to(torch.int32).numpy()[:live], j_q[:live])


@pytest.mark.parametrize("shape", [(1,), (16,), (17,), (257,), (4097,), (128000,), (3, 260), (10, 5000)])
def test_fixed_order_cumsum_matches_jnp_cumsum(shape):
    """Bit-equal to ``jnp.cumsum`` along the last axis on the CPU: XLA scans
    16-element blocks left to right and adds the scanned block totals."""
    x = np.random.default_rng(len(shape) * 7 + shape[-1]).normal(20.0, 15.0, shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    np.testing.assert_array_equal(stream.fixed_order_cumsum(T(x)).numpy(), ref)


@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 2048, 128000])
def test_fixed_order_cumsum(n):
    x = torch.from_numpy(np.random.default_rng(n).normal(10.0, 5.0, n).astype(np.float32))
    got = stream.fixed_order_cumsum(x)
    assert got.shape == (n,) and got.dtype == torch.float32
    exact = np.cumsum(x.numpy().astype(np.float64))
    assert (np.abs(got.numpy() - exact) <= 4 * np.spacing(np.abs(exact).astype(np.float32))).all()


def test_contour_code_and_recovery(frame):
    seg = frame["seg"]
    j_code = jax.jit(j_contour.extract_contour)(seg)
    code = contour.extract_contour(T(seg))
    n = int(j_code.seq_len)
    assert int(code.seq_len) == n
    np.testing.assert_array_equal(code.contour.numpy(), np.asarray(j_code.contour))
    np.testing.assert_array_equal(code.sequence.numpy(), np.asarray(j_code.sequence))
    packed = contour.pack_bits_msb(code.contour)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_contour.pack_bits_msb(j_code.contour)))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(np.asarray(j_code.contour).reshape(-1)))
    bits = contour.unpack_bits_msb(packed, seg.size).reshape(seg.shape)
    np.testing.assert_array_equal(contour.recover_map(bits, code.sequence[:n]).numpy(), seg)
