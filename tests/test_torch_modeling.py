"""Plane models: the port's ``plane_models_stream`` against
``rpcc_tpu/ops/modeling.py::plane_models_stream`` on the same inputs (CPU):
the reference's stream order, range stream and scan rays, and the same key.
The reference runs eagerly, op by op, so XLA fuses nothing into FMAs.

  * the hypothesis draws are bit-equal (threefry port);
  * the winning hypothesis index is equal in every cluster whose ten
    candidate planes agree between the packages.  A candidate fitted to a
    degenerate sample (clusters of 2-5 pixels drawn with replacement give
    2 distinct points, rank 1) has no defined normal, and the two packages'
    closed-form eigenvectors then pick different, equally valid ones;
  * the plane-or-point decision of every cluster is the same;
  * the final model tables agree within 1e-5 (normals) and 1e-4 m (d):
    arccos/cos of another math library in the eigenvector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.ops import modeling as j_modeling
from rpcc_tpu.ops import segment as j_segment
from rpcc_tpu.ops import stream as j_stream
from rpcc_tpu.ops.projection import build_transform_planes, project_points_host_u16
from rpcc_tpu.ops.ransac import fit_plane_weighted as j_fit_plane
from rpcc_tpu_torch.ops import modeling, prng, stream
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

CFG = CodecConfig(modeling_method="plane", cluster_num=16)
M = CFG.cluster_num + 2
N_DRAW = modeling.CLUSTER_RANSAC_ITERS * modeling.CLUSTER_RANSAC_N


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _reference_hypotheses(xs, ys, zs, order, key):
    """Every candidate plane of the reference's ``_select_hypotheses`` (its
    own draw and fit), (M, ITERS, 4)."""
    u = jax.random.uniform(key, (M, N_DRAW))
    cnt = jnp.maximum(order.counts, 1)[:, None]
    sidx = order.starts[:, None] + jnp.minimum((u * cnt).astype(jnp.int32), cnt - 1)
    pts = jnp.stack([xs[sidx], ys[sidx], zs[sidx]], -1).reshape(
        M, modeling.CLUSTER_RANSAC_ITERS, modeling.CLUSTER_RANSAC_N, 3)
    ones = jnp.ones((modeling.CLUSTER_RANSAC_N,), jnp.float32)
    return np.asarray(jax.vmap(jax.vmap(lambda p: j_fit_plane(p, ones)))(pts))


@pytest.fixture(scope="module", params=[0, 3, 7])
def fit(request):
    seed = request.param
    q, d = project_points_host_u16(synth_scene(seed=seed), SMALL, np.float32(CFG.step / 16.0))
    ri = q.astype(np.float32) * d
    tm = build_transform_planes(SMALL)
    k_seg, k_model = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))
    seg, _, _ = jax.jit(
        lambda p, r, t, k: j_segment.segment_range_image(p, r, t, k, CFG.ground_threshold, CFG.cluster_num)
    )(ri[None] * tm, ri, tm, k_seg)
    seg = np.asarray(seg).reshape(-1)
    j_order, (j_ri_s,) = jax.jit(lambda s, r: j_stream.stream_sort(s, [r], M))(seg, ri.reshape(-1))
    rays = tuple(np.asarray(r) for r in j_stream.rays_from_perm(j_order, SMALL))
    j_xyz = [np.asarray(j_ri_s) * r for r in rays]

    ref = np.asarray(j_modeling.plane_models_stream(j_ri_s, j_order, k_model, M, CFG.plane_angle_threshold, rays))
    ref_hyp = np.asarray(j_modeling._select_hypotheses(*j_xyz, j_order, k_model, M))
    ref_planes = _reference_hypotheses(*j_xyz, j_order, k_model)
    # The reference's winner, found exactly among its own candidates.
    gap = np.abs(ref_planes - ref_hyp[:, None]).max(-1)
    assert (gap.min(-1) == 0).all()

    order, (ri_s,) = stream.stream_sort(T(seg), [T(ri.reshape(-1))], M)
    t_key = prng.split(prng.prng_key(seed, "cpu"))[1]
    got = modeling.plane_models_stream(ri_s, order, t_key, M, CFG.plane_angle_threshold, tuple(T(r) for r in rays))
    return dict(k_model=k_model, t_key=t_key, order=order, j_order=j_order, ri_s=ri_s, rays=rays,
                ref=ref, ref_planes=ref_planes, ref_best=gap.argmin(-1), got=got)


def test_hypothesis_draws_bit_equal(fit):
    ref = np.asarray(jax.random.uniform(fit["k_model"], (M, N_DRAW)))
    np.testing.assert_array_equal(prng.uniform(fit["t_key"], (M, N_DRAW)).numpy(), ref)


def test_winning_hypothesis_index_is_the_same(fit):
    planes = fit["got"].hypotheses.planes.numpy()  # (M, ITERS, 4)
    ref = fit["ref_planes"]
    # A plane and its negation are the same plane.
    diff = np.minimum(np.abs(planes - ref), np.abs(planes + ref)).max(-1)
    agree = (diff <= 1e-3).all(-1) & (fit["order"].counts.numpy() > 0)
    assert agree.sum() >= 8
    np.testing.assert_array_equal(fit["got"].hypotheses.best.numpy()[agree], fit["ref_best"][agree])


def test_plane_or_point_decision_is_the_same(fit):
    ref_plane = (fit["ref"][:, :3] != 0).any(1)
    np.testing.assert_array_equal(fit["got"].use_plane.numpy(), ref_plane)
    assert ref_plane.any() and not ref_plane[:2].any()


def test_planes_agree(fit):
    got, ref = fit["got"].table.numpy(), fit["ref"]
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=0, atol=1e-4)


def test_per_cluster_sums_multi_bit_equal(fit):
    """The stacked sums follow XLA's cumsum order, so they are bit-equal."""
    vals = np.random.default_rng(0).uniform(-30, 30, (4, fit["ri_s"].shape[0])).astype(np.float32)
    ref = np.asarray(jax.jit(j_modeling.per_cluster_sums_multi)(vals, fit["j_order"]))
    np.testing.assert_array_equal(stream.per_cluster_sums_multi(T(vals), fit["order"]).numpy(), ref)


def test_expand_per_cluster_bit_equal(fit):
    vals = np.random.default_rng(1).normal(0, 40, (3, M)).astype(np.float32)
    hw = fit["ri_s"].shape[0]
    ref = np.asarray(jax.jit(lambda v, o: j_stream.expand_per_cluster_multi(v, o, hw))(vals, fit["j_order"]))
    np.testing.assert_array_equal(stream.expand_per_cluster_multi(T(vals), fit["order"]).numpy(), ref)
    ref1 = np.asarray(jax.jit(lambda v, o: j_stream.expand_per_cluster(v, o, hw))(vals[0], fit["j_order"]))
    np.testing.assert_array_equal(stream.expand_per_cluster(T(vals[0]), fit["order"]).numpy(), ref1)
