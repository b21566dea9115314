"""Non-uniform mode's key points and salience levels: the port against
``rpcc_tpu/ops/features.py`` on the same range image and seg map (CPU).

Key-point labels and salience levels are integers and are element-identical.
The curvature map is compared within rtol 1e-3, atol 1e-5: its prefix
sums are bit-equal (``fixed_order_cumsum`` follows XLA's scan order), but
jitted XLA on the CPU contracts ``win - 7 * v`` into an FMA and turns the
division by 2r into a multiply by its reciprocal, and the port does
neither; ``win - 7 * v`` cancels to a few centimetres.
"""

import jax
import numpy as np
import pytest
import torch

from rpcc_tpu.config import CodecConfig
from rpcc_tpu.ops import features as j_features
from rpcc_tpu.ops import segment as j_segment
from rpcc_tpu.ops.projection import build_transform_planes, project_points_host_u16
from rpcc_tpu_torch.ops import features
from tests.test_features import make_scene
from tests.test_roundtrip import SMALL, synth_scene

torch.set_num_threads(1)

CFG = CodecConfig(compress_framework="non-uniform", cluster_num=16)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _small_frame(seed):
    """A SMALL (16x256) frame and its reference FPS segmentation."""
    q, d = project_points_host_u16(synth_scene(seed=seed), SMALL, np.float32(CFG.step / 16.0))
    ri = q.astype(np.float32) * d
    tm = build_transform_planes(SMALL)
    key = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))[0]
    seg, _, _ = jax.jit(
        lambda p, r, t, k: j_segment.segment_range_image(p, r, t, k, CFG.ground_threshold, CFG.cluster_num)
    )(ri[None] * tm, ri, tm, key)
    return ri, np.asarray(seg)


FRAMES = {f"small{s}": (lambda s=s: _small_frame(s)) for s in (0, 3, 9)}
FRAMES.update({f"scene{s}": (lambda s=s: make_scene(s)) for s in (0, 1, 2)})


@pytest.mark.parametrize("name", list(FRAMES))
def test_key_points_match_reference(name):
    ri, seg = FRAMES[name]()
    ref_feat, ref_kp = jax.jit(j_features.extract_features_with_segment)(ri, seg)
    feat, kp = features.extract_features_with_segment(T(ri), T(seg))
    assert kp.dtype == torch.int32
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ref_kp))
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), rtol=1e-3, atol=1e-5)
    assert (kp.numpy() > 0).sum() > 20  # the frame does produce key points
    _, kp_only = features.extract_features_with_segment(T(ri), T(seg), want_feature_map=False)
    assert torch.equal(kp_only, kp)


@pytest.mark.parametrize("knobs", [dict(feature_region=2, segments=4), dict(sharp_num=2, less_sharp_num=5, flat_num=3)])
def test_key_points_other_knobs(knobs):
    ri, seg = make_scene(5, h=12, w=200)
    ref = jax.jit(lambda r, s: j_features.extract_features_with_segment(r, s, want_feature_map=False, **knobs)[1])(ri, seg)
    _, kp = features.extract_features_with_segment(T(ri), T(seg), want_feature_map=False, **knobs)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["small0", "small9"])
def test_salience_levels_match_reference(name):
    """Per-cluster levels from the key-point counts of each cluster."""
    ri, seg = FRAMES[name]()
    kp = np.asarray(j_features.extract_features_with_segment(ri, seg, want_feature_map=False)[1])
    M = CFG.cluster_num + 2
    kp_cnt = np.bincount(seg.reshape(-1), weights=(kp.reshape(-1) > 0), minlength=M).astype(np.int32)
    counts = np.bincount(seg.reshape(-1), minlength=M).astype(np.int32)
    kw = dict(level_kp_num=CFG.level_key_point_num, ground_level=CFG.ground_salience_level)
    ref = np.asarray(j_features.salience_levels_from_counts(kp_cnt, counts, **kw))
    got = features.salience_levels_from_counts(T(kp_cnt), T(counts), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(got[2:].tolist())) > 1  # more than one level in use


def test_salience_levels_edge_cases():
    kp_cnt = np.asarray([50, 0, 40, 5, 0, 40, 3, 10], np.int32)
    counts = np.asarray([900, 50, 400, 100, 100, 20, 30, 29], np.int32)
    kw = dict(level_kp_num=(30, 10, 3, 0), ground_level=2)
    ref = np.asarray(j_features.salience_levels_from_counts(kp_cnt, counts, **kw))
    got = features.salience_levels_from_counts(T(kp_cnt), T(counts), **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [2, 3, 0, 2, 3, 3, 2, 3])
