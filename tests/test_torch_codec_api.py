"""The port's codec API surface against ``rpcc_tpu`` on the CPU, all exact:
``codec/api.py`` (the compressed fields byte for byte for every basic
compressor, with and without salience; the decoded seg map and fields),
``codec/contour2d.py``, the ``ops/quantize.py`` spec and
``ops/segment.py::segment_index_clean``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpcc_tpu.codec import api as ref_api
from rpcc_tpu.codec import contour2d as ref_contour2d
from rpcc_tpu.codec.entropy import BasicCompressor as RefCompressor
from rpcc_tpu.ops import quantize as ref_quantize
from rpcc_tpu.ops.segment import segment_index_clean as ref_segment_index_clean
from rpcc_tpu_torch.codec import api, contour2d
from rpcc_tpu_torch.codec.entropy import METHODS, BasicCompressor
from rpcc_tpu_torch.ops import quantize
from rpcc_tpu_torch.ops.segment import segment_index_clean

torch.set_num_threads(1)

H, W = 16, 128


def _fields(seed, salience):
    """A seg map of runs (ids 0..40), its model table, a residual stream
    and, with ``salience``, one level per model."""
    rng = np.random.default_rng(seed)
    seg = np.repeat(rng.integers(0, 41, (H, W // 8)), 8, axis=1).astype(np.int32)
    seg[rng.random((H, W)) < 0.05] = 1
    return dict(
        plane_param=rng.normal(0, 3, (43, 4)).astype(np.float32),
        cluster_idx=seg,
        salience_level=rng.integers(0, 4, 43).astype(np.uint8) if salience else None,
        nonzero_residual_quantized=np.cumsum(rng.integers(-3, 4, int((seg != 1).sum()))).astype(np.int16),
    )


@pytest.mark.parametrize("salience", [False, True], ids=["uniform", "salience"])
@pytest.mark.parametrize("method", METHODS)
def test_compress_and_decompress_equal_reference(method, salience):
    f = _fields(0, salience)
    mine = BasicCompressor(method_name=method, contour_shape=(H, W))
    ref = RefCompressor(method_name=method, contour_shape=(H, W))
    original, compressed = api.compress_point_cloud(mine, device="cpu", **f)
    ref_original, ref_compressed = ref_api.compress_point_cloud(ref, **f)
    assert list(original) == list(ref_original) and list(compressed) == list(ref_compressed)
    for k in ref_original:
        assert original[k].dtype == ref_original[k].dtype, k
        np.testing.assert_array_equal(original[k], ref_original[k])
        assert compressed[k] == ref_compressed[k], k
    got = api.decompress_point_cloud(compressed, mine, 43, H, W, device="cpu")
    want = ref_api.decompress_point_cloud(ref_compressed, ref, 43, H, W)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], f["cluster_idx"])


def test_full_mode_and_bitstream_files(tmp_path):
    f = _fields(1, True)
    extra = dict(ground_residual_quantized=np.arange(7, dtype=np.int32),
                 cluster_residual_quantized=np.arange(5, dtype=np.int32),
                 point_cloud=np.ones((H, W, 3)), range_image=np.ones((H, W)), full=True)
    mine = BasicCompressor(method_name="rans", contour_shape=(H, W))
    original, compressed = api.compress_point_cloud(mine, device="cpu", **f, **extra)
    _, ref_compressed = ref_api.compress_point_cloud(RefCompressor(method_name="rans", contour_shape=(H, W)),
                                                     **f, **extra)
    assert {"point_cloud", "range_image", "ground_residual", "cluster_residual"} <= set(original)
    assert compressed == ref_compressed
    api.save_compressed_bitstream(str(tmp_path / "a.rpcc"), compressed, uniform=False)
    ref_api.save_compressed_bitstream(str(tmp_path / "b.rpcc"), ref_compressed, uniform=False)
    assert (tmp_path / "a.rpcc").read_bytes() == (tmp_path / "b.rpcc").read_bytes()
    back = api.read_compressed_bitstream(str(tmp_path / "b.rpcc"), uniform=False)
    assert back == {k: v for k, v in compressed.items() if k in back} and "salience_level" in back


def test_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    f = _fields(2, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress_point_cloud(BasicCompressor(method_name="lz4"), **f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress_point_cloud({}, BasicCompressor(method_name="lz4"), 43, H, W)


# --------------------------------------------------------------- contour2d
CONTOUR_CASES = {
    # tests/test_codec_extras.py:14
    "extras": np.array(
        [[1, 1, 1, 1, 2, 1, 3, 4, 4],
         [3, 2, 2, 1, 2, 1, 1, 3, 4],
         [3, 2, 1, 1, 2, 4, 4, 3, 4],
         [3, 3, 2, 2, 2, 1, 4, 4, 4]], dtype=np.int32),
    # tests/test_data_io.py:205
    "sorted": np.array(
        [[1, 1, 2, 2, 3, 3, 3, 1, 1],
         [1, 1, 2, 2, 2, 3, 3, 1, 1],
         [4, 4, 4, 2, 2, 3, 1, 1, 1],
         [4, 4, 4, 4, 2, 2, 1, 1, 5]], dtype=np.int32),
    "random": np.random.default_rng(3).integers(0, 4, (12, 30)).astype(np.int32),
}


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CONTOUR_CASES))
def test_contour2d_functions_equal_reference(case):
    idx = CONTOUR_CASES[case]
    cm, seq = contour2d.extract_contour_double_direction(idx)
    _equal((cm, seq), ref_contour2d.extract_contour_double_direction(idx))
    _equal(contour2d.recover_map_double_direction(cm, seq), ref_contour2d.recover_map_double_direction(cm, seq))
    np.testing.assert_array_equal(contour2d.recover_map_double_direction(cm, seq), idx)
    _equal(contour2d.flood_fill_encode(cm, idx), ref_contour2d.flood_fill_encode(cm, idx))
    _equal(contour2d.sorted_index_encoder(cm, idx), ref_contour2d.sorted_index_encoder(cm, idx))
    for single_line in (True, False):
        packed, s = contour2d.compress_plane_idx_map(idx, single_line=single_line, device="cpu")
        ref_packed, ref_s = ref_contour2d.compress_plane_idx_map(idx, single_line=single_line)
        _equal(packed, ref_packed)
        np.testing.assert_array_equal(s, ref_s)


# ---------------------------------------------------------------- quantize
@pytest.mark.parametrize("step", [0.04, "per-pixel"])
def test_quantize_spec_equals_reference(step):
    """tests/test_ops.py::test_cluster_sort_and_stream_roundtrip's inputs,
    and a per-pixel step as non-uniform mode gathers it."""
    rng = np.random.default_rng(5)
    hw, num_models = 4096, 12
    seg = rng.integers(0, num_models, hw).astype(np.int32)
    resid = rng.normal(0, 0.5, hw).astype(np.float32)
    if step == "per-pixel":
        step = np.float32([0.04, 0.06, 0.08, 0.1])[rng.integers(0, 4, hw)]
    order = quantize.cluster_sort(torch.from_numpy(seg), num_models)
    ref_order = ref_quantize.cluster_sort(jnp.asarray(seg), num_models)
    for a, b in zip(order, ref_order):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    step_t = step if isinstance(step, float) else torch.from_numpy(step)
    stream = quantize.quantize_stream(torch.from_numpy(resid), order, step_t)
    ref_stream = ref_quantize.quantize_stream(jnp.asarray(resid), ref_order, step)
    assert stream.dtype == torch.int32
    np.testing.assert_array_equal(stream.numpy(), np.asarray(ref_stream))
    deq = quantize.dequantize_stream(stream, order, step_t)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(ref_quantize.dequantize_stream(ref_stream, ref_order, step)))
    assert (deq.numpy()[seg == 1] == 0).all()


def test_cluster_sort_ignores_ids_outside_the_table():
    seg = np.array([0, 5, 1, 2, 7, 2, 1, -1], np.int32)
    order = quantize.cluster_sort(torch.from_numpy(seg), 4)
    ref_order = ref_quantize.cluster_sort(jnp.asarray(seg), 4)
    for a, b in zip(order, ref_order):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ segment_index_clean
def _inplace_cascade(seg):
    """tests/test_ops.py:178: the in-place C++ loop (cpp_modules.cpp:232-243)."""
    ref = seg.copy()
    for r in range(ref.shape[0]):
        for c in range(ref.shape[1] - 2):
            cur, nxt, nxt2 = ref[r, c], ref[r, c + 1], ref[r, c + 2]
            if nxt2 == cur and nxt != cur:
                ref[r, c + 1] = cur
    return ref


@pytest.mark.parametrize("shape, ids", [((6, 40), 5), ((16, 256), 3), ((3, 2), 2), ((4, 3), 2)])
def test_segment_index_clean_equals_reference_and_cascade(shape, ids):
    seg = np.random.default_rng(9).integers(0, ids, shape).astype(np.int32)
    mine = segment_index_clean(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(mine, _inplace_cascade(seg))
    np.testing.assert_array_equal(mine, np.asarray(ref_segment_index_clean(jnp.asarray(seg))))


def test_segment_index_clean_batch_equals_frames():
    seg = np.random.default_rng(10).integers(0, 3, (3, 8, 50)).astype(np.int32)
    out = segment_index_clean(torch.from_numpy(seg)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(out[b], _inplace_cascade(seg[b]))
