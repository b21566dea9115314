"""Byte-level entropy coders for the ``.rpcc`` fields.

``rans`` goes to this package's JAX-free copy of the container code
(:mod:`rpcc_tpu_torch.codec.rans_codec`); ``lz4``/``bzip2``/``gzip``/
``deflate`` are ``rpcc_tpu.codec.entropy``'s own coders, which need no jax.

The ``*_dict_batch`` methods code a batch of frames' fields with the big
fields (residual stream, contour plane) batched through the native coder;
each frame's bytes equal :meth:`compress_dict` / :meth:`decompress_dict`
of that frame alone.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from rpcc_tpu.codec import entropy as _ref
from rpcc_tpu_torch.codec import rans_codec


class BasicCompressor(_ref.BasicCompressor):
    """``rpcc_tpu``'s BasicCompressor with ``rans`` routed to the port."""

    def compress_dict(self, data_dict: Dict[str, object]) -> Dict[str, bytes]:
        if self.method_name != "rans":
            return super().compress_dict(data_dict)
        out = {}
        for k, v in data_dict.items():
            if k == "contour_map" and self.contour_shape is not None:
                out[k] = rans_codec.compress_contour(v, *self.contour_shape)
            else:
                out[k] = rans_codec.compress(v)
        return out

    def compress_dict_batch(
        self, dicts: Sequence[Dict[str, object]], pool_map: Optional[Callable] = None
    ) -> List[Dict[str, bytes]]:
        """:meth:`compress_dict` of each frame's fields, byte for byte.
        ``pool_map(fn, n)`` (default: in order on this thread) runs the
        per-frame remainder, e.g. on a thread pool."""
        pool_map = pool_map or (lambda fn, n: [fn(i) for i in range(n)])
        if self.method_name != "rans" or not dicts:
            return pool_map(lambda i: self.compress_dict(dicts[i]), len(dicts))
        big = {"residual_quantized": rans_codec.compress_batch([d["residual_quantized"] for d in dicts])}
        if self.contour_shape is not None:
            big["contour_map"] = rans_codec.compress_contour_batch(
                [d["contour_map"] for d in dicts], *self.contour_shape
            )
        return pool_map(
            lambda i: {k: big[k][i] if k in big else rans_codec.compress(v) for k, v in dicts[i].items()},
            len(dicts),
        )

    def decompress_dict_batch(
        self, dicts: Sequence[Dict[str, bytes]], pool_map: Optional[Callable] = None
    ) -> List[Dict[str, bytes]]:
        """:meth:`decompress_dict` of each frame's fields, the big rans
        fields of the whole batch decoded in one native call each."""
        pool_map = pool_map or (lambda fn, n: [fn(i) for i in range(n)])
        if self.method_name != "rans" or not dicts:
            return pool_map(lambda i: self.decompress_dict(dicts[i]), len(dicts))
        resid, contour = rans_codec.batch_decode_big_fields(dicts)
        big = {k: v for k, v in (("residual_quantized", resid), ("contour_map", contour)) if v is not None}
        return pool_map(
            lambda i: {k: big[k][i] if k in big else self.decompress(v) for k, v in dicts[i].items()},
            len(dicts),
        )

    def compress(self, np_array) -> bytes:
        if self.method_name == "rans":
            return rans_codec.compress(np_array)
        return super().compress(np_array)

    def decompress(self, bitstream: bytes) -> bytes:
        if self.method_name == "rans":
            return rans_codec.decompress(bitstream)
        return super().decompress(bitstream)
