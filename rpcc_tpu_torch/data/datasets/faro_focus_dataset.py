"""Faro Focus MEMS dataset (reference ``dataset/datasets/faro_focus_dataset.py``)."""

from rpcc_tpu_torch.data.dataset import DatasetTemplate


class FaroFocusDataset(DatasetTemplate):
    pass
