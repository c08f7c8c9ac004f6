"""Host-side data (copies of ``repro.data``, numpy only) and ``to_device``."""
from repro_torch.data.pipeline import TokenDataset, batches, make_lm_batch, to_device
from repro_torch.data.synthetic import MixtureTask, sequence_task

__all__ = ["TokenDataset", "batches", "make_lm_batch", "to_device", "MixtureTask", "sequence_task"]
