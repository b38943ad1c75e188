from ftrl_ffm_tpu_torch.data.loader import ArrayDataset, batch_iterator, load_file
from ftrl_ffm_tpu_torch.data.parser import parse_lines, parse_text

__all__ = [
    "parse_text",
    "parse_lines",
    "ArrayDataset",
    "load_file",
    "batch_iterator",
]
